"""System configuration of the port: the one Params object, modes and states.

The port's own copy of `ucoslam_tpu/config.py` (the port imports nothing of
the JAX package). `Params` has the same fields, in the same order, with the
same defaults, so `Params.signature()` gives the same integer for the same
values and a map saved by the reference loads here with its signature intact
(`io/serialize.py`). Configuration crosses between the two packages as a
plain dict: `Params.from_dict(other.to_dict())`.

Mirrors the reference `ucoslam::Params` (src/ucoslamtypes.h:79-170, defaults
src/ucoslamtypes.cpp:24-52) as a frozen dataclass, with the fixed capacities
(arena sizes, iteration counts) that the fixed-shape tensors need.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from dataclasses import dataclass
from typing import Any


class DescriptorType(enum.IntEnum):
    """Keypoint descriptor types (reference src/ucoslamtypes.h:39-42)."""

    NONE = 0
    ORB = 1
    AKAZE = 2
    BRISK = 3
    FREAK = 4
    SURF = 5


class Mode(enum.IntEnum):
    """Working modes (reference src/ucoslamtypes.h:33)."""

    SLAM = 0
    LOCALIZATION = 1


class TrackingState(enum.IntEnum):
    """Tracking states (reference src/ucoslamtypes.h:31)."""

    TRACKING = 0
    LOST = 1


# Robust-estimation chi-square thresholds shared system-wide
# (reference: pnpsolver.cpp:179-186, globaloptimizer_g2o.cpp:230-272,
# framematcher.cpp:261 epipolar gate).
CHI2_2D = 5.991  # 95% quantile, 2 dof (mono reprojection)
CHI2_3D = 7.815  # 95% quantile, 3 dof (stereo reprojection)
CHI2_8D = 15.507  # 95% quantile, 8 dof (marker 4-corner edges)
CHI2_1D = 3.841  # 95% quantile, 1 dof (point-to-epipolar-line)


def hamming_gate_for(desc: "DescriptorType") -> float:
    """Per-descriptor matching gate on the unified 256-bit Hamming pipeline.

    The reference gates each family in its native metric (gridextractor.cpp
    :36-39: AKAZE 120/486 bits, BRISK 70/512, FREAK 70/512, SURF 0.125 L2;
    ORB 50/256 per Params::setParams). Every descriptor is packed to 256 bits,
    so the gates scale by bit count; SURF's L2 angle gate maps through the LSH
    identity E[hamming] = 256 * angle / pi, plus ~2.5 std.
    """
    return {
        DescriptorType.ORB: 50.0,
        DescriptorType.AKAZE: 63.0,  # 120 * 256/486
        DescriptorType.BRISK: 35.0,  # 70 * 256/512
        DescriptorType.FREAK: 35.0,
        DescriptorType.SURF: 18.0,  # ~10 bits at the 0.125 rad gate + 2.5 std
        DescriptorType.NONE: 50.0,
    }[desc]


@dataclass(frozen=True)
class Params:
    """All tunables of the SLAM system; field for field the reference
    package's `Params` (names, order, defaults)."""

    # ---- user-facing (reference src/ucoslamtypes.h:90-125) ----
    runSequential: bool = True
    detectMarkers: bool = True
    detectKeyPoints: bool = True
    kpDescriptorType: DescriptorType = DescriptorType.ORB
    KPNonMaximaSuppresion: bool = False
    KFMinConfidence: float = 0.6
    maxFeatures: int = 4000
    nOctaveLevels: int = 8
    scaleFactor: float = 1.2
    KFCulling: float = 0.8
    aruco_markerSize: float = 1.0
    maxNewPoints: int = 350
    reLocalizationWithKeyPoints: bool = True
    reLocalizationWithMarkers: bool = True
    inPlaneMarkers: bool = False
    forceInitializationFromMarkers: bool = False
    nthreads_feature_detector: int = 2  # kept for config parity; unused
    markersOptWeight: float = 0.5
    minMarkersForMaxWeight: int = 5
    kptImageScaleFactor: float = 1.0
    autoAdjustKpSensitivity: bool = False
    aruco_Dictionary: str = "ARUCO_MIP_36h12"
    aruco_DetectionMode: str = "DM_NORMAL"
    aruco_CornerRefimentMethod: str = "CORNER_SUBPIX"
    aruco_minMarkerSize: float = 0.0

    # ---- internal (reference src/ucoslamtypes.h:131-160) ----
    extraParams: str = ""
    # Hamming gate; the sentinel -1 derives the per-descriptor gate from
    # kpDescriptorType in __post_init__
    maxDescDistance: float = -1.0
    baseline_medianDepth_ratio_min: float = 0.01
    global_optimizer: str = "schur_lm"
    minNumProjPoints: int = 3
    projDistThr: int = 15
    maxVisibleFramesPerMarker: int = 10
    aruco_minNumFramesRequired: int = 3
    aruco_minerrratio_valid: float = 3.0
    aruco_allowOneFrameInitialization: bool = False
    targetFocus: float = -1.0
    thRefRatio: float = 0.9
    minBaseLine: float = 0.07
    removeKeyPointsIntoMarkers: bool = True

    # ---- fixed capacities (no reference counterpart) ----
    maxKeyPointsPerFrame: int = 2048  # padded keypoint slots per frame
    maxMapPoints: int = 16384  # map-point arena capacity
    maxKeyFrames: int = 256  # keyframe arena capacity
    maxMarkers: int = 64  # marker arena capacity
    maxLocalKeyFrames: int = 0  # local-BA covis window cap; 0 = full local covis set
    ransacIters: int = 256  # hypotheses for PnP/H/F RANSAC
    kfRotationDeg: float = 8.0  # rotation since the last KF that forces a keyframe (0 disables)
    reseedAfterLostFrames: int = 12  # lost SLAM frames before two-view re-seeding (0 disables)
    lmItersTracking: int = 10  # per-round LM iterations for motion-only BA
    lmRoundsTracking: int = 4  # outlier-reclassification rounds (ref pnpsolver)
    baIters: int = 100  # global BA LM iterations (ref ParamSet::nIters)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.maxDescDistance < 0:
            object.__setattr__(self, "maxDescDistance", hamming_gate_for(self.kpDescriptorType))

    def parse_extra(self) -> dict:
        """Parse `extraParams` (ucoslamtypes.h:133): whitespace-separated
        `key=value` overrides for any field. Unknown keys are ignored."""
        out: dict[str, Any] = {}
        fields = {f.name for f in dataclasses.fields(self)}
        for tok in self.extraParams.split():
            k, sep, v = tok.partition("=")
            if not sep or k not in fields or k == "extraParams":
                continue
            cur = getattr(self, k)
            try:
                if isinstance(cur, bool):
                    out[k] = bool(int(float(v)))
                elif isinstance(cur, int):
                    out[k] = int(float(v))
                elif isinstance(cur, float):
                    out[k] = float(v)
                else:
                    out[k] = v
            except ValueError:
                continue
        return out

    def effective(self) -> "Params":
        """Params with the extraParams overrides applied (the reference
        consumes extraParams inside System::setParams)."""
        over = self.parse_extra()
        return self.replace(**over) if over else self

    def setParams(self, sequential: bool, desc: DescriptorType = DescriptorType.ORB) -> "Params":
        """Counterpart of reference Params::setParams (ucoslamtypes.cpp:54-66)."""
        return dataclasses.replace(
            self,
            runSequential=sequential,
            kpDescriptorType=desc,
            nOctaveLevels=8,
            scaleFactor=1.2,
            maxDescDistance=hamming_gate_for(desc),
        )

    def replace(self, **kw: Any) -> "Params":
        # switching descriptor type re-derives the per-type gate unless the
        # caller pins maxDescDistance explicitly
        if (
            "kpDescriptorType" in kw
            and "maxDescDistance" not in kw
            and kw["kpDescriptorType"] != self.kpDescriptorType
        ):
            kw["maxDescDistance"] = -1.0
        return dataclasses.replace(self, **kw)

    # ---- serialization (reference toStream/fromStream and YML I/O,
    #      ucoslamtypes.cpp:67-175,277-344) ----
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kpDescriptorType"] = int(self.kpDescriptorType)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "kpDescriptorType" in kw:
            kw["kpDescriptorType"] = DescriptorType(kw["kpDescriptorType"])
        return cls(**kw)

    def save_yml(self, path: str) -> None:
        """Plain `key: value` lines under a YAML header; see load_yml."""
        with open(path, "w") as f:
            f.write("%YAML:1.0\n---\n")
            for k, v in self.to_dict().items():
                if isinstance(v, bool):
                    v = int(v)
                f.write(f"{k}: {json.dumps(v) if isinstance(v, str) else v}\n")

    @classmethod
    def load_yml(cls, path: str) -> "Params":
        """Tolerant per-field reader (reference attemtpRead, ucoslamtypes.h:164)."""
        base = dataclasses.asdict(cls())
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("%", "#", "---")) or ":" not in line:
                    continue
                k, _, v = line.partition(":")
                k, v = k.strip(), v.strip()
                if k not in base:
                    continue
                cur = base[k]
                if isinstance(cur, bool):
                    base[k] = bool(int(float(v)))
                elif isinstance(cur, int):
                    base[k] = int(float(v))
                elif isinstance(cur, float):
                    base[k] = float(v)
                else:
                    base[k] = json.loads(v) if v.startswith('"') else v
        return cls.from_dict(base)

    def signature(self) -> int:
        """Deterministic 64-bit signature over all fields: blake2b of the
        canonical JSON rendering (reference Params::getSignature,
        ucoslamtypes.cpp:185-212)."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(), "little")
