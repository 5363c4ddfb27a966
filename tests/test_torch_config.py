"""The port's own config (`ucoslam_tpu_torch.config`) against the reference's.

The port keeps a copy of `ucoslam_tpu.config` so that it imports nothing of
the JAX package; these tests hold the copy to the original: the same fields
in the same order with the same defaults, the same signatures (map files
carry them), the same YML files and the same constants.
"""

import dataclasses
import json
import os
import zipfile

import pytest

from ucoslam_tpu import config as ref
from ucoslam_tpu_torch import config as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_PATH = os.path.join(REPO, "data", "torch_port", "mono_map.slm")


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_fields_order_and_defaults_equal():
    assert _fields(port.Params) == _fields(ref.Params)
    assert port.Params().to_dict() == ref.Params().to_dict()


@pytest.mark.parametrize("kw", [
    {},
    dict(detectMarkers=False, maxDescDistance=60.0, maxKeyPointsPerFrame=512),
    dict(kpDescriptorType=3, extraParams="KFCulling=0.5", aruco_Dictionary="X9"),
])
def test_signature_equal(kw):
    kw_ref = dict(kw, **({"kpDescriptorType": ref.DescriptorType(kw["kpDescriptorType"])}
                         if "kpDescriptorType" in kw else {}))
    kw_port = dict(kw, **({"kpDescriptorType": port.DescriptorType(kw["kpDescriptorType"])}
                          if "kpDescriptorType" in kw else {}))
    a, b = ref.Params().replace(**kw_ref), port.Params().replace(**kw_port)
    assert a.to_dict() == b.to_dict()
    assert a.signature() == b.signature()


def test_committed_map_params_signature():
    with zipfile.ZipFile(MAP_PATH) as z:
        meta = json.loads(z.read("meta.json"))
    a, b = ref.Params.from_dict(meta["params"]), port.Params.from_dict(meta["params"])
    assert b.to_dict() == a.to_dict()
    assert b.signature() == a.signature()
    # the carry-across the tests use: reference Params -> port Params
    assert port.Params.from_dict(a.to_dict()) == b


@pytest.mark.parametrize("sequential", [True, False])
def test_set_params_and_effective(sequential):
    for desc in (1, 3, 5):
        a = ref.Params().setParams(sequential, ref.DescriptorType(desc))
        b = port.Params().setParams(sequential, port.DescriptorType(desc))
        assert a.to_dict() == b.to_dict()
    extra = "KFCulling=0.5 maxNewPoints=123 detectMarkers=0 nope=1 bad"
    a = ref.Params().replace(extraParams=extra).effective()
    b = port.Params().replace(extraParams=extra).effective()
    assert a.to_dict() == b.to_dict() and a.signature() == b.signature()
    assert b.KFCulling == 0.5 and b.maxNewPoints == 123 and b.detectMarkers is False


def test_yml_round_trip_read_by_both(tmp_path):
    p = port.Params().replace(maxFeatures=1234, KFMinConfidence=0.7, aruco_Dictionary="X9")
    path_port = str(tmp_path / "port.yml")
    p.save_yml(path_port)
    assert port.Params.load_yml(path_port) == p
    assert ref.Params.load_yml(path_port).to_dict() == p.to_dict()
    path_ref = str(tmp_path / "ref.yml")
    ref.Params.from_dict(p.to_dict()).save_yml(path_ref)
    assert port.Params.load_yml(path_ref) == p
    with open(path_port) as f, open(path_ref) as g:
        assert f.read() == g.read()


def test_enums_and_constants_equal():
    for name in ("DescriptorType", "Mode", "TrackingState"):
        assert {m.name: int(m) for m in getattr(port, name)} == {
            m.name: int(m) for m in getattr(ref, name)
        }
    for name in ("CHI2_2D", "CHI2_3D", "CHI2_8D", "CHI2_1D"):
        assert getattr(port, name) == getattr(ref, name)
    for d in ref.DescriptorType:
        assert port.hamming_gate_for(port.DescriptorType(int(d))) == ref.hamming_gate_for(d)
