"""The relocalization's PnP on the card and on the CPU, from the same inputs.

Pass 2 (LOCALIZATION) on a saved map relocalizes its first frame: this
captures that frame's `pnp_ransac` inputs in the port on `--device` (the
candidates' matched points, pixels, variances, valid rows and the RANSAC
rows drawn), then scores each candidate's 256 DLT hypotheses before their
refinement, computed on the card and on the CPU, in float32 (the DLT of the
parent commit, `_dlt_pose_f32` below, which the reference's `_dlt_pose`
also is) and in float64 (the port's `optim/pnp.py::_dlt_pose`): the best
hypothesis's inliers and how many reach the verification's 15. Then
`pnp_ransac` itself on both devices, and the batched B2 refine (kernel
against its plain version) from the CPU's best hypotheses.

    python3 tools/port/pnp_probe.py --map MAP [--tree TREE]

Without `--tree`, the `loop` scenario's tree (3 frames) is written by the
port's writer. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def _dlt_pose_f32(X: torch.Tensor, uv_norm: torch.Tensor) -> torch.Tensor:
    """`optim/pnp.py::_dlt_pose` as it was in float32 (the reference's
    arithmetic): 6+ point DLT for [R|t] from world points X (..., S, 3) and
    normalized image coordinates (..., S, 2) -> poses (..., 4, 4)."""
    s = X.shape[-2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)  # (..., S, 4)
    zeros = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, zeros, -uv_norm[..., 0:1] * Xh], -1)  # (..., S, 12)
    row_v = torch.cat([zeros, Xh, -uv_norm[..., 1:2] * Xh], -1)
    A = torch.cat([row_u, row_v], -2)  # (..., 2S, 12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    # sign the null vector so that det(M) >= 0: the result no longer depends
    # on the sign eigh returns (optim/pnp.py's docstring)
    sign = torch.where(torch.linalg.det(p[..., :3]) < 0, -1.0, 1.0)
    p = p * sign[..., None, None]
    M = p[..., :3]
    U, S, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    R = U @ D @ Vt
    scale = S.sum(-1) / 3.0 * det  # signed mean singular value
    # a rank-deficient sample (rows drawn twice) may leave M ~ 0
    scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)
    t = p[..., 3] / scale[..., None]
    # most depths negative: flip (the DLT's sign ambiguity)
    q = X @ R.transpose(-1, -2) + t[..., None, :]
    flip = ((q[..., 2] < 0).sum(-1) > (s // 2))[..., None, None]
    R = torch.where(flip, -R, R)
    t = torch.where(flip[..., 0], -t, t)
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=X.dtype, device=X.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)



def main(argv=None) -> None:
    import chip_smoke
    from ucoslam_tpu_torch.api import UcoSlam
    from ucoslam_tpu_torch.config import CHI2_2D, Mode
    from ucoslam_tpu_torch.geometry.camera import CameraParams
    from ucoslam_tpu_torch.io.datasets import TumSequence
    from ucoslam_tpu_torch.matching import kfmatch
    from ucoslam_tpu_torch.ops.cuda import lm_kernel
    from ucoslam_tpu_torch.optim import pnp
    from ucoslam_tpu_torch.slam.system import disable_tf32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--map", required=True)
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pnp_probe: no CUDA device")
    disable_tf32()
    with tempfile.TemporaryDirectory() as d:
        tree = args.tree
        if tree is None:
            tree = os.path.join(d, "loop")
            chip_smoke.write_tree("loop", 3, tree)
        frame0 = TumSequence.open(tree).read_rgb(0)
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    slam = UcoSlam(device="cuda")
    slam.readFromFile(args.map, cam)
    slam.setMode(Mode.LOCALIZATION)
    slam.resetTracker()
    caught, inner = [], kfmatch.pnp_ransac

    def grab(*a, **k):
        caught.append([x.clone() if torch.is_tensor(x) else x for x in a])
        return inner(*a, **k)

    kfmatch.pnp_ransac = grab
    try:
        slam.process(frame0, fseq=0)
    finally:
        kfmatch.pnp_ransac = inner
    pts3d, uv, sigma2, valid, c, sample_idx = caught[0]
    print(f"candidates={pts3d.shape[0]} matches={valid.sum(-1).tolist()} hypotheses={sample_idx.shape[1]}")

    def scored(dev, dlt):
        """Each hypothesis's inliers before the refinement."""
        P3, UV, S2, V, SI = (x.to(dev) for x in (pts3d, uv, sigma2, valid, sample_idx))
        uvn = torch.stack([(UV[..., 0] - c.cx) / c.fx, (UV[..., 1] - c.cy) / c.fy], -1)
        flat = SI.long().reshape(SI.shape[0], -1)

        def take(x):
            g = torch.gather(x, -2, flat[..., None].expand(flat.shape + (x.shape[-1],)))
            return g.reshape(SI.shape + (x.shape[-1],))

        poses = dlt(take(P3), take(uvn)).float()
        fin = torch.isfinite(poses).flatten(-2).all(-1)
        poses = torch.where(fin[..., None, None], poses, torch.eye(4, device=dev))
        q = P3[..., None, :, :] @ poses[..., :3, :3].transpose(-1, -2) + poses[..., None, :3, 3]
        r = c.project(q) - UV[..., None, :, :]
        ok = V[..., None, :] & ((r * r).sum(-1) / S2[..., None, :].clamp(min=1e-9) < CHI2_2D) & (q[..., 2] > 0)
        return poses, torch.where(fin, ok.sum(-1), -1).cpu()

    runs = {(dev, name): scored(dev, dlt) for dev in ("cuda", "cpu")
            for name, dlt in (("float32", _dlt_pose_f32), ("float64", pnp._dlt_pose))}
    for ci in range(pts3d.shape[0]):
        cells = " ".join(f"{dev}/{name}: best {int(n[ci].max())}, >= 15 in {int((n[ci] >= 15).sum())}"
                         for (dev, name), (_, n) in runs.items())
        print(f"candidate {ci}: DLT hypotheses' inliers before the refine: {cells}")
    for dev in ("cuda", "cpu"):
        args_ = [x.to(dev) if torch.is_tensor(x) else x for x in (pts3d, uv, sigma2, valid, c, sample_idx)]
        print(f"pnp_ransac on {dev} (float64 DLT): inliers {pnp.pnp_ransac(*args_).n_inliers.tolist()}")
    poses, n = runs[("cpu", "float32")]
    best = poses[torch.arange(poses.shape[0]), n.argmax(-1)]
    P3, UV, S2, V = pts3d.cpu(), uv.cpu(), sigma2.cpu(), valid.cpu()
    q = P3 @ best[:, :3, :3].transpose(-1, -2) + best[:, None, :3, 3]
    r = c.project(q) - UV
    inl = V & ((r * r).sum(-1) / S2 < CHI2_2D) & (q[..., 2] > 0)
    a = (best.contiguous(), P3.contiguous(), UV.contiguous(), S2.contiguous(), inl.contiguous(), c.fx, c.fy, c.cx, c.cy)
    pk, mk = lm_kernel.motion_only_lm_fused_batched(*[x.cuda() if torch.is_tensor(x) else x for x in a], iters=10,
                                                    rounds=2)
    pp, mp = lm_kernel.motion_only_lm_plain_batched(*a, iters=10, rounds=2)
    print(f"batched B2 refine from the CPU's best float32 hypotheses: kernel inliers {mk.sum(-1).tolist()}, plain "
          f"{mp.sum(-1).tolist()}, pose max abs diff {float((pk.cpu() - pp).abs().max()):.3e}")
    print(card_name_and_limit())


def card_name_and_limit() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    main()
