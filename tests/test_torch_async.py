"""The port's asynchronous mapper (runSequential=False) on the CPU, with the
gates of tests/test_slam_e2e.py::TestAsyncMapping at a CPU size:

- over oracle frames, the JAX package runs the sequence once sequentially
  and three times with its worker, and two async trials of the port each
  track >= 85% of the frames after the init and lose no more frames after
  their init than a JAX async run did, at an ATE under 1.5x JAX's
  sequential run's + 0.01, and once the worker has drained map keyframes
  within one of the JAX async runs' range and points per keyframe within
  20% of theirs (how many keyframes a worker maps depends on its pace
  beside the tracker, in either package);
- an exception in a worker step, and one planted as the reference's test
  plants it, is raised by `wait_for_finished` (`waitForFinished`), not
  swallowed;
- after `wait_for_finished` the worker is idle and the map grew past the
  two init keyframes (>= 3 keyframes, > 100 points); `globalOptimization`
  drains the worker before it runs;
- sequential mode never starts a worker nor takes a map snapshot, and two
  runs give one signature;
- `Map.snapshot` sees the state it was taken from, with arenas rebuilt from
  that state's liveness masks; the live map's host mirror never caches one
  state's values under another;
- `FrameExtractor.prefetch` leaves the extracted frame unchanged.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_slam_e2e import PARAMS as REF_PARAMS
from ucoslam_tpu_torch import api
from ucoslam_tpu_torch.api import UcoSlam
from ucoslam_tpu_torch.config import Params
from ucoslam_tpu_torch.features.frame_extractor import FrameExtractor
from ucoslam_tpu_torch.geometry.horn import ate_rmse
from ucoslam_tpu_torch.io.synthetic import SyntheticSequence
from ucoslam_tpu_torch.mapping import map as map_mod
from ucoslam_tpu_torch.slam.system import System

torch.set_num_threads(2)

#: the reference test's parameters, with a 2048-point arena (the 1200-point
#: scene fits it) to halve the plain B1's work on the CPU
PARAMS = Params.from_dict(REF_PARAMS.to_dict()).replace(maxMapPoints=2048)


def run_sequence(seq, params=PARAMS, n=None):
    sys_ = System(params, seq.cam, device="cpu")
    poses = {}
    for i in range(seq.n_frames if n is None else n):
        pose = sys_.process_frame(seq.frame(i, device="cpu"))
        if pose is not None:
            poses[i] = pose
    return sys_, poses


def ate(poses, seq):
    idx = sorted(poses)
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    return float(ate_rmse(est, seq.gt_positions()[idx], with_scale=True))


def jax_runs(n_frames: int, seed: int, trials: int) -> dict:
    """The JAX package over the same oracle frames: sequential once, then
    async `trials` times, each drained. -> {"sequential": run, "async":
    [run, ...]}, a run being (init frame, tracked, ATE, keyframes, points)."""
    from tests.test_slam_e2e import centers_of
    from tests.test_slam_e2e import run_sequence as ref_run_sequence
    from ucoslam_tpu.geometry.horn import ate_rmse as ref_ate_rmse
    from ucoslam_tpu.io.synthetic import SyntheticSequence as RefSequence

    seq = RefSequence(n_frames=n_frames, seed=seed)
    params = REF_PARAMS.replace(maxMapPoints=PARAMS.maxMapPoints)

    def one(p):
        sys_, poses = ref_run_sequence(seq, params=p)
        sys_.wait_for_finished()
        idx, est = centers_of(poses)
        run = (min(poses), len(poses), float(ref_ate_rmse(est, seq.gt_positions()[idx], with_scale=True)),
               sys_.map.n_keyframes, sys_.map.n_points)
        sys_.shutdown()
        return run

    return {"sequential": one(params), "async": [one(params.replace(runSequential=False)) for _ in range(trials)]}


def test_async_tracks_whole_sequence():
    seq = SyntheticSequence(n_frames=40, seed=3)
    ref = jax_runs(seq.n_frames, 3, trials=3)
    bound = 1.5 * ref["sequential"][2] + 0.01
    lost = max(seq.n_frames - init - tracked for init, tracked, *_ in ref["async"])
    kf_lo, kf_hi = min(r[3] for r in ref["async"]) - 1, max(r[3] for r in ref["async"]) + 1
    ppk_lo, ppk_hi = (0.8 * min(r[4] / r[3] for r in ref["async"]), 1.2 * max(r[4] / r[3] for r in ref["async"]))
    params = PARAMS.replace(runSequential=False)
    for trial in range(2):
        sys_, poses = run_sequence(seq, params)
        assert sys_.manager.is_async
        sys_.wait_for_finished()
        what = f"trial {trial} (JAX: {ref})"
        assert len(poses) >= 0.85 * (seq.n_frames - 2), f"{what}: tracked {len(poses)}"
        assert seq.n_frames - min(poses) - len(poses) <= lost, f"{what}: lost {seq.n_frames - min(poses) - len(poses)}"
        assert ate(poses, seq) < bound, f"{what}: ATE {ate(poses, seq)} (bound {bound})"
        n_kf, n_pt = sys_.map.n_keyframes, sys_.map.n_points
        assert n_kf >= 3 and kf_lo <= n_kf <= kf_hi, f"{what}: {n_kf} keyframes"
        assert ppk_lo <= n_pt / n_kf <= ppk_hi, f"{what}: {n_pt} points on {n_kf} keyframes"
        sys_.map.check_consistency()
        sys_.shutdown()
        assert not sys_.manager.is_async


def test_async_worker_errors_surface(monkeypatch):
    params = PARAMS.replace(runSequential=False)
    seq = SyntheticSequence(n_frames=12, seed=4)
    sys_, _ = run_sequence(seq, params, n=6)
    sys_.manager._worker_error = RuntimeError("boom")  # as the reference's test plants it
    with pytest.raises(RuntimeError, match="boom"):
        sys_.wait_for_finished()
    sys_.wait_for_finished()  # raised once, then cleared

    def fail(*a, **k):
        raise ValueError("a worker step failed")

    monkeypatch.setattr(sys_.manager, "new_keyframe", fail)
    monkeypatch.setattr(sys_, "_need_keyframe", lambda res: True)
    for i in range(6, 12):
        sys_.process_frame(seq.frame(i, device="cpu"))
    with pytest.raises(ValueError, match="worker step failed"):
        sys_.wait_for_finished()
    sys_.shutdown()


def test_shutdown_waits_for_a_long_worker_step(monkeypatch):
    params = PARAMS.replace(runSequential=False)
    seq = SyntheticSequence(n_frames=12, seed=4)
    sys_, _ = run_sequence(seq, params, n=6)
    sys_.wait_for_finished()
    mgr, started = sys_.manager, threading.Event()

    def slow(*a, **k):  # a step that outlasts any short join, as a loop correction can
        started.set()
        time.sleep(2.0)
        raise ValueError("the slow step ended")

    monkeypatch.setattr(mgr, "new_keyframe", slow)
    thread, join = mgr._thread, mgr._thread.join
    # a join with a timeout gets 0.5 s of it: the 2 s step stands in for one past any such timeout
    monkeypatch.setattr(thread, "join", lambda timeout=None: join(None if timeout is None else min(timeout, 0.5)))
    assert mgr.enqueue_keyframe(SimpleNamespace(pose_f2g=torch.eye(4)))
    assert started.wait(30)
    sys_.shutdown()
    assert not thread.is_alive() and not mgr.is_async
    assert isinstance(mgr._worker_error, ValueError)  # the step ran to its end before the stop


def test_keyframe_waits_for_an_idle_worker(monkeypatch):
    """A frame that needs a keyframe while the worker still maps one waits
    for it, then hands over its own frame: no candidate is ever queued
    behind another, none is dropped, and frames that need none track on."""
    params = PARAMS.replace(runSequential=False)
    seq = SyntheticSequence(n_frames=10, seed=4)
    sys_, _ = run_sequence(seq, params, n=4)
    sys_.wait_for_finished()
    mgr = sys_.manager
    inner, enqueue = mgr.new_keyframe, mgr.enqueue_keyframe
    pending_at_enqueue, mapped = [], []

    def slow(world_map, frame, **host):  # a mapping that outlasts several frames
        time.sleep(0.3)
        mapped.append(int(frame.fseq))
        return inner(world_map, frame, **host)

    def record(frame, **host):
        pending_at_enqueue.append(mgr._pending_kf)
        return enqueue(frame, **host)

    monkeypatch.setattr(mgr, "new_keyframe", slow)
    monkeypatch.setattr(mgr, "enqueue_keyframe", record)
    want = [5, 6, 8]  # frames that ask for a keyframe
    monkeypatch.setattr(sys_, "_need_keyframe", lambda res: int(res.frame.fseq) in want)
    for i in range(4, seq.n_frames):
        sys_.process_frame(seq.frame(i, device="cpu"))
    sys_.wait_for_finished()
    assert pending_at_enqueue == [0] * len(want)
    assert mapped == want
    assert not mgr.busy() and mgr._pending_kf == 0
    sys_.shutdown()


def test_wait_for_finished_drains_queue(monkeypatch):
    params = PARAMS.replace(runSequential=False)
    seq = SyntheticSequence(n_frames=20, seed=5)
    slam = UcoSlam(device="cpu")
    slam.setParams(None, params.replace(detectMarkers=False), seq.cam)
    for i in range(seq.n_frames):
        slam.process_frame(seq.frame(i, device="cpu"))
    order, wait, inner = [], slam._system.manager.wait_idle, api.global_bundle_adjustment
    monkeypatch.setattr(slam._system.manager, "wait_idle", lambda: order.append("drain") or wait())
    monkeypatch.setattr(api, "global_bundle_adjustment", lambda *a, **k: order.append("ba") or inner(*a, **k))
    slam.globalOptimization(n_iters=3)
    assert order == ["drain", "ba"]
    slam.waitForFinished()
    assert not slam._system.manager.busy()
    assert slam.map.n_keyframes >= 3
    assert slam.map.n_points > 100
    slam.clear()


def test_sequential_mode_takes_no_snapshot(monkeypatch):
    monkeypatch.setattr(map_mod.Map, "snapshot", lambda self: pytest.fail("sequential mode took a snapshot"))
    seq = SyntheticSequence(n_frames=10, seed=1)
    a, poses_a = run_sequence(seq)
    b, poses_b = run_sequence(seq)
    assert not a.manager.is_async and a.map.n_keyframes >= 3
    assert a.global_signature() == b.global_signature()
    assert sorted(poses_a) == sorted(poses_b)


def test_snapshot_and_host_mirror():
    seq = SyntheticSequence(n_frames=8, seed=1)
    sys_, _ = run_sequence(seq)
    live = sys_.map
    view = live.snapshot()
    assert view.state is live.state
    assert (view.keyframes.active == live.keyframes.active).all()
    assert (view.points.active == live.points.active).all()
    kf_pose = view.h("kf_pose").copy()
    # the writer moves an arena, then writes a new state: the view keeps its own
    slot = live.keyframes.alloc()
    assert not view.keyframes.active[slot]
    live.keyframes.free([slot])
    live.scale(2.0)
    assert view.state is not live.state
    np.testing.assert_array_equal(view.h("kf_pose"), kf_pose)
    np.testing.assert_allclose(live.h("kf_pose")[:, :3, 3], 2.0 * kf_pose[:, :3, 3], rtol=1e-6)
    # a fetch that straddles a state write lands in that state's mirror only
    st, cache = live._snap
    live.scale(0.5)
    cache["kf_pose"] = np.zeros(1)
    assert live.h("kf_pose").shape == kf_pose.shape


def test_prefetch_leaves_the_frame_unchanged():
    seq = SyntheticSequence(n_frames=4, seed=1)
    img = seq.render(1)
    ext = FrameExtractor(PARAMS.replace(detectMarkers=False), seq.cam, "cpu")
    plain = ext.process(img, 1)
    ext.prefetch(img)
    assert ext._prefetched is not None
    pre = ext.process(img, 1)
    assert ext._prefetched is None
    for name in ("xy", "octave", "desc", "valid"):
        assert torch.equal(getattr(plain, name), getattr(pre, name)), name
    ext.prefetch(seq.render(2))  # a prefetch of another image is not taken
    ext.process(img, 1)
    assert ext._prefetched is not None
