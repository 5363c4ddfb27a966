"""The port's spawned worlds and its scaling app, on the CPU (gloo).

- two worlds of 2 ranks started one after the other give bit-equal sharded
  BA results (sequential mode stays deterministic at a fixed world size);
- a rank that raises fails its world, with the rank's traceback;
- worlds and bench_scaling run on cards unless the CPU is asked for: with
  no card they raise;
- apps/bench_scaling.py at worlds 1 and 2 prints the reference app's JSON
  keys, its collectives as counted, and its problem generator draws what
  chip_smoke's (bench.py's) does.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_torch_schur_pm as pm_tests
from tools.port import parallel_tasks
from ucoslam_tpu_torch.parallel.distributed import spawn, to_host
from ucoslam_tpu_torch.parallel.sharded_ba import shard_ba_problem

torch.set_num_threads(2)

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def test_equal_results_at_a_fixed_world_size():
    _, port = pm_tests.from_test_ba(n_kf=8, n_pt=200, depth_frac=0.3, outlier_frac=0.05)
    jobs = [("ba", (to_host(shard_ba_problem(port, 2)), CAM_ARGS, 8, 2, "dense"), {})]
    a, b = (spawn(parallel_tasks.batch, 2, jobs, device="cpu", threads=1, timeout=600) for _ in range(2))
    for k, v in a[0][0].items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, b[0][0][k]), k


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(parallel_tasks.fail_on, 2, 1, device="cpu", timeout=120)


def test_worlds_run_on_cards_unless_asked(capsys, monkeypatch):
    """Without a card, a world on the default device and bench_scaling's
    default run raise instead of moving to the CPU, and print no result."""
    from ucoslam_tpu_torch.apps import bench_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(parallel_tasks.fail_on, 2, 1, timeout=120)
    with pytest.raises(SystemExit) as e:
        bench_scaling.main(["--max-ranks", "2", "--points-per-device", "256", "--keyframes", "16"])
    assert e.value.code != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_bench_scaling_app(capsys):
    from ucoslam_tpu_torch.apps import bench_scaling

    a, b = bench_scaling.scale_problem(16, 256, 4), chip_smoke.ba_scale_problem(16, 256, 4)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert bench_scaling.main(["--max-ranks", "2", "--points-per-device", "256", "--keyframes", "16", "--iters", "2",
                               "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    rows = lines[2]["rows"]
    assert [r["devices"] for r in rows] == [1, 2] and lines[2]["metric"] == "ba_weak_scaling"
    assert set(rows[1]) >= {"devices", "points", "t_iter_ms", "weak_scaling_efficiency", "collectives"}
    assert rows[1]["collectives"]["all_reduce_calls"] == 1 + 2 * 2 + 1  # a stage, 2 a step, the outputs
    pm = lines[3]
    assert pm["metric"] == "sharded_pm_collectives" and pm["devices"] == 2 and pm["n_all_reduce_sites"] > 0
