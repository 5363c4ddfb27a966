"""The controls on the card: each cell's run with its control switched on
must come out not correct (`portbench/core/controls.py`; the readings
behind each limit are in PERF.md). Card only:

    python -m pytest portbench/tests/test_portbench_controls.py -m cuda -q   (about 4 minutes)

The fleet cells run at their own sizes with two streams and a short
window.
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.core import manifest  # noqa: E402

pytestmark = pytest.mark.cuda

#: cell -> (its control, streams, window s)
CONTROLS = {
    "mono_fleet_explore": ("tf32", 2, 20.0),
    "mono_fleet_localize": ("tf32", 2, 8.0),
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.cache_environment(ROOT)


def context(workload: str, control: str | None) -> run.Context:
    _, streams, seconds = CONTROLS[workload]
    ctx = run.context(manifest.cell(manifest.manifest(), workload), 2**31 + 99, seconds, False, control)
    ctx.traffic["streams"] = streams
    return ctx


@pytest.mark.parametrize("workload", sorted(CONTROLS))
def test_sound_run_is_correct_and_its_control_is_not(workload, card):
    sound = run.execute(context(workload, None))
    assert sound["failed"] == 0 and sound["correct"], sound["checks"]
    control = run.execute(context(workload, CONTROLS[workload][0]))
    assert not control["correct"], control["checks"]
