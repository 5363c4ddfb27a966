"""SURF monocular SLAM, the port against the reference, on the CPU: the
SURF half of test_torch_descriptor_slam.py (its docstring says how), in a
file of its own so that each half stays near a minute alone."""

import pytest

from tests.test_torch_descriptor_slam import family_runs
from tests.test_torch_descriptor_slam import test_pass1_held_to_reference as _pass1
from tests.test_torch_descriptor_slam import test_reference_reads_port_checkpoint as _reads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs("surf", tmp_path_factory)


def test_pass1_held_to_reference(runs):
    _pass1(runs)


def test_reference_reads_port_checkpoint(runs, monkeypatch):
    _reads(runs, monkeypatch)
