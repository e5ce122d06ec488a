"""Fixtures of the harness's tests: a small cell on the CPU, with the
captured epoch run eagerly, and the ``card`` marker for the tests that
need a CUDA device (they skip here).

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy

import pytest
import torch

from harness_util import CLUSTERED, SMALL, StubEpochGraph


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def small_spec(monkeypatch):
    """``spec.load`` at the small size, with the stub epoch graph."""
    from benchmark import spec
    from graphneuralnetwork_tpu_torch.train import scan_loop

    monkeypatch.setattr(scan_loop, "EpochGraph", StubEpochGraph)
    torch.set_num_threads(1)

    def load(workload: str, layout=None) -> dict:
        """``layout`` "hybrid" runs the cell on that layout over a
        clustered graph."""
        s = copy.deepcopy(spec.load(workload))
        s["mix"].update(SMALL)
        s["config"].update(epochs_per_call=4)
        if layout is not None:
            s["mix"].update(CLUSTERED)
            s["cell"]["layout"] = layout
        return s

    return load
