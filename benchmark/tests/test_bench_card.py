"""On the card: the control (the reference with TF32 on, the precision
below the configurations' float32) has to come out as not correct under
each cell's limits, at a size that a test run holds. The cells' own sizes
are read by ``benchmark/control.py``.

    python3 -m pytest benchmark/tests -m card -q
"""

from __future__ import annotations

import copy
import json

import pytest

from benchmark import check, control, spec

from harness_util import ROOT, SMALL

WORKLOADS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, card, monkeypatch):
    real = spec.load

    def small(name):
        s = copy.deepcopy(real(name))
        s["mix"].update(SMALL)
        return s

    monkeypatch.setattr(spec, "load", small)
    limits = real(workload)["cell"]["limits"]
    for seed in (1, 2, 3):
        r = control.readings(workload, seed, card)
        for fault in ("control_tf32", "half_batch"):
            held = {k: limits[k] for k in r[fault]}
            assert not check.judge(r[fault], held)[0], r
