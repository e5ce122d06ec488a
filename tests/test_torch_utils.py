"""The port's debug and profiling utilities (``graphneuralnetwork_tpu_torch/
utils/``) and the loose public functions JAX exports beside them, against
the JAX package on the CPU.

``tests/test_utils.py``'s cases run through the port (its orbax case
belongs to the checkpoint backend, not ported): ``assert_all_finite``,
``find_nonfinite`` (the same leaf names as JAX's on the same tree),
``nan_checked`` under ``GNN_TPU_DEBUG_NANS``, ``StepTimer`` and
``MetricLogger`` (the same printed line as JAX's); ``trace`` writes a
trace. The loose functions agree with JAX's on the same inputs:
``optax_sigmoid_bce`` within ``BCE_TOL``, ``Accumulator``,
``constant_schedule``, ``bandwidth_stats``, ``segment_sum_unsorted`` (on
integer-valued floats, whose sums are exact in any order) and
``latest_step`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graphneuralnetwork_tpu import utils as j_utils  # noqa: E402
from graphneuralnetwork_tpu.core import reorder as j_reorder  # noqa: E402
from graphneuralnetwork_tpu.ops import segment as j_segment  # noqa: E402
from graphneuralnetwork_tpu.train import metrics as j_metrics  # noqa: E402
from graphneuralnetwork_tpu.train import schedule as j_schedule  # noqa: E402
from graphneuralnetwork_tpu_torch import utils as t_utils  # noqa: E402
from graphneuralnetwork_tpu_torch.core import reorder as t_reorder  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import segment as t_segment  # noqa: E402
from graphneuralnetwork_tpu_torch.train import Accumulator  # noqa: E402
from graphneuralnetwork_tpu_torch.train import metrics as t_metrics  # noqa: E402
from graphneuralnetwork_tpu_torch.train import schedule as t_schedule  # noqa: E402

BCE_TOL = 1e-6


def test_utils_export_jax_public_names():
    names = {n for n in dir(j_utils) if not n.startswith("_")}
    names -= {"debug", "profiling", "tb"}     # JAX's submodules
    assert names <= set(dir(t_utils))


def test_assert_all_finite():
    t_utils.assert_all_finite({"a": torch.ones(3)}, "ok")
    with pytest.raises(FloatingPointError, match="bad"):
        t_utils.assert_all_finite({"a": torch.tensor([1.0, np.nan])}, "bad")


def test_find_nonfinite_paths():
    bad = t_utils.find_nonfinite({"x": torch.tensor([np.inf]),
                                  "y": torch.ones(2)})
    assert len(bad) == 1 and "x" in bad[0]


def test_find_nonfinite_names_leaves_as_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    x[0, 1], x[2, 3] = np.nan, -np.inf
    tree = {"a": [x, np.ones(2, np.float32)],
            "b": {"c": np.array([np.inf], np.float32),
                  "d": np.arange(3)},
            "e": (np.zeros(1, np.float32), x[:1])}
    want = j_utils.find_nonfinite(
        {"a": [jnp.asarray(v) for v in tree["a"]],
         "b": {k: jnp.asarray(v) for k, v in tree["b"].items()},
         "e": tuple(jnp.asarray(v) for v in tree["e"])})
    got = t_utils.find_nonfinite(
        {"a": [torch.from_numpy(v) for v in tree["a"]],
         "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
         "e": tuple(torch.from_numpy(v) for v in tree["e"])})
    assert got == want == ["['a'][0]: 2 bad", "['b']['c']: 1 bad",
                           "['e'][1]: 1 bad"]


def test_find_nonfinite_in_module_state():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                torch.nn.BatchNorm1d(2))
    with torch.no_grad():
        model[0].weight[1, 2] = np.nan
    model[1].running_var.fill_(np.inf)
    assert t_utils.find_nonfinite({"model": model}) == [
        "['model'].0.weight: 1 bad", "['model'].1.running_var: 2 bad"]
    with pytest.raises(FloatingPointError, match=r"\.0\.weight"):
        t_utils.assert_all_finite(model, "model")


def test_nan_checked_flags(monkeypatch):
    wrapped = t_utils.nan_checked(torch.log)
    # flag off: no error even for a nan-producing input
    monkeypatch.setenv("GNN_TPU_DEBUG_NANS", "0")
    assert not t_utils.debug_nans_enabled()
    assert torch.isnan(wrapped(torch.tensor([-1.0]))).all()
    # flag on: raises on a non-finite output, passes a finite one
    monkeypatch.setenv("GNN_TPU_DEBUG_NANS", "1")
    assert t_utils.debug_nans_enabled()
    with pytest.raises(FloatingPointError, match="log"):
        wrapped(torch.tensor([-1.0]))
    assert wrapped(torch.tensor([1.0])).item() == 0.0
    ints = t_utils.nan_checked(lambda: {"n": torch.arange(3)})
    assert ints()["n"].tolist() == [0, 1, 2]


def test_step_timer():
    t = t_utils.StepTimer(warmup=1)
    for _ in range(3):
        with t:
            pass
    assert len(t.times) == 2
    assert t.steps_per_s() > 0 and t.edges_per_s(100) > 0
    assert t_utils.StepTimer().steps_per_s() == 0.0


def test_step_timer_synchronises_initialised_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(1))
    with t_utils.StepTimer():
        pass
    assert calls == [1]


def test_metric_logger_smoothing(capsys):
    ml = t_utils.MetricLogger(window=2, print_freq=2)
    ml.update(loss=1.0)
    ml.update(loss=3.0)
    assert ml.smoothed("loss") == 2.0
    ml.log(total_steps=4)
    out = capsys.readouterr().out
    assert "loss" in out and "eta" in out


def test_metric_logger_prints_jax_line(capsys, monkeypatch):
    loggers = [m.MetricLogger(window=3, print_freq=1, header="ep ")
               for m in (t_utils, j_utils)]
    for ml in loggers:
        ml.start = 0.0
        for v in (1.0, 2.5, 4.0, 8.0):
            ml.update(loss=v, acc=v / 10)
    import time
    monkeypatch.setattr(time, "perf_counter", lambda: 12.0)
    lines = []
    for ml in loggers:
        ml.log(total_steps=10)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert "[4/10]" in lines[0] and "eta 18s" in lines[0]


def test_trace_writes_a_trace(tmp_path):
    with t_utils.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert files and any(p.name.endswith(".json") for p in files)


def test_optax_sigmoid_bce_equals_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(16, 7)) * 6).astype(np.float32)
    labels = rng.integers(0, 2, (16, 7))
    got = t_metrics.optax_sigmoid_bce(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    want = j_metrics.optax_sigmoid_bce(jnp.asarray(logits),
                                       jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BCE_TOL,
                               atol=BCE_TOL)


def test_accumulator_equals_jax():
    t, j = Accumulator(3), j_metrics.Accumulator(3)
    for args in ((1, 2.5, torch.tensor(3.0)), (0.25, 1, 2)):
        t.add(*args)
        j.add(*(float(a) for a in args))
    assert t.data == j.data and [t[i] for i in range(3)] == j.data
    t.reset()
    j.reset()
    assert t.data == j.data == [0.0] * 3


def test_constant_schedule_equals_jax():
    t, j = t_schedule.constant_schedule(0.05), j_schedule.constant_schedule(
        0.05)
    for step in (0, 1, 1000):
        assert t(step) == float(j(step)) == 0.05


def test_bandwidth_stats_equal_jax():
    rng = np.random.default_rng(2)
    s, r = rng.integers(0, 500, 3000), rng.integers(0, 500, 3000)
    assert t_reorder.bandwidth_stats(s, r) == j_reorder.bandwidth_stats(s, r)
    empty = np.zeros(0, np.int64)
    assert (t_reorder.bandwidth_stats(empty, empty)
            == j_reorder.bandwidth_stats(empty, empty))


def test_segment_sum_unsorted_equals_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(-50, 50, (400, 5)).astype(np.float32)
    ids = rng.integers(0, 37, 400)
    got = t_segment.segment_sum_unsorted(torch.from_numpy(data),
                                         torch.from_numpy(ids), 40)
    want = j_segment.segment_sum_unsorted(jnp.asarray(data),
                                          jnp.asarray(ids), 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_latest_step_equals_jax(tmp_path):
    import jax
    import optax
    from graphneuralnetwork_tpu.train import TrainState as JState
    from graphneuralnetwork_tpu.train.checkpoint import (
        latest_step as j_latest, save_checkpoint as j_save)
    from graphneuralnetwork_tpu_torch.train.checkpoint import (
        latest_step as t_latest, save_checkpoint as t_save)
    from graphneuralnetwork_tpu_torch.train.loop import TrainState

    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    assert t_latest(str(t_dir)) is None and j_latest(str(j_dir)) is None
    j_save(str(j_dir), JState.create(
        apply_fn=lambda *a: None, params={"w": jnp.ones((2, 3))},
        tx=optax.adam(1e-2), dropout_rng=jax.random.PRNGKey(0)), step=7)
    model = torch.nn.Linear(3, 2)
    t_save(str(t_dir), TrainState(model, torch.optim.Adam(
        model.parameters()), None, torch.Generator()), step=7)
    assert t_latest(str(t_dir)) == j_latest(str(j_dir)) == 7
