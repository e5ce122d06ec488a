"""The harness on the CPU: its files by name, the contract's limits on
``BENCHMARK.json``, the generator, the work counts, the readers, the
import check, and whole small runs of every cell: sound runs against the
reference, and runs with the training step broken underneath."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import cell, check, generate, readers, spec, trace, work
from benchmark.reference import gnn
from benchmark.run import forbidden_modules

from harness_util import CLUSTERED, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))
#: each cell, and each on the hybrid layout over a clustered graph: the
#: layout that no cell runs yet, which a later cell can take as data alone
RUNS = [(w, None) for w in WORKLOADS] + [(w, "hybrid") for w in WORKLOADS]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    s = spec.load(workload)
    assert s["cell"]["layout"] in ("coo", "hybrid")
    model = s["config"]["model"]
    assert callable(spec.part("models", model).make_model)
    assert callable(gnn.model(s["config"]).forward)
    assert {m["name"] for m in s["end_to_end"]} >= {"setup_s"}
    assert len(s["end_to_end"]) >= 2 and s["per_layer"]
    assert set(s["cell"]["limits"]) == {
        "loss_gap", "val_loss_gap", "grad_gap", "change_gap", "keep_z",
        "edge_cover", "nonfinite_epochs"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric))


def test_an_unknown_model_is_refused(monkeypatch):
    cfg = dict(spec.load(WORKLOADS[0])["config"], model="gcnn")
    with pytest.raises(ValueError, match="gcnn"):
        gnn.model(cfg)
    real = spec.load_json

    def typo(path):
        data = real(path)
        return dict(data, model="gcnn") if path.parent.name == "configs" \
            else data

    monkeypatch.setattr(spec, "load_json", typo)
    with pytest.raises(SystemExit, match="gcnn"):
        spec.load(WORKLOADS[0])


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in (
            "hidden", "heads", "in_features") for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= set(
            WORKLOADS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name,clustered",
                         [(m, False) for m in MIXES] + [(MIXES[0], True)])
def test_generator_repeats_and_hits_its_counts(name, clustered):
    mix = spec.load_json(spec.HERE / "traffic" / f"{name}.json")
    if clustered:
        mix.update(CLUSTERED, community=256)
    a = generate.make_dataset(mix, 2 ** 31 + 11, "cpu")
    b = generate.make_dataset(mix, 2 ** 31 + 11, "cpu")
    c = generate.make_dataset(mix, 5, "cpu")
    assert a.n_nodes == mix["nodes"] and len(a.senders) == mix["edges"]
    keys = np.minimum(a.senders, a.receivers).astype(np.int64) * a.n_nodes \
        + np.maximum(a.senders, a.receivers)
    assert len(np.unique(keys)) == mix["edges"]
    assert not np.any(a.senders == a.receivers)
    assert a.n_nodes == len(a.train_idx) + len(a.val_idx) + len(a.test_idx)
    assert list(map(len, (a.train_idx, a.val_idx, a.test_idx))) == mix[
        "split"]
    for x, y in ((a, b), (a, c)):      # the graph is the mix's own
        assert np.array_equal(x.senders, y.senders)
    assert np.array_equal(a.labels, b.labels)
    assert torch.equal(a.features, b.features)
    assert not np.array_equal(a.labels, c.labels)
    assert a.features.shape == (mix["nodes"], mix["features"])


def test_degree_sequence_is_fixed_and_exact():
    w = generate.sender_weights(1000, 1.5)
    deg = generate.degree_sequence(w, 7000)
    assert deg.sum() == 7000 and np.all(np.diff(deg) <= 0)
    assert deg[0] > 20 * np.median(deg)


def test_work_counts_equal_hand_counts():
    g = work.gemm(3, 5, 7)
    assert (g.flops, g.bytes) == (2 * 3 * 5 * 7, 4 * (15 + 35 + 21))
    s = work.segment_sum(10, 40, 8, table=12, weights=1)
    assert s.flops == 2 * 40 * 8
    assert s.bytes == 4 * 12 * 8 + 4 * 40 + 4 * 40 + 4 * 11 + 4 * 10 * 8
    per_edge = work.segment_sum(10, 40, 3)
    assert (per_edge.flops, per_edge.bytes) == (120, 4 * 120 + 44 + 120)
    m = work.segment_max(10, 40, 3)
    assert (m.flops, m.bytes) == (120, 4 * 120 + 44 + 120)
    a = work.attend_forward(10, 40, 2, 4)
    assert (a.flops, a.exps) == (40 * 2 * 12, 80)
    assert a.bytes == 4 * (2 * 10 * 8 + 2 * 10 * 2) + 4 * (40 + 11)
    assert work.adam(5).bytes == 4 * 7 * 5
    # a GCN epoch at N=10, E=40, 6 -> 4 -> 3: 9 GEMM and aggregation
    # passes and the optimizer, by hand
    cfg = {"model": "gcn", "in_features": 6, "hidden": 4, "num_classes": 3}
    ops = gnn.model(cfg).epoch_ops(cfg, 10, 40, "coo")
    flops = (2 * (2 * 10 * 6 * 4 + 2 * 10 * 4 * 3)           # forward x2
             + 2 * 4 * 10 * 3 + 2 * 10 * 3 * 4 + 2 * 6 * 10 * 4
             + 3 * (2 * 40 * 4 + 2 * 40 * 3)                  # aggregations
             + 12 * (6 * 4 + 4 + 4 * 3 + 3))
    assert sum(op.flops for op in ops) == flops
    assert work.bound(3.35e9, 0)[1] == "bytes"
    assert work.bound(0, 67e9) == (1.0, "operations")


def test_gat_work_divides_as_its_layout():
    cfg = {"model": "gat", "in_features": 6, "hidden": 2, "heads": 2,
           "num_classes": 3}
    fused = gnn.model(cfg).epoch_ops(cfg, 10, 40, "hybrid")
    coo = gnn.model(cfg).epoch_ops(cfg, 10, 40, "coo")
    assert {o.kind for o in fused} == {"gemm", "attend", "adam"}
    assert {o.kind for o in coo} == {"gemm", "segment_sum", "segment_max",
                                     "adam"}
    # train forward, backward, val forward: 2 + 2 + 2 maxima, K1's
    # (2 + 2) x 2 + 4 x 2 sums
    assert sum(o.kind == "segment_max" for o in coo) == 4
    assert sum(o.kind == "segment_sum" for o in coo) == 16


def _ctx(**trace_parts):
    cfg = {"model": "gcn", "in_features": 6, "hidden": 4, "num_classes": 3,
           "dtype": "float32"}
    tr = {"kernel_s": {}, "busy_s": 0.5, "window_s": 1.0, "epochs": 10}
    tr.update(trace_parts)
    return {"cfg": cfg, "cell": {"layout": "coo"}, "n": 10, "e": 40,
            "spans": {"graph_build_s": 1.5}, "trace": tr, "window": None,
            "setup_s": 3.0, "memory_peak_bytes": 2 ** 30}


def test_readers_read_what_is_there_and_nothing_else():
    ctx = _ctx(kernel_s={"void segment_sum_kernel<float>": 2e-6,
                         "sm80_gemm": 1e-6})
    least = work.least_ms(readers.epoch_ops(ctx, "coo"), "float32",
                          {"segment_sum"})
    assert spec.reader("spmm_roofline")(ctx) == pytest.approx(
        100 * least * 1e-3 * 10 / 2e-6)
    assert spec.reader("attend_roofline")(ctx) is None
    assert spec.reader("torch_ops_ms_per_epoch")(ctx) == pytest.approx(1e-4)
    assert spec.reader("device_idle_share")(ctx) == pytest.approx(50.0)
    assert spec.reader("graph_build_s")(ctx) == 1.5
    assert spec.reader("first_block_s")(ctx) is None
    assert spec.reader("peak_mem_gib")(ctx) == 1.0
    assert spec.reader("epochs_per_s")(ctx) is None
    no_trace = dict(ctx)
    del no_trace["trace"]
    assert spec.reader("epoch_mfu")(no_trace) is None
    assert readers.is_port_kernel("void attend_bwd_b_kernel<float, 4>")
    assert readers.is_port_kernel(
        "void gnn_tiles::walk_kernel<(anonymous namespace)::WeightedSum, 128,"
        " 64, float>(float const*, float const*)")
    assert readers.family_s(
        {"trace": {"kernel_s": {"void gnn_tiles::walk_kernel<(anonymous "
                                "namespace)::Max, 128, 64, float>()": 1.0}}},
        ["K3"]) == 0.0
    assert not readers.is_port_kernel("void at::native::index_add_kernel")


def test_trace_union_and_gap_labels():
    s, e = trace._union(np.array([0.0, 1.0, 5.0, 6.0]),
                        np.array([2.0, 3.0, 6.0, 7.0]))
    assert s.tolist() == [0.0, 5.0] and e.tolist() == [3.0, 7.0]

    class Ev:
        def __init__(self, name, start, end):
            self.name = name
            self.time_range = type("R", (), {"start": start, "end": end})

    labels = trace._gap_labels(np.array([4.0, 9.0, 20.0]), [
        Ev("outer", 0.0, 10.0), Ev("inner", 3.5, 4.5)])
    assert labels == ["inner", "outer", "no host operation"]


def test_check_judges_each_number_against_its_limit():
    ok, checks = check.judge({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 3.0})
    assert ok and list(checks) == ["a", "b"]
    assert not check.judge({"a": 1.5}, {"a": 1.0})[0]
    assert not check.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.judge({"a": 0.0}, {"a": 1.0, "b": 0.0})[0]


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "graphneuralnetwork_tpu_torch_x",
                        sys)
    assert "graphneuralnetwork_tpu_torch_x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "graphneuralnetwork_tpu.core", sys)
    assert "graphneuralnetwork_tpu.core" in forbidden_modules()


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.run as r, benchmark.cell, benchmark.control, "
            "benchmark.trace, benchmark.masks, benchmark.spec as s; "
            "[s.part(f, m) for f in ('models', 'reference') "
            "for m in ('gcn', 'gat')]; "
            "print(r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd="/")
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         WORKLOADS[0], "--seed", "3", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and "{" not in out.stdout


def test_initial_params_are_glorot_and_repeat():
    cfg = spec.load("gat-arxiv-coo")["config"]
    a = gnn.initial_params(cfg, 3, "cpu")
    b = gnn.initial_params(cfg, 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["attn1.linear.weight"]
    assert w.abs().max() <= math.sqrt(6 / (128 + 64))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_following_a_run_gives_each_of_its_steps_back(workload):
    """``gnn.follow`` does each step again from the state the run held
    before it: following the reference's own run gives it back, and a run
    whose second step was skipped reads that step's change as 1."""
    from harness_util import SMALL

    torch.set_num_threads(1)    # two threads reorder the CPU's index_add_
    s = spec.load(workload)
    cfg, mix = s["config"], dict(s["mix"], **SMALL)
    ds = generate.make_dataset(mix, 2 ** 31 + 5, "cpu")
    edges = gnn.canonical_edges(ds.senders, ds.receivers, ds.n_nodes, "cpu")
    inputs = (ds.features, torch.from_numpy(ds.labels),
              torch.from_numpy(ds.train_idx), torch.from_numpy(ds.val_idx),
              edges, [None] * check.CHECK_STEPS)
    run = gnn.train_steps(cfg, gnn.initial_params(cfg, 9, "cpu"), *inputs)
    again = gnn.follow(cfg, run.states, *inputs)
    assert run.losses == again.losses
    assert run.val_losses == again.val_losses
    for a, b in zip(run.grads + run.steps, again.grads + again.steps):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v == 0.0 for v in check.numbers(run, again).values())
    run.states[2] = run.states[1]
    run.steps[1] = {k: torch.zeros_like(v) for k, v in run.steps[1].items()}
    assert check.numbers(run, gnn.follow(cfg, run.states, *inputs))[
        "change_gap"] == 1.0


@pytest.mark.parametrize("workload,layout", RUNS)
def test_small_run_matches_the_reference(workload, layout, small_spec):
    s = small_spec(workload, layout)
    result, checks, info = cell.run_cell(s, 2 ** 31 + 3, 0.2, False, "cpu")
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in s["end_to_end"]}
    assert list(result)[-1] == "checks"
    gaps = info[2]["gaps"]
    assert len(gaps["grad"]) == len(gaps["val_loss"]) == check.CHECK_STEPS
    assert max(gaps["loss"] + gaps["val_loss"]) < 1e-5
    assert max(max(g.values()) for g in gaps["grad"]) < 1e-5
    if s["cell"]["layout"] == "hybrid":
        assert info[0]["tiled_fraction"] > 0.3


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from graphneuralnetwork_tpu_torch.train import loop

    real = loop.masked_softmax_cross_entropy

    def half(logits, labels, mask=None):
        k = logits.shape[0] // 2
        return real(logits[:k], labels[:k])

    monkeypatch.setattr(loop, "masked_softmax_cross_entropy", half)


def _altered(monkeypatch):
    from graphneuralnetwork_tpu_torch.nn import conv

    def wrap(fn):
        def altered(*args, **kwargs):
            out = fn(*args, **kwargs)
            return torch.cat([out[:1] * 2.0, out[1:]])
        return altered

    for name in ("spmm", "spmm_weighted", "gat_tiled_attend"):
        monkeypatch.setattr(conv, name, wrap(getattr(conv, name)))


@pytest.mark.parametrize("workload,layout", [("gcn-arxiv-coo", None),
                                             ("gat-arxiv-coo", "hybrid")])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_broken_step_is_not_correct(workload, layout, fault, small_spec,
                                      monkeypatch):
    s = small_spec(workload, layout)
    fault(monkeypatch)
    result, checks, _ = cell.run_cell(s, 2 ** 31 + 3, 0.2, False, "cpu")
    assert not result["correct"], checks
