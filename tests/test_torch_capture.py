"""The captured epoch block of the PyTorch port on the CPU: its bookkeeping
under a stand-in for the CUDA graph, the capturable SGD schedule, the
graphs' ``warm()`` and the launch counters' capture arithmetic.

A CUDA graph runs only on the card. ``StubGraph`` stands in for
``scan_loop.EpochGraph`` here, with a CUDA graph's semantics as far as the
block can see them: its capture runs the epoch's Python (the wrappers
count) and then puts back every piece of state the epoch changed (a
capture launches nothing); its replays rerun the recorded epoch with the
launch totals held (a replay calls no wrapper). Against ``run_epochs``
from the same state, the block's rows, final parameters, optimizer steps
and launch totals must then agree exactly: both run the same CPU
operations in the same order, on one thread (with two, the CPU's
scatter-adds sum in an order that changes from run to run).
"""

import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu_torch.core.bcsr import build_hybrid  # noqa: E402
from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    build_graph, gat_graph_hybrid, gcn_graph, symmetrize)
from graphneuralnetwork_tpu_torch.data import (  # noqa: E402
    NodeClassificationData)
from graphneuralnetwork_tpu_torch.nn import GAT, GCN, GraphSAGE  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import aggregate  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import bcsr_attention  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import bcsr_spmm, segment  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.train import (  # noqa: E402
    create_train_state, make_eval_fn, make_optimizer, restore_checkpoint,
    save_checkpoint, train_step)
from graphneuralnetwork_tpu_torch.train import scan_loop  # noqa: E402
from graphneuralnetwork_tpu_torch.train.loop import TrainState  # noqa: E402
from graphneuralnetwork_tpu_torch.train.schedule import (  # noqa: E402
    ScheduledSGD, WarmupPolyTable, warmup_poly_factor, warmup_poly_table)

N, FEATS, CLASSES = 640, 16, 3
K = 3   # epochs a block

#: Where the port calls each kernel wrapper (the names its modules import).
CALL_SITES = [
    (aggregate, "segment_sum"), (segment, "_segment_max_kernel"),
    (bcsr_spmm, "_bcsr_spmm_kernel"),
    *((bcsr_attention, name) for name in (
        "attend_online", "attend_bwd_a", "attend_bwd_b", "neighbor_max",
        "segment_max", "rem_attend", "tile_parts", "attend_fused")),
]


@pytest.fixture
def counted(monkeypatch):
    """Each kernel wrapper's call sites count a launch per call, as the
    wrapper does where it launches its kernel (its plain version on the
    CPU counts nothing)."""
    def counting(wrapper):
        @functools.wraps(wrapper)
        def call(*args, **kwargs):
            wrapper.launches += 1
            return wrapper(*args, **kwargs)
        return call

    for module, name in CALL_SITES:
        monkeypatch.setattr(module, name, counting(getattr(module, name)))
    counters.reset_launches()
    yield
    counters.reset_launches()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clustered(n=N, comm=128, e=6000, inter=0.15, seed=0):
    """Directed edges, mostly inside communities of ``comm`` nodes."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    base = (s // comm) * comm
    r = np.where(rng.random(e) >= inter, base + rng.integers(0, comm, e),
                 rng.integers(0, n, e))
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32)


def _data(graph, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((N, FEATS)).astype(np.float32)
    return NodeClassificationData(
        graph=graph, features=torch.from_numpy(x / x.sum(1, keepdims=True)),
        labels=torch.from_numpy(rng.integers(0, CLASSES, N)),
        train_idx=torch.arange(0, 200), val_idx=torch.arange(200, 400),
        test_idx=torch.arange(400, N), num_classes=CLASSES,
        device=torch.device("cpu"))


@pytest.fixture(scope="module")
def graphs():
    s, r = _clustered()
    ss, rs = symmetrize(s, r)
    return {
        "coo": gcn_graph(s, r, N, device="cpu"),
        "gat_hybrid": gat_graph_hybrid(s, r, N, device="cpu"),
        "sage_hybrid": build_hybrid(ss, rs, N, min_edges_per_tile=192,
                                    symmetric=True, device="cpu"),
    }


#: name: (graph, model, optimizer, kernels the epoch must launch)
CASES = {
    "gcn_coo": ("coo", lambda: GCN(FEATS, hidden=16, num_classes=CLASSES,
                                   dropout=0.5),
                make_optimizer("adamw", 1e-2, weight_decay=5e-4), {"K1"}),
    "gat_hybrid": ("gat_hybrid",
                   lambda: GAT(FEATS, hidden=4, num_heads=2,
                               num_classes=CLASSES, dropout=0.6),
                   make_optimizer("adamw", 1e-2, weight_decay=5e-4),
                   {"K4", "K5", "K6"}),
    "sage_mean": ("sage_hybrid",
                  lambda: GraphSAGE(FEATS, hidden_dims=(16,),
                                    num_classes=CLASSES),
                  make_optimizer("sgd", 1e-2, weight_decay=1e-4,
                                 total_steps=2 * K, warmup_steps=1,
                                 momentum=0.9), {"K1", "K3"}),
    "sage_max": ("sage_hybrid",
                 lambda: GraphSAGE(FEATS, hidden_dims=(16,),
                                   num_classes=CLASSES, aggregator="max"),
                 make_optimizer("adamw", 1e-2, weight_decay=1e-4),
                 {"K2", "K7"}),
}


def _state_of(state):
    """Everything an epoch changes in ``state``, copied."""
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()),
            None if state.scheduler is None
            else copy.deepcopy(state.scheduler.state_dict()),
            state.generator.get_state())


def _put_back(state, saved):
    model, opt, sched, gen = saved
    state.model.load_state_dict(model)
    state.optimizer.load_state_dict(opt)
    if sched is not None:
        state.scheduler.load_state_dict(sched)
    state.generator.set_state(gen)


class StubGraph:
    """``EpochGraph`` on the CPU, with a CUDA graph's semantics as the
    block sees them (the module docstring)."""

    def __init__(self, device, generator):
        self.epoch = None

    def warm_up(self, epoch):
        epoch()

    def capture(self, epoch):
        block = epoch.__self__
        saved = _state_of(block.state)
        rows, index = block.rows.clone(), block.index.clone()
        # a capture reads no value, so the index may point past a block of
        # one epoch; the Python run here writes a row, at 0
        block.index.zero_()
        epoch()
        _put_back(block.state, saved)
        block.rows.copy_(rows)
        block.index.copy_(index)
        self.epoch = epoch

    def replay(self):
        before = counters.read_launches()
        self.epoch()
        counters.add_launches({k: before[k] - n for k, n in
                               counters.read_launches().items()})


def _steps(opt) -> list:
    """Each parameter's optimizer step count (AdamW's ``step``, or the
    schedule's count for ``ScheduledSGD``)."""
    if isinstance(opt, ScheduledSGD):
        return [int(opt.schedule.count)]
    return [int(opt.state[p]["step"]) for g in opt.param_groups
            for p in g["params"]]


@pytest.mark.parametrize("case", list(CASES))
def test_block_matches_eager_under_stub_capture(case, graphs, counted,
                                                one_thread, monkeypatch):
    """Two blocks of ``K`` epochs as one warm-up epoch, one capture and
    replays, against ``run_epochs`` from the same state: the same rows,
    parameters, optimizer steps and launch totals."""
    graph, make, spec, kernels = CASES[case]
    data = _data(graphs[graph])
    monkeypatch.setattr(scan_loop, "EpochGraph", StubGraph)
    captured = create_train_state(make(), data, 0, spec)
    eager = create_train_state(make(), data, 0, spec)
    if case == "sage_mean":      # the capturable schedule, as on CUDA
        for st in (captured, eager):
            st.scheduler = WarmupPolyTable(spec.total_steps,
                                           spec.warmup_steps, "cpu")
            st.optimizer = ScheduledSGD(st.model.parameters(), spec.lr,
                                        spec.momentum, spec.weight_decay,
                                        st.scheduler)

    block = scan_loop.CapturedBlock(captured, data,
                                    make_eval_fn(captured.model), K)
    rows = [block.run(), block.run()]
    launches = counters.read_launches()
    assert block.launches == {k: n // (2 * K) for k, n in launches.items()}
    assert {k for k, n in launches.items() if n} == kernels

    counters.reset_launches()
    evaluate = make_eval_fn(eager.model)
    ref = [scan_loop.run_epochs(eager, data, evaluate, K) for _ in range(2)]
    assert counters.read_launches() == launches
    for got, want in zip(rows, ref):
        assert got.shape == (K, 4) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for (k, a), b in zip(captured.model.state_dict().items(),
                         eager.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert _steps(captured.optimizer) == _steps(eager.optimizer)
    assert set(_steps(eager.optimizer)) == {2 * K}


def test_runner_takes_the_eager_block_on_the_cpu(graphs, one_thread,
                                                 monkeypatch):
    """``make_scanned_node_classification_run`` picks its path by the
    device alone: CPU data train in ``run_epochs``, no graph built."""
    def no_graph(*args):
        raise AssertionError("a CPU block built an EpochGraph")

    monkeypatch.setattr(scan_loop, "EpochGraph", no_graph)
    data = _data(graphs["coo"])
    make, spec = CASES["gcn_coo"][1:3]
    a = create_train_state(make(), data, 0, spec)
    b = create_train_state(make(), data, 0, spec)
    run = scan_loop.make_scanned_node_classification_run(a.model, K)
    got = run(a, data)
    want = scan_loop.run_epochs(b, data, make_eval_fn(b.model), K)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total,warm", [(20, 1), (30, 3), (4, 7)])
def test_warmup_poly_table_equals_factor(total, warm):
    """The float32 table holds ``warmup_poly_factor`` at every step, and
    the schedule's clamped count reads the factor of steps past its end
    too (0 there)."""
    table = warmup_poly_table(total, warm)
    assert table.dtype == torch.float32
    for t in range(len(table)):
        assert float(table[t]) == warmup_poly_factor(t, total, warm)
    sched = WarmupPolyTable(total, warm, "cpu")
    for t in range(len(table) + 5):
        assert float(sched.factor()) == warmup_poly_factor(t, total, warm)
        sched.step()


@pytest.mark.parametrize("momentum,weight_decay", [(0.9, 5e-4), (0.0, 0.0)])
def test_scheduled_sgd_matches_torch_sgd_lambdalr(momentum, weight_decay):
    """Ten steps of ``ScheduledSGD`` with its device-side learning rate
    against ``torch.optim.SGD`` + ``LambdaLR(warmup_poly_factor)`` on the
    same gradients: within 1e-7 (they run the same float32 operations)."""
    rng = np.random.default_rng(0)
    init = [rng.normal(size=shape).astype(np.float32) * 0.1
            for shape in [(48, 16), (16,), (16, 4)]]
    a = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    b = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    ref = torch.optim.SGD(a, lr=0.2, momentum=momentum,
                          weight_decay=weight_decay)
    ref_sched = torch.optim.lr_scheduler.LambdaLR(ref, functools.partial(
        warmup_poly_factor, total_steps=10, warmup_steps=1))
    sched = WarmupPolyTable(10, 1, "cpu")
    opt = ScheduledSGD(b, 0.2, momentum, weight_decay, sched)
    for _ in range(10):
        for p, q in zip(a, b):
            g = rng.normal(size=tuple(p.shape)).astype(np.float32)
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        ref.step()
        ref_sched.step()
        opt.step()
        sched.step()
    assert int(sched.count) == 10
    for p, q in zip(a, b):
        torch.testing.assert_close(q.detach(), p.detach(), rtol=0,
                                   atol=1e-7)


def test_scheduled_sgd_checkpoint_round_trip(graphs, one_thread, tmp_path):
    """The checkpoint saves and restores the schedule's count and table
    with the momentum buffers: the next step continues identically."""
    data = _data(graphs["coo"])
    spec = make_optimizer("sgd", 0.2, weight_decay=5e-4, total_steps=20,
                          warmup_steps=1, momentum=0.9)

    def state(seed):
        st = create_train_state(CASES["gcn_coo"][1](), data, seed, spec)
        sched = WarmupPolyTable(20, 1, "cpu")
        return TrainState(st.model, ScheduledSGD(
            st.model.parameters(), 0.2, 0.9, 5e-4, sched), sched,
            st.generator)

    a = state(0)
    for _ in range(3):
        train_step(a, data)
    save_checkpoint(str(tmp_path), a, 3)
    b, step = restore_checkpoint(str(tmp_path), state(1))
    assert step == 3 and int(b.scheduler.count) == 3
    torch.testing.assert_close(b.scheduler.factors, a.scheduler.factors,
                               rtol=0, atol=0)
    b.generator.set_state(a.generator.get_state())
    assert float(train_step(a, data)[0]) == float(train_step(b, data)[0])
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b, strict=True))
    return a.dtype == b.dtype and torch.equal(a, b)


#: The caches ``warm()`` builds, by the part of the graph that holds them.
WARM = {
    "": ("row_edges", "long_rows", "rem_long_rows"),
    "bcsr": ("slot_edges", "row_masks", "col_masks"),
    "bcsr_t": ("slot_edges", "row_masks", "col_masks"),
    "rem": ("long_rows",),
    "rem_t": ("long_rows",),
}


@pytest.mark.parametrize("symmetric", [True, False])
def test_hybrid_warm_builds_every_cache(symmetric):
    """After ``warm()`` every first-use cache of the hybrid graph and of
    its parts is in the part's ``__dict__``, equal to the one a fresh
    graph builds lazily."""
    s, r = _clustered()
    if symmetric:
        s, r = symmetrize(s, r)

    def build():
        return build_hybrid(s, r, N, min_edges_per_tile=192,
                            symmetric=symmetric, device="cpu")

    warm, lazy = build(), build()
    assert warm.bcsr.n_tiles > 1 and warm.rem.n_edges > 0
    assert warm.warm() is warm
    parts = [(getattr(warm, p) if p else warm, getattr(lazy, p) if p else
              lazy, names) for p, names in WARM.items()]
    for w, z, names in parts:
        for name in names:
            assert name in w.__dict__ and name not in z.__dict__, name
    for w, z, names in parts:
        for name in names:
            assert _equal(w.__dict__[name], getattr(z, name)), name


def test_graph_warm_builds_long_rows():
    s, r = _clustered()
    hub = np.zeros(200, np.int32)            # a row long enough for K2
    s = np.concatenate([s, np.arange(1, 201, dtype=np.int32)])
    r = np.concatenate([r, hub])
    warm, lazy = (build_graph(s, r, N, device="cpu") for _ in range(2))
    assert warm.warm() is warm and "long_rows" in warm.__dict__
    assert warm.long_rows.numel() > 0
    assert _equal(warm.__dict__["long_rows"], lazy.long_rows)


def test_count_capture_takes_a_capture_off_and_replays_add_it(counted):
    """A fake capture calls wrappers (they count, nothing launches): its
    counts come off the totals and come back as the launches of each
    replay."""
    counters.segment_sum.launches = 5           # launched before
    k1, k3 = counters.COUNTERS["K1"], counters.COUNTERS["K3"]

    def fake_capture():
        k1.launches += 4
        k3.launches += 6

    per_replay = counters.count_capture(fake_capture)
    assert per_replay == {**dict.fromkeys(counters.COUNTERS, 0),
                          "K1": 4, "K3": 6}
    assert counters.read_launches()["K1"] == 5
    assert counters.read_launches()["K3"] == 0
    for _ in range(3):
        counters.add_launches(per_replay)
    assert counters.read_launches()["K1"] == 5 + 3 * 4
    assert counters.read_launches()["K3"] == 3 * 6
