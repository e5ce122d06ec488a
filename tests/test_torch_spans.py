"""The port's spans (``utils/profiling.py``): the host table, the profiler
ranges an eager epoch emits, the reduction of a profile's events to
device time by span, and (on the card) a captured block's launch counts
with the spans in place."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    gat_graph_hybrid, gcn_graph)
from graphneuralnetwork_tpu_torch.data import (  # noqa: E402
    NodeClassificationData)
from graphneuralnetwork_tpu_torch.nn import GAT, GCN  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.train import (  # noqa: E402
    create_train_state, make_eval_fn, make_optimizer)
from graphneuralnetwork_tpu_torch.train.scan_loop import (  # noqa: E402
    CapturedBlock)
from graphneuralnetwork_tpu_torch.utils.profiling import (  # noqa: E402
    device_time_by_span, host_spans, profile_spans, reset_spans, span)

N, FEATS, CLASSES = 300, 12, 3

#: the spans every eager epoch of the model on the layout emits
EPOCH_SPANS = {"epoch", "train.forward", "train.backward", "train.optimizer",
               "eval.forward", "dropout"}
CASES = {
    "gcn_coo": ("coo", lambda: GCN(FEATS, hidden=8, num_classes=CLASSES),
                {"conv.GCNConv", "op.gather_sum", "op.gather_sum.backward",
                 "op.gather_sum.backward.dx"}),
    "gat_coo": ("coo", lambda: GAT(FEATS, hidden=4, num_heads=2,
                                   num_classes=CLASSES),
                {"conv.GATConv", "op.edge_softmax",
                 "op.edge_softmax.backward", "op.gather_sum",
                 "op.gather_sum.backward", "op.gather_sum.backward.dx"}),
    "gat_hybrid": ("hybrid", lambda: GAT(FEATS, hidden=4, num_heads=2,
                                         num_classes=CLASSES),
                   {"conv.GATConv", "op.tiled_attend", "op.draw_dropout"}),
}
#: launches of one captured epoch at the benchmark's layouts (GAT's two
#: ``d h`` launches also form the attention weights' gradient: ``K1_dw``;
#: its edge softmax is K2's softmax modes, two forward and one backward a
#: layer: ``K2_softmax``)
LAUNCHES = {"gcn_coo": {"K1": 6},
            "gat_coo": {"K1": 8, "K2": 6, "K2_softmax": 6, "K1_dw": 2}}


@pytest.fixture
def clean_spans():
    reset_spans()
    yield
    reset_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, 2000)
    r = (s // 100) * 100 + rng.integers(0, 100, 2000)
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32)


def _block(case, device="cpu"):
    layout, model, _ = CASES[case]
    s, r = _edges()
    graph = (gcn_graph(s, r, N, device=device) if layout == "coo"
             else gat_graph_hybrid(s, r, N, device=device))
    rng = np.random.default_rng(1)
    dev = torch.device(device)
    data = NodeClassificationData(
        graph=graph,
        features=torch.from_numpy(
            rng.random((N, FEATS)).astype(np.float32)).to(dev),
        labels=torch.from_numpy(rng.integers(0, CLASSES, N)).to(dev),
        train_idx=torch.arange(0, 100, device=dev),
        val_idx=torch.arange(100, 200, device=dev),
        test_idx=torch.arange(200, N, device=dev), num_classes=CLASSES,
        device=dev)
    net = model()
    state = create_train_state(net, data, 0,
                               make_optimizer("adamw", 1e-2,
                                              weight_decay=5e-4))
    return CapturedBlock(state, data, make_eval_fn(net), 3)


def test_span_nests_counts_and_stays_off_the_profiler(clean_spans,
                                                      monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)

    @span("inner")
    def inner():
        return 7

    with span("outer"):
        assert inner() == 7
        assert inner() == 7
    with span("outer"):
        pass
    table = host_spans()
    assert table["outer"][1] == 2 and table["inner"][1] == 2
    assert table["outer"][0] >= table["inner"][0] > 0.0
    assert opened == []          # no profiler, no profiler event
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("outer"):
            inner()
    assert opened == ["outer", "inner"]
    names = [e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)]
    assert names == ["outer", "inner"]
    assert host_spans()["outer"][1] == 3
    reset_spans()
    assert host_spans() == {}


def test_span_raises_through_and_still_counts(clean_spans):
    with pytest.raises(ValueError):
        with span("failing"):
            raise ValueError("inside")
    assert host_spans()["failing"][1] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_eager_epoch_emits_the_spans_under_the_profiler(case, clean_spans):
    torch.manual_seed(0)
    block = _block(case)
    assert host_spans()["train.create_state"][1] == 1
    assert host_spans()["train.optimizer_build"][1] == 1
    assert host_spans()["graph.build"][1] == 1
    block.epoch()      # first-use work outside the profile
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        block.epoch()
    names = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    assert EPOCH_SPANS | CASES[case][2] <= names
    assert host_spans()["epoch"][1] == 2
    # on the CPU no device operation runs: nothing to attribute
    block.index.zero_()
    assert profile_spans(block.epoch, repeats=1) == {}
    assert host_spans()["epoch"][1] == 4


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Ev:
    def __init__(self, name, start, end, thread=1, id=0, cuda=False,
                 annotation=False):
        self.name, self.thread, self.id = name, thread, id
        self.time_range = _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


def _span(name, start, end, thread=1):
    return _Ev(name, start, end, thread=thread, annotation=True)


def _launch(cid, at, thread, us):
    """A runtime call on ``thread`` at ``at`` and the kernel it launches
    (``us`` µs on the device, later)."""
    return [_Ev("cudaLaunchKernel", at, at + 1, thread=thread, id=cid),
            _Ev(f"kernel{cid}", 1000 + cid * 100, 1000 + cid * 100 + us,
                thread=7, id=cid, cuda=True)]


def test_device_time_by_span_on_synthetic_events():
    events = [
        _span("epoch", 0, 100), _span("train.forward", 10, 40),
        _span("op.x", 15, 30), _span("train.backward", 45, 80),
        _span("op.y.backward", 50, 70, thread=2),
        # the span's device-side range, and an op whose id collides with
        # a runtime call's: neither is a kernel nor a launch
        _Ev("epoch", 1000, 5000, thread=7, id=3, cuda=True),
        _Ev("aten::mul", 5, 6, id=3),
        *_launch(1, 20, 1, 1),      # op.x, on the spans' thread
        *_launch(2, 35, 1, 2),      # train.forward itself
        *_launch(3, 60, 2, 4),      # op.y.backward on the engine's thread
        *_launch(4, 75, 2, 8),      # the engine's thread, in no span of it
        *_launch(5, 90, 1, 16),     # epoch itself
        *_launch(6, 120, 1, 32),    # after every span
        *_launch(7, 25, 3, 64),     # another thread, outside the backward
    ]
    got = device_time_by_span(events)
    want = {"op.x": (1, 1, 1), "train.forward": (3, 2, 2),
            "op.y.backward": (4, 4, 1), "train.backward": (12, 8, 2),
            "epoch": (31, 16, 5)}
    assert set(got) == set(want)
    for name, (inclusive, own, kernels) in want.items():
        assert got[name]["inclusive_s"] == pytest.approx(inclusive * 1e-6)
        assert got[name]["self_s"] == pytest.approx(own * 1e-6)
        assert got[name]["kernels"] == kernels
    assert got["op.y.backward"]["top_kernel"] == "kernel3"
    assert got["train.backward"]["top_kernel"] == "kernel4"
    assert got["epoch"]["top_kernel_s"] == pytest.approx(16e-6)
    # the children and the parent's own time make up its time
    parts = (got["train.forward"]["inclusive_s"]
             + got["train.backward"]["inclusive_s"] + got["epoch"]["self_s"])
    assert parts == pytest.approx(got["epoch"]["inclusive_s"])


def test_backward_joins_a_launch_counted_on_the_spans_thread():
    """A launch that the profile puts on the thread of ``train.backward``
    (no op of the engine's thread linked to it) is still the engine's
    span's, which is open at the time."""
    events = [_span("train.backward", 0, 100),
              _span("op.z.backward", 10, 50, thread=2),
              *_launch(1, 20, 1, 5)]
    got = device_time_by_span(events)
    assert got["op.z.backward"]["self_s"] == pytest.approx(5e-6)
    assert got["train.backward"]["inclusive_s"] == pytest.approx(5e-6)
    assert got["train.backward"]["self_s"] == 0.0


@pytest.mark.card
@pytest.mark.parametrize("case", list(LAUNCHES))
def test_captured_launch_counts_stay_with_spans(case, card, clean_spans):
    block = _block(case, "cuda")
    block.epochs_per_call = 1
    counters.reset_launches()
    block.run()          # warm-up epoch and capture
    assert {k: n for k, n in block.launches.items() if n} == LAUNCHES[case]
    before = counters.read_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        block.run()      # one replay, with the spans' ranges open
    after = counters.read_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == LAUNCHES[case]
    assert host_spans()["block.replay"][1] == 1
