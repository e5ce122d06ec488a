"""GAT's fused edge softmax (``ops/segment.py:gat_edge_softmax``): the
softmax of ``LeakyReLU(f_src[s] + f_dst[r])`` over each receiver's edges,
on a card two modes of K2 (``csrc/segment_max_kernel.cu``: ``kSoftmax``
forward, ``kSoftmaxBwd`` for ``ds`` and ``d f_dst``) and K1 over the
transpose for ``d f_src``; on the CPU the plain versions
(``gat_softmax_plain``, ``gat_softmax_backward_plain``).

On the CPU: a float64 ``gradcheck`` of the plain path; the plain forward
bit for bit the PyTorch chain it replaces (the sender and receiver
gathers, ``leaky_relu``, ``edge_softmax``) and its gradients within
float32 rounding of the chain's autograd; ``GATConv``'s COO forward and
gradients through the op against the same layer through the chain, and
the tensor-parallel output head (``tp_models._attend_out``) likewise; the
launch arguments. On the card (``-m card``; they skip without one): the
two modes against the chain on an ogbn-arxiv-shaped graph, whose hub rows
take K2's CTA path, and on a graph with empty rows, at 8, 1 and 5 heads,
each value within ``TOL`` of its sum of |terms|, the padding edges' α and
``ds`` exactly 0, the launches counted; K2's max instances bit for bit
their plain version beside the new modes. Run on the card with ``python
-m pytest --noconftest tests/test_torch_edge_softmax.py -m card``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.nn import functional as F  # noqa: E402

from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    build_graph, gcn_graph)
from graphneuralnetwork_tpu_torch.nn import conv  # noqa: E402
from graphneuralnetwork_tpu_torch.nn.conv import GATConv  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import aggregate, segment  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    segment_max_kernel as k2)
from graphneuralnetwork_tpu_torch.ops.spmm import spmm_weighted  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel import tp_models  # noqa: E402

SLOPE = 0.2
#: of each value's sum of |terms| (the row's sums in another order, the
#: quotient and exp each within an ulp or two)
TOL = 1e-5
SMS = 132   # an H100's SMs: the layout's wave


def chain(graph, f_src, f_dst, slope):
    """The PyTorch chain the fused op replaced in ``GATConv``."""
    scores = (aggregate.gather_senders(graph, f_src)
              + aggregate.gather_receivers(graph, f_dst))
    return segment.edge_softmax(graph, F.leaky_relu(scores, slope))


def _hub_graph(device, n=6000, seed=0):
    """~12 in-edges a node, receiver 11 taking 2,000 more (a long row on
    a CTA), the last 50 nodes receiving none (empty rows)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n - 50, 72000)
    s = rng.integers(0, n, 72000)
    r[3000:5000] = 11
    keep = s != r
    return build_graph(s[keep], r[keep], n, device=device)


@functools.lru_cache(maxsize=1)
def _arxiv_graph(device):
    """ogbn-arxiv's 169,343 nodes and 1,166,243 undirected edges: the cited
    end by Pareto(2) weights, the citing end uniform, symmetrised with
    self loops (the benchmark's law; rows up to ~2,000 edges)."""
    n, m = 169_343, 1_166_243
    rng = np.random.default_rng(20260101)
    w = ((np.arange(n) + 0.5) / n) ** -0.5
    w = w[rng.permutation(n)]
    cited = rng.choice(n, size=m + m // 4, p=w / w.sum())
    citing = rng.integers(0, n, cited.shape[0])
    lo, hi = np.minimum(cited, citing), np.maximum(cited, citing)
    keys = np.unique((lo * n + hi)[lo != hi])[:m]
    return gcn_graph((keys // n).astype(np.int32),
                     (keys % n).astype(np.int32), n, device=device).warm()


def _small_graph(device="cpu", n=40, seed=3):
    """A hub receiver (node 5, on a CTA), empty rows (the last 6 nodes)
    and padding edges."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, 300)
    r = rng.integers(0, n - 6, 300)
    r[:60] = 5
    keep = s != r
    return build_graph(s[keep], r[keep], n, device=device)


def _tables(graph, heads, device, dtype=torch.float32, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    f_src = torch.randn(graph.sender_rows, heads, generator=gen,
                        device=device).to(dtype)
    f_dst = torch.randn(graph.n_nodes, heads, generator=gen,
                        device=device).to(dtype)
    d_alpha = torch.randn(graph.n_edge_pad, heads, generator=gen,
                          device=device).to(dtype)
    return f_src, f_dst, d_alpha


def _grads(fn, graph, f_src, f_dst, d_alpha):
    """``fn``'s α and the gradients of ``Σ α · d_alpha`` in both tables."""
    fs = f_src.clone().requires_grad_()
    fd = f_dst.clone().requires_grad_()
    alpha = fn(graph, fs, fd, SLOPE)
    d_src, d_dst = torch.autograd.grad((alpha * d_alpha).sum(), (fs, fd))
    return alpha.detach(), d_src, d_dst


def _scales(graph, alpha, d_alpha):
    """Each value's sum of |terms|: α's (α itself), and for ``ds``,
    ``d f_src`` and ``d f_dst`` the sums of ``α_e (|dα_e| + Σ_row α
    |dα|)`` over the edges each holds."""
    e, n = graph.n_edges, graph.n_nodes
    recv = graph.receivers[:e].long()
    send = graph.senders[:e].long()
    a, g = alpha[:e].double(), d_alpha[:e].double().abs()
    c = a.new_zeros(n, a.shape[1]).index_add_(0, recv, a * g)
    per_edge = a * (g + c[recv])
    dst = a.new_zeros(n, a.shape[1]).index_add_(0, recv, per_edge)
    src = a.new_zeros(graph.sender_rows, a.shape[1]).index_add_(
        0, send, per_edge)
    return per_edge, src, dst


def _within(got, want, scale, what):
    err = (got.double() - want.double()).abs()
    bound = TOL * scale.double() + 1e-30
    assert bool((err <= bound).all()), (what, float((err - bound).max()))


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("heads", [1, 3])
def test_plain_path_gradcheck(heads):
    """The plain path's backward (the formula the backward mode runs)
    against finite differences in float64."""
    g = _small_graph()
    f_src, f_dst, _ = _tables(g, heads, "cpu", torch.float64)
    f_src.requires_grad_()
    f_dst.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda s, d: segment.gat_edge_softmax(g, s, d, SLOPE),
        (f_src, f_dst))


@pytest.mark.parametrize("heads", [8, 1])
def test_plain_path_is_the_chain(heads):
    """Forward bit for bit the chain's on the CPU, the padding edges 0;
    the gradients within ``TOL`` of each value's sum of |terms|."""
    g = _small_graph()
    f_src, f_dst, d_alpha = _tables(g, heads, "cpu")
    a, d_src, d_dst = _grads(segment.gat_edge_softmax, g, f_src, f_dst,
                             d_alpha)
    b, c_src, c_dst = _grads(chain, g, f_src, f_dst, d_alpha)
    assert torch.equal(a, b)
    assert not a[g.n_edges:].any()
    _, s_src, s_dst = _scales(g, a, d_alpha)
    _within(d_src, c_src, s_src, "d f_src")
    _within(d_dst, c_dst, s_dst, "d f_dst")
    assert not d_dst[-6:].any()      # the empty rows


@pytest.mark.parametrize("heads, concat", [(4, True), (1, False)])
def test_gatconv_coo_matches_the_chain(heads, concat, monkeypatch):
    """``GATConv``'s COO forward and every parameter's gradient through
    ``gat_edge_softmax`` against the same layer through the chain."""
    g = _small_graph()
    torch.manual_seed(0)
    layer = GATConv(6, 5, num_heads=heads, concat_heads=concat)
    layer.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.randn(g.n_nodes, 6)
    cot = torch.randn(g.n_nodes, heads * 5 if concat else 5)

    def run():
        layer.zero_grad()
        out = layer(g, x)
        (out * cot).sum().backward()
        return out.detach(), {k: p.grad.clone()
                              for k, p in layer.named_parameters()}

    out, grads = run()
    monkeypatch.setattr(conv, "gat_edge_softmax", chain)
    want, want_grads = run()
    assert torch.equal(out, want)
    for k, gr in grads.items():
        torch.testing.assert_close(gr, want_grads[k], rtol=1e-5, atol=1e-6)


def _tp_head(g, heads, device, monkeypatch):
    """``tp_models._attend_out`` on a COO graph (the output head of a
    tensor-parallel GAT) through ``gat_edge_softmax`` and through the
    chain: the heads' mean and the gradients of the projection and both
    attention vectors under a fixed cotangent, and the launches of the
    fused run."""
    layer = GATConv(6, 5, num_heads=heads, concat_heads=False)
    layer.reset_parameters(torch.Generator().manual_seed(2))
    layer = layer.to(device)
    gen = torch.Generator().manual_seed(4)
    proj = torch.randn(g.n_nodes, heads, 5, generator=gen).to(device)
    cot = torch.randn(g.n_nodes, 5, generator=gen).to(device)

    def run():
        p = proj.clone().requires_grad_()
        out = tp_models._attend_out(layer, g, p)
        grads = torch.autograd.grad((out * cot).sum(),
                                    (p, layer.attn_src, layer.attn_dst))
        return [out.detach(), *grads]

    before = counters.read_launches()
    got = run()
    after = counters.read_launches()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    monkeypatch.setattr(tp_models, "gat_edge_softmax", chain)
    return got, run(), launched


@pytest.mark.parametrize("heads", [4, 1])
def test_tp_output_head_matches_the_chain(heads, monkeypatch):
    """The tensor-parallel output head on a COO ``Graph`` through the op:
    forward bit for bit the chain's on the CPU, the gradients within
    float32 rounding."""
    got, want, launched = _tp_head(_small_graph(), heads, "cpu",
                                   monkeypatch)
    assert launched == {}
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_softmax_args_without_a_card():
    """``softmax_args`` forward and backward: each argument converts to
    its declared ctypes type; the layout, the long rows and the mode are
    the host's."""
    g = _small_graph()
    argtypes = k2._ENTRIES["gnn_gat_softmax"]
    for heads in (8, 1, 5):
        f_src, f_dst, d_alpha = _tables(g, heads, "cpu")
        alpha = torch.zeros_like(d_alpha)
        for bwd in (False, True):
            args = k2.softmax_args(
                g, f_src, f_dst, alpha if bwd else None,
                d_alpha if bwd else None, torch.empty_like(alpha),
                torch.empty_like(f_dst) if bwd else None, SLOPE, 0, SMS)
            assert len(args) == len(argtypes)
            for arg, kind in zip(args, argtypes):
                kind(arg)
            lay = k2.segmax_layout(heads, g.mean_row_edges, g.n_nodes, SMS)
            assert args[9:17] == [g.n_nodes, heads, *lay.args()]
            assert args[17:19] == [g.long_rows.numel(), g.long_edges]
            assert args[20:22] == [SLOPE, int(bwd)]
            assert (args[5] is None) == (not bwd)
    assert g.long_rows.numel() > 0


# --------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


GRAPHS = {"arxiv": _arxiv_graph, "hub": _hub_graph}


@pytest.mark.card
@pytest.mark.parametrize("heads", [8, 1, 5])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fused_modes_against_the_chain(graph, heads, card):
    """α, ``d f_src`` and ``d f_dst`` of the two modes (and K1 over the
    transpose) within ``TOL`` of each value's sum of |terms| of the
    chain's on the card; the modes' ``ds`` against the plain backward;
    the padding edges' α and ``ds`` exactly 0, the empty rows' ``d f_dst``
    0; one K2 launch each way, both in the softmax modes, and one K1."""
    g = GRAPHS[graph](card)
    assert g.long_rows.numel() > 0
    f_src, f_dst, d_alpha = _tables(g, heads, card)
    before = counters.read_launches()
    a, d_src, d_dst = _grads(segment.gat_edge_softmax, g, f_src, f_dst,
                             d_alpha)
    torch.cuda.synchronize()
    after = counters.read_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"K2": 2, "K2_softmax": 2, "K1": 1}
    b, c_src, c_dst = _grads(chain, g, f_src, f_dst, d_alpha)
    e = g.n_edges
    assert a.dtype == torch.float32 and a.shape == (g.n_edge_pad, heads)
    assert not a[e:].any()
    _within(a[:e], b[:e], b[:e], "alpha")
    per_edge, s_src, s_dst = _scales(g, b, d_alpha)
    _within(d_src, c_src, s_src, "d f_src")
    _within(d_dst, c_dst, s_dst, "d f_dst")
    deg = torch.diff(g.row_ptr)
    assert not d_dst[deg == 0].any()
    ds, dd = k2.gat_softmax_backward(g, a, d_alpha, f_src, f_dst, SLOPE)
    plain_ds, plain_dd = k2.gat_softmax_backward_plain(g, a, d_alpha, f_src,
                                                       f_dst, SLOPE)
    assert not ds[e:].any()
    _within(ds[:e], plain_ds[:e], per_edge, "ds")
    assert torch.equal(dd, d_dst)
    # a launch repeats bit for bit
    assert torch.equal(k2.gat_softmax(g, f_src, f_dst, SLOPE), a)


@pytest.mark.card
@pytest.mark.parametrize("heads", [8, 1])
def test_max_instances_beside_the_modes(heads, card):
    """K2's max, per edge and gathered, bit for bit its plain version on
    the arxiv-shaped graph before and after the softmax modes run."""
    g = _arxiv_graph(card)
    f_src, f_dst, d_alpha = _tables(g, heads, card)
    e = g.n_edges

    def maxes():
        return (k2.segment_max(g, d_alpha), k2.segment_max(g, f_src,
                                                           g.senders))

    def plain():
        rec = g.receivers[:e]
        return (k2.segment_max_plain(d_alpha[:e], rec, g.n_nodes),
                k2.segment_max_plain(f_src[g.senders[:e].long()], rec,
                                     g.n_nodes))

    first = maxes()
    alpha = k2.gat_softmax(g, f_src, f_dst, SLOPE)
    k2.gat_softmax_backward(g, alpha, d_alpha, f_src, f_dst, SLOPE)
    for got, again, want in zip(first, maxes(), plain()):
        assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.card
@pytest.mark.parametrize("heads", [8, 1])
def test_tp_output_head_on_the_card(heads, card, monkeypatch):
    """The tensor-parallel output head on a COO ``Graph`` on the card: one
    K2 launch each way in the softmax modes (no K2 max, no gathers of the
    chain), its mean and gradients within 1e-5 of the chain's largest
    value."""
    got, want, launched = _tp_head(_hub_graph(card), heads, card,
                                   monkeypatch)
    assert launched.get("K2") == 2 and launched.get("K2_softmax") == 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
