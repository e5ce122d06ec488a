"""K1's dot mode on the card (``csrc/spmm_kernel.cu``, ``kDot``): the
per-edge, per-head dot that the gathered form's backward forms beside
``d x`` over the graph's transpose, held against its plain version
(``gathered_dot_plain``) at the GAT's layer shapes on ogbn-arxiv ([N, 8,
8] and [N, 1, 40]), at 5 heads of 9 (a head over two slabs) and at 8
heads of 1 (scalar vectors, whose mid-length rows the whole warp takes),
on two graphs whose hub sender takes a CTA of its own in the transpose,
one of short sender rows and one of long (several warps a row), in
float32 and bfloat16, the cases reaching every row group of the walk; and
``aggregate_gathered``'s gradients on the card against the CPU's. The CPU has no kernel: these skip there (the walk's
model and the plain version's parity with JAX are in
``test_torch_spmm_design.py``). Run on the card with ``python -m pytest
--noconftest tests/test_torch_spmm_dot.py -m card``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graphneuralnetwork_tpu_torch.core.graph import build_graph  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import aggregate  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    spmm_kernel as k1)

#: (heads, features a head): the GAT's layers on ogbn-arxiv; 5 x 9, whose
#: third head straddles two slabs of scalars; 8 x 1, scalars on 8 lanes
#: an edge, where a row of more than two steps of its group is taken by
#: the whole warp
SHAPES = [(8, 8), (1, 40), (5, 9), (8, 1)]
ATOL_SUM = 1e-5    # of an edge and head's sum of |terms|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hub_graph(device, n=6000, seed=0):
    """~12 in-edges a node from uniform senders, sender 7 sending 3,000
    edges (a long row of the transpose) and receiver 11 taking 2,000; the
    last 50 nodes send nothing."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 72000)
    s = rng.integers(0, n - 50, 72000)
    s[:3000] = 7
    r[3000:5000] = 11
    keep = s != r
    return build_graph(s[keep], r[keep], n, device=device)


def _dense_graph(device, n=1000, seed=2):
    """60 to 140 out-edges a node, to uniform receivers, and sender 3
    sending 1,500 more: long sender rows, which several warps take in the
    transpose, and one that takes a CTA."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([np.repeat(np.arange(n), rng.integers(60, 140, n)),
                        np.full(1500, 3)])
    r = rng.integers(0, n, s.shape[0])
    keep = s != r
    return build_graph(s[keep], r[keep], n, device=device)


#: graph: (its builder, the transpose's long rows)
GRAPHS = {"hub": (_hub_graph, [7]), "dense": (_dense_graph, [3])}


def _row_groups(g, heads, f, dtype, device) -> set:
    """The walk's row groups that K1's dot mode takes over ``g``'s
    transpose at ``heads`` x ``f`` in ``dtype``, by the layout the launch
    takes on this card (``_args_layout``)."""
    t, e, n = g.transpose, g.n_edges, g.n_nodes
    grad, x, w = _operands(g, heads, f, dtype, device)
    lay = k1._args_layout(grad, w, None, x, n, e,
                          k1.sm_count(device.index or 0))
    seen = {"rows a warp" if lay.group < 32 else
            "a row a warp" if lay.row_warps == 1 else "warps a row"}
    deg = np.diff(t.row_ptr.cpu().numpy())
    step = lay.group // lay.lpe * k1.UNROLL
    if (lay.group < 32 and lay.row_warps == 1
            and lay.vec * grad.element_size() <= 8
            and ((deg > 2 * step) & (deg <= g.long_edges)).any()):
        seen.add("a big row on its warp")
    if t.long_rows.numel():
        seen.add("a CTA a row")
    if lay.n_slabs > 1 and lay.per % (f // lay.vec):
        seen.add("a head over two slabs")
    return seen


def _operands(g, heads, f, dtype, device, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = heads * f
    grad = torch.randn(g.n_nodes, c, generator=gen, device=device).to(dtype)
    x = torch.randn(g.n_nodes, c, generator=gen, device=device).to(dtype)
    w = torch.rand(g.n_edge_pad, heads, generator=gen, device=device)
    return grad, x, (w[:, 0].contiguous() if heads == 1 else w)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads, f", SHAPES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dot_mode_against_plain(graph, heads, f, dtype, card):
    """``d w`` within ``ATOL_SUM`` of each edge and head's sum of |terms|
    of the plain version, its padding rows 0; the launch's ``d x`` bit
    for bit the launch's without the dot; the dot alone (no sum stored)
    bit for bit the same ``d w``; three K1 launches, two with the dot."""
    build, long_rows = GRAPHS[graph]
    g = build(card)
    t, e, n = g.transpose, g.n_edges, g.n_nodes
    assert t.long_rows.tolist() == long_rows
    grad, x, w = _operands(g, heads, f, dtype, card)
    kw = dict(senders=t.receivers, weight=w, weight_at=t.edge_ids,
              n_edges=e, long_rows=t.long_rows, long_edges=g.long_edges)
    before = counters.read_launches()
    plain_dx = k1.segment_sum(grad, t.senders, t.row_ptr, n, **kw)
    dx, dw = k1.segment_sum(grad, t.senders, t.row_ptr, n, dot=x, **kw)
    none, alone = k1.segment_sum(grad, t.senders, t.row_ptr, n, dot=x,
                                 need_sum=False, **kw)
    torch.cuda.synchronize()
    after = counters.read_launches()
    assert after["K1"] - before["K1"] == 3
    assert after["K1_dw"] - before["K1_dw"] == 2
    assert torch.equal(dx, plain_dx)
    assert none is None and torch.equal(alone, dw)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert not dw[e:].any()
    args = (t.receivers[:e], x, t.senders[:e], w, t.edge_ids[:e])
    ref = k1.gathered_dot_plain(grad, *args)
    scale = k1.gathered_dot_plain(grad.float().abs(), t.receivers[:e],
                                  x.float().abs(), *args[2:])
    err = (dw - ref).abs()
    assert bool((err <= ATOL_SUM * scale).all()), float(err.max())


@pytest.mark.card
def test_dot_cases_reach_every_row_group(card):
    """The cases of ``test_dot_mode_against_plain`` take every row group
    of the walk on this card: rows a warp, a big row on its warp, a row a
    warp, warps a row, a CTA a row, and a head over two slabs."""
    seen = set()
    for build, _ in GRAPHS.values():
        g = build(card)
        for heads, f in SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                seen |= _row_groups(g, heads, f, dtype, card)
    assert seen == {"rows a warp", "a big row on its warp", "a row a warp",
                    "warps a row", "a CTA a row", "a head over two slabs"}


@pytest.mark.card
@pytest.mark.parametrize("heads, f", SHAPES)
def test_gather_sum_backward_on_card_matches_cpu(heads, f, card):
    """``aggregate_gathered``'s gradients in ``x`` and in the weights on
    the card (K1's dot mode) against the CPU's (the plain versions), and
    with ``x`` not needing one (the dot alone): one K1 launch for the
    backward each time, carrying the dot."""
    grads, ops = {}, {}
    for device in ("cpu", card):
        g = _hub_graph(device)
        grad, x, w = ops[device] = tuple(v.cpu().to(device) for v in _operands(
            g, heads, f, torch.float32, card))
        for need_x in (True, False):
            xs = x.clone().requires_grad_(need_x)
            ws = w.clone().requires_grad_(True)
            out = aggregate.aggregate_gathered(g, xs, ws)
            before = counters.read_launches()
            out.backward(grad)
            after = counters.read_launches()
            if device != "cpu":
                assert after["K1"] - before["K1"] == 1
                assert after["K1_dw"] - before["K1_dw"] == 1
            grads[device, need_x] = (xs.grad, ws.grad)
    # the sums of |terms| on the CPU: of d x's row sums and of d w's dots
    g = _hub_graph("cpu")
    grad, x, w = ops["cpu"]
    t, e = g.transpose, g.n_edges
    dx_scale = k1.segment_sum(grad.abs(), t.senders, t.row_ptr, g.n_nodes,
                              senders=t.receivers, weight=w.abs(),
                              weight_at=t.edge_ids, n_edges=e)
    dw_scale = k1.gathered_dot_plain(grad.abs(), t.receivers[:e], x.abs(),
                                     t.senders[:e], w, t.edge_ids[:e])
    for need_x in (True, False):
        (cx, cw), (gx, gw) = grads["cpu", need_x], grads[card, need_x]
        assert gw.shape == cw.shape and not gw[e:].any()
        assert bool(((gw.cpu() - cw).abs() <= ATOL_SUM * dw_scale).all())
        if need_x:
            assert bool(((gx.cpu() - cx).abs() <= ATOL_SUM * dx_scale).all())
        else:
            assert gx is None and cx is None
