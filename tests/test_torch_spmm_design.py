"""The host side and the traversal of the redesigned segment sum (K1,
``csrc/spmm_kernel.cu``), which runs only on the card, and the gradients
that it carries.

Pinned here:
  * ``spmm_layout``, the column layout and row groups of the kernel, at
    the path's shapes and, as a rule, over widths 1, 2, 7, 8, 64, 128 and
    heads x features, many row lengths and row counts: every column of a
    row lies in exactly one (slab, lane, vector);
  * ``Graph.transpose`` (the real edges in sender order) against numpy on
    Cora, a hub graph and a graph with empty rows, and the ``warm()``
    methods that build it before a capture;
  * the traversal: a numpy model of the kernel (each row on a group of
    lanes over up to 8 warps, its edge lanes taking every edge-lanes-th
    edge in order, folded by the xor tree of the shuffles and then in warp
    order; a long row's 8 warps interleaved and folded in warp order), in
    the per-edge and the gathered form (no weight, [E] and [E, H] weights,
    rounded weights, weights read through the transpose's edge ids),
    visiting every real edge once, against ``segment_sum_plain`` and
    JAX's ``jax.ops.segment_sum`` (the JAX package's CPU path for K1,
    ``ops/aggregate.py:42``), in float32 and bfloat16;
  * the gathered form's plain version, bit for bit the products that the
    callers formed before the gather moved into the kernel;
  * the launch arguments, built without a card;
  * parity on the CPU with the JAX package, from numpy inputs and a seed:
    the forward and the gradients (x and w) of ``spmm``,
    ``spmm_weighted`` (1 and 8 heads), GAT-COO's scores and
    ``edge_softmax``, in float32 and bfloat16; GCN-COO, GAT-COO and the
    sparse GTN end to end.

Tolerances. The kernel sums in a new order (its lanes, then the fold) and
rounds each product as before, so against a plain version or JAX in
float32 a sum may differ by the rounding of its additions:
``|a - b| <= 1e-5 * S`` with ``S`` the row's sum of |terms| (worst case
~n 2^-24 S for an n-edge row: 1e-5 covers rows of ~160 edges, and the
bound is rarely approached); in bfloat16 both round a float32 sum once,
so they may also differ by one bfloat16 step (2^-7 of the value). The
ops' parity with JAX: float32 rtol 1e-5 and atol 1e-6 of the output's
largest entry (at least 1: ``test_torch_ops``' 1e-6 on O(1) values; the
attention gradients in ``h`` sum cancelling terms of up to ~10); bfloat16
2e-2 of the output's largest entry (JAX's segment sum adds in
bfloat16, PyTorch's in float32); the models': ``test_torch_models``' and
``test_torch_gtn``'s tolerances, with their reasons there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import ops as jops  # noqa: E402
from graphneuralnetwork_tpu.core.graph import (  # noqa: E402
    build_graph as j_build)
from graphneuralnetwork_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import load_cora  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import gtn_sparse as tsparse  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import aggregate  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    spmm_kernel as k1)
from graphneuralnetwork_tpu_torch.ops.cuda.spmm_kernel import (  # noqa: E402
    spmm_layout)
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from test_torch_gtn import (  # noqa: E402, F401 (fixtures)
    BF16 as GTN_BF16, CLASSES as GTN_CLASSES, F32_FWD, F32_GRAD,
    FEATS as GTN_FEATS, HIDDEN as GTN_HIDDEN, T as GTN_T, _close,
    _close_grads, _flat, _grads, _plans, stack)
from test_torch_models import (  # noqa: E402, F401 (fixtures)
    BF16_TOL, F32_TOL, _run_both, small)

WARPS = 8          # csrc/spmm_kernel.cu kWarps: a long row's CTA
SMS = 132          # an H100's SMs: the layout's wave
ATOL_SUM = 1e-5    # of a row's sum of |terms| (module docstring)
BF16_STEP = 2.0 ** -7


# --------------------------------------------------------------- layout


@pytest.mark.parametrize("c, f, elt, mean, n_rows, want", [
    # GCN-COO's layers (Cora: 13,264 edges a 2,708 rows), float32: two
    # 16-byte vectors a lane, two edges a warp
    (128, 128, 4, 13264 / 2708, 2708, (8, 16, 32, 1, 16, 1)),
    (7, 7, 4, 13264 / 2708, 2708, (1, 8, 32, 1, 7, 1)),
    # GAT-COO: 8 heads x 8 (aggregation), the denominators, 1 x 7
    (64, 8, 4, 13264 / 2708, 2708, (4, 16, 32, 1, 16, 1)),
    (8, 8, 4, 13264 / 2708, 2708, (4, 2, 8, 1, 2, 1)),
    (7, 7, 4, 13264 / 2708, 2708, (1, 8, 32, 1, 7, 1)),
    (1, 1, 4, 13264 / 2708, 2708, (1, 1, 4, 1, 1, 1)),
    # bfloat16 8 x 8: one 16-byte vector a head
    (64, 8, 2, 13264 / 2708, 2708, (8, 8, 32, 1, 8, 1)),
    # GTN 920: the final convolution (2 channels x 64) on ~140 edges a
    # row takes 8 warps a row; its per-edge [E, 128] form likewise; the
    # 4,637-node plan's ~170 too
    (128, 64, 4, 128256 / 920, 920, (8, 16, 32, 8, 16, 1)),
    (128, 128, 2, 128256 / 920, 920, (8, 16, 32, 8, 16, 1)),
    (128, 128, 4, 786169 / 4637, 4637, (8, 16, 32, 8, 16, 1)),
    # GTN's second composition [W, 2] over (slot, type) rows: one pair a
    # lane, 32 rows a warp
    (2, 2, 4, 0.34, 641280, (2, 1, 1, 1, 1, 1)),
    # the 2M-edge shape: 32 edges a row, on 2 warps
    (128, 128, 4, 32.0, 65536, (8, 16, 32, 2, 16, 1)),
    # wider than a slab
    (1433, 1433, 4, 3.0, 2708, (1, 32, 32, 1, 32, 45)),
])
def test_spmm_layout_at_shapes(c, f, elt, mean, n_rows, want):
    lay = spmm_layout(c, f, elt, mean, n_rows, SMS)
    assert (lay.vec, lay.lpe, lay.group, lay.row_warps, lay.per,
            lay.n_slabs) == want
    rows_per_cta = (8 * 32 // lay.group if lay.row_warps == 1
                    else 8 // lay.row_warps)
    persistent = (-(-n_rows // rows_per_cta)
                  <= k1.PERSISTENT_LOOPS * SMS * k1.ROW_CTAS_PER_SM)
    assert lay.row_ctas == (SMS * k1.ROW_CTAS_PER_SM if persistent else 0)


def _pow2_ceil(v):
    return 1 << max(int(np.ceil(v)) - 1, 0).bit_length()


WIDTHS = [(c, c) for c in (1, 2, 7, 8, 64, 128, 3, 100, 500, 1433)] + [
    (h * f, f) for h, f in ((8, 8), (2, 64), (4, 8), (3, 7), (1, 301),
                            (2, 600), (8, 2))]


@pytest.mark.parametrize("elt", [4, 2])
def test_spmm_layout_rule(elt):
    """16-byte vectors where C and the head width allow (float32 from 128
    columns two a lane), else pairs, else scalars; the rows on one wave of
    CTAs (4 an SM) unless they would loop more than 6 times; the slabs
    cover every vector
    of a row exactly once through (slab, lane), at most 32 a slab, over the
    fewest lanes; powers of two of lanes an edge and a row;
    a row's edge lanes cover twice the mean row length and at least 16
    edges in one step, on at most 8 warps (the group a whole warp where
    more than one), and shrink only where the rows' warps exceed a wave of
    the card, and no further than covering half the mean."""
    wide = 16 // elt
    for c, f in WIDTHS:
        for mean in (0.0, 0.4, 1.0, 4.9, 8.0, 32.0, 140.0, 1000.0):
            for n_rows in (100, 920, 2708, 65536, 10 ** 6):
                lay = spmm_layout(c, f, elt, mean, n_rows, SMS)
                paired = (8,) if elt == 4 and c >= 128 else ()
                assert lay.vec == next(
                    v for v in (*paired, wide, 2, 1)
                    if c % v == 0 and f % v == 0)
                wave = 8 * SMS * k1.ROW_CTAS_PER_SM
                rows_per_cta = (8 * 32 // lay.group if lay.row_warps == 1
                                else 8 // lay.row_warps)
                needed = -(-n_rows // rows_per_cta)
                assert lay.row_ctas == (
                    0 if needed > k1.PERSISTENT_LOOPS * wave // 8
                    else wave // 8)
                assert f % lay.vec == 0
                assert lay.per <= lay.lpe <= 32 and lay.lpe // 2 < lay.per
                for v in (lay.lpe, lay.group, lay.row_warps):
                    assert v & (v - 1) == 0
                assert lay.lpe <= lay.group <= 32
                assert 1 <= lay.row_warps <= WARPS
                assert lay.row_warps == 1 or lay.group == 32
                vpe = c // lay.vec
                covered = np.zeros(vpe, np.int64)
                for y in range(lay.n_slabs):   # the kernel's (slab, sub)
                    for sub in range(lay.per):
                        if y * lay.per + sub < vpe:
                            covered[y * lay.per + sub] += 1
                assert (covered == 1).all(), (c, f, mean)
                assert lay.n_slabs == -(-vpe // k1.SLAB_VECS)
                epg = lay.group * lay.row_warps // lay.lpe
                full = min(32 * WARPS // lay.lpe,
                           _pow2_ceil(max(2 * mean, 16) / k1.UNROLL))
                lanes = n_rows * lay.n_slabs * lay.lpe
                assert epg <= full
                if epg < full:   # shrunk: twice as many took over a wave
                    assert lanes * 2 * epg > 32 * wave
                    assert epg * k1.UNROLL * 2 >= mean
                assert not (epg > 1 and lanes * epg > 32 * wave
                            and epg // 2 * k1.UNROLL * 2 >= mean)


def test_layout_follows_the_alignment():
    """Two 16-byte vectors (float32, 128 columns) only on 32-byte aligned
    addresses, one on 16; pairs on 8 (4 in bfloat16); else scalars."""
    assert spmm_layout(128, 128, 4, 5.0, 2708, SMS, align=16).vec == 4
    assert spmm_layout(128, 128, 4, 5.0, 2708, SMS, align=8).vec == 2
    assert spmm_layout(128, 128, 4, 5.0, 2708, SMS, align=4).vec == 1
    assert spmm_layout(64, 8, 2, 5.0, 2708, SMS, align=8).vec == 2
    assert spmm_layout(64, 8, 2, 5.0, 2708, SMS, align=2).vec == 1
    assert spmm_layout(2, 2, 4, 5.0, 2708, SMS).vec == 2
    g = _graph("random")
    for offset, vec in ((0, 8), (4, 4), (2, 2), (1, 1)):
        values = torch.zeros(g.n_edge_pad * 128 + 8)[offset:][
            :g.n_edge_pad * 128].view(g.n_edge_pad, 128)
        out = torch.zeros(g.n_nodes, 128)
        args = k1.spmm_args(values, None, None, None, False, g.row_ptr,
                            None, 0, out, g.n_edges, 0, SMS)
        assert args[11] == vec


# ---------------------------------------------------------- the graphs


def _hub(n=512):
    """Three in-edges a node, one hub row of 700, one row of 33 and nodes
    480.. with no in-edge; sender 5 sends 400 edges (a long row of the
    transpose)."""
    rng = np.random.default_rng(3)
    r = np.concatenate([np.repeat(np.arange(480), 3), np.full(700, 300),
                        np.full(30, 17), rng.integers(0, 480, 400)])
    s = rng.integers(0, n, r.shape[0])
    s[-400:] = 5
    return s.astype(np.int32), r.astype(np.int32), n


def _random(n=600):
    """About five in-edges a node (some 40), nodes 580.. with none."""
    rng = np.random.default_rng(4)
    deg = rng.poisson(5, n - 20)
    deg[::97] = 40
    r = np.repeat(np.arange(n - 20), deg)
    s = rng.integers(0, n, r.shape[0])
    return s.astype(np.int32), r.astype(np.int32), n


def _dense(n=64):
    """~150 in-edges a row (several warps a row), one row of 900 (a CTA
    of its own), two rows without edges."""
    rng = np.random.default_rng(5)
    deg = rng.integers(100, 200, n)
    deg[7], deg[40], deg[41] = 900, 0, 0
    r = np.repeat(np.arange(n), deg)
    s = rng.integers(0, n, r.shape[0])
    return s.astype(np.int32), r.astype(np.int32), n


def _sparse(n=3000):
    """Rows of less than an edge on average, as GTN's compositions: most
    rows 0 or 1 edge, 40 rows of 9 to 32 (more than two steps of a row's
    group where the rows fill the card) and 4 of 40 (long)."""
    rng = np.random.default_rng(6)
    deg = (rng.random(n) < 0.3).astype(np.int64)
    deg[rng.choice(n, 44, replace=False)] = np.concatenate(
        [rng.integers(9, 33, 40), np.full(4, 40)])
    r = np.repeat(np.arange(n), deg)
    s = rng.integers(0, n, r.shape[0])
    return s.astype(np.int32), r.astype(np.int32), n


GRAPHS = {"hub": _hub, "random": _random, "dense": _dense,
          "sparse": _sparse}
#: The SMs that the traversal's layout assumes, by graph: the sparse
#: graph's 3,000 rows fill a card of 4 SMs, so that its groups shrink as
#: the compositions' 641,280 rows do on an H100.
MODEL_SMS = {"sparse": 4}


@functools.lru_cache(maxsize=None)
def _graphs(name):
    s, r, n = GRAPHS[name]()
    w = np.random.default_rng(9).uniform(0.1, 1.0, s.shape[0])
    return (j_build(s, r, n, w.astype(np.float32)),
            tgraph.build_graph(s, r, n, w, device="cpu"))


@functools.lru_cache(maxsize=None)
def _cora():
    return load_cora(seed=0, layout="coo", device="cpu").graph


def _graph(name):
    return _cora() if name == "cora" else _graphs(name)[1]


@pytest.mark.parametrize("name", ["cora", "hub", "random", "dense"])
def test_transpose_matches_numpy(name):
    g = _graph(name)
    e, n = g.n_edges, g.n_nodes
    send = g.senders[:e].numpy()
    order = np.argsort(send, kind="stable")
    t = g.transpose
    for arr in (t.edge_ids, t.row_ptr, t.senders, t.receivers,
                t.long_rows):
        assert arr.dtype == torch.int32 and arr.is_contiguous()
    np.testing.assert_array_equal(t.edge_ids.numpy(), order)
    counts = np.bincount(send, minlength=n)
    np.testing.assert_array_equal(
        t.row_ptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    np.testing.assert_array_equal(t.senders.numpy(), send[order])
    np.testing.assert_array_equal(t.receivers.numpy(),
                                  g.receivers[:e].numpy()[order])
    np.testing.assert_array_equal(t.long_rows.numpy(),
                                  np.flatnonzero(counts > g.long_edges))
    assert g.transpose is t   # kept
    if name == "hub":
        np.testing.assert_array_equal(t.long_rows.numpy(), [5])
    if name == "random":
        assert (counts == 0).any()


def test_warm_builds_the_transposes():
    """``Graph.warm()`` builds ``transpose``; ``HybridGraph.warm()``
    reaches its remainder's, ``GTNPlan.warm()`` its final graph's and the
    wedge orders' long rows."""
    s, r, n = _random()
    g = tgraph.build_graph(s, r, n, device="cpu")
    assert "transpose" not in g.__dict__
    assert g.warm() is g and "transpose" in g.__dict__
    hg = load_cora(seed=0, layout="hybrid", device="cpu").graph
    hg.warm()
    assert "transpose" in hg.rem.__dict__
    rng = np.random.default_rng(0)
    adj = np.zeros((3, 40, 40), np.float32)
    for t in range(2):
        e = rng.integers(0, 40, (2, 90))
        adj[t][e[0], e[1]] = 1.0
    adj[2] = np.eye(40, dtype=np.float32)
    plan = tsparse.build_gtn_plan(tsparse.stacked_adj_to_sparse(adj), 40,
                                  device="cpu")
    plan.warm()
    assert "transpose" in plan.final_graph.__dict__
    for order in (*plan.step_fwd, *plan.step_bwd):
        assert "long_rows" in order.graph.__dict__


# ------------------------------------------------------ the traversal


def _fold(lanes):
    """The xor tree of the shuffles over a group's edge lanes, in float32:
    after it every lane holds the same sum; lane 0's is returned."""
    lanes = [np.asarray(v, np.float32) for v in lanes]
    off = 1
    while off < len(lanes):
        lanes = [lanes[i] + lanes[i ^ off] for i in range(len(lanes))]
        off <<= 1
    return lanes[0]


def _dot_model(rows, own, lay, f):
    """K1's dot mode for one edge lane's edges, numpy float32: ``rows`` [k,
    C] (each edge's gathered operand) against ``own`` [C] (the walked
    row's vector); each lane's ``vec`` products summed in column order,
    each head's run of vectors within a slab folded by the tree of the
    shuffles (lane j takes lane j + off where j is a multiple of 2 off),
    the slabs' parts added in slab order from 0. Returns [k, C / f]."""
    k, c = rows.shape
    vec, vpe = lay.vec, c // lay.vec
    prods = rows.reshape(k, vpe, vec) * own.reshape(vpe, vec)
    part = np.zeros((k, vpe), np.float32)
    for i in range(vec):
        part = part + prods[:, :, i]
    hv = f // vec
    dw = np.zeros((k, c // f), np.float32)
    for y in range(lay.n_slabs):
        s0, s1 = y * lay.per, min(y * lay.per + lay.per, vpe)
        for h in range(c // f):
            h0, h1 = max(h * hv, s0), min(h * hv + hv, s1)
            if h1 <= h0:
                continue
            run = [part[:, v] for v in range(h0, h1)]
            off = 1
            while off < min(hv, lay.per):
                for j in range(0, len(run) - off, 2 * off):
                    run[j] = run[j] + run[j + off]
                off <<= 1
            dw[:, h] = dw[:, h] + run[0]
    return dw


def spmm_walk_model(row_ptr, terms, lay, long_rows, long_edges,
                    vector_bytes, dot=None):
    """K1's traversal in numpy float32 over the per-edge terms [E, C] (the
    values, or each rounded product): a row in ``long_rows`` on 8 warps of
    32 / lpe edge lanes each, any other on ``lay.row_warps`` warps of
    ``lay.group / lpe`` edge lanes each (the group a whole warp where more
    than one; a row of more than two of its group's steps, where a group
    is less than a warp and holds ``vector_bytes`` of 8 or less, on the
    whole warp); the row's edge lanes in warp
    order take every
    edge-lanes-th edge in turn, each summing its edges in order from 0,
    each warp's lanes folded by the xor tree, the warps' partials added
    in warp order from 0 (a row on one warp: its fold alone). Asserts
    that every spanned edge is read once; returns float32 [N, C].

    ``dot`` = (gathered [E, C], own [N, C], f), float32: the dot mode as
    well, each walked edge's dot per head of ``f`` columns by the edge
    lane that takes it (``_dot_model``); returns (out, [E, C / f]) in the
    walked order."""
    n = len(row_ptr) - 1
    c = terms.shape[1]
    long_rows = set(long_rows)
    seen = np.zeros(terms.shape[0], np.int64)
    out = np.zeros((n, c), np.float32)
    if dot is not None:
        gathered, own, f = dot
        dots = np.zeros((terms.shape[0], c // f), np.float32)
    for row in range(n):
        lo, hi = int(row_ptr[row]), int(row_ptr[row + 1])
        if row in long_rows:
            assert hi - lo > long_edges
            warps, per_warp = WARPS, 32 // lay.lpe
        else:
            assert not long_rows or hi - lo <= long_edges
            warps = lay.row_warps
            per_warp = (32 if warps > 1 else lay.group) // lay.lpe
            if (warps == 1 and lay.group < 32 and vector_bytes <= 8
                    and hi - lo > 2 * k1.UNROLL * per_warp):
                per_warp = 32 // lay.lpe   # a big row: the whole warp
        stride = warps * per_warp
        partials = []
        for w in range(warps):
            lanes = []
            for eg in range(per_warp):
                edges = np.arange(lo + w * per_warp + eg, hi, stride)
                seen[edges] += 1
                if dot is not None and len(edges):
                    dots[edges] = _dot_model(gathered[edges], own[row], lay,
                                             f)
                acc = np.zeros(c, np.float32)
                if len(edges):
                    acc = np.cumsum(terms[edges], axis=0,
                                    dtype=np.float32)[-1]
                lanes.append(acc)
            partials.append(_fold(lanes))
        if warps == 1:
            out[row] = partials[0]
        else:
            t = np.zeros(c, np.float32)
            for p in partials:   # warp order
                t = t + p
            out[row] = t
    np.testing.assert_array_equal(seen[:row_ptr[-1]], 1)
    assert not seen[row_ptr[-1]:].any()
    return out if dot is None else (out, dots)


def _close_sums(got, want, abs_sum, dtype, what):
    """|got - want| <= rtol |want| + ATOL_SUM * S (module docstring)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rtol = BF16_STEP if dtype == torch.bfloat16 else 0.0
    ok = np.abs(got - want) <= rtol * np.abs(want) + ATOL_SUM * abs_sum
    assert ok.all(), (what, float(np.abs(got - want).max()))


FORMS = ["edges", "gather", "gather_w", "gather_w_rounded", "gather_heads",
         "transpose_w", "transpose_ids"]


def _operands(g, form, c, dtype):
    """The kernel's operands for ``form`` on ``g``: (values, receivers,
    row_ptr, n_out, keyword arguments, long rows, and the per-edge terms
    in the walked order)."""
    rng = np.random.default_rng(c + len(form))
    e, n = g.n_edges, g.n_nodes
    heads = 4 if form == "gather_heads" and c % 4 == 0 else 1
    w = torch.from_numpy(rng.uniform(-1.0, 1.0, (g.n_edge_pad, heads))
                         .astype(np.float32))
    w = w[:, 0] if heads == 1 else w
    t = g.transpose
    if form in ("edges", "transpose_ids"):
        vals = rng.normal(size=(g.n_edge_pad, c)).astype(np.float32)
        vals[e:] = 1e6     # padding: must not be read
        values = torch.from_numpy(vals).to(dtype)
    else:
        values = torch.from_numpy(
            rng.normal(size=(n, c)).astype(np.float32)).to(dtype)
    if form == "edges":
        kw, rows, ptr, lr = {}, g.receivers, g.row_ptr, g.long_rows
        terms = values[:e].float()
    elif form == "transpose_ids":   # a sender gather's backward
        kw = dict(senders=t.edge_ids)
        rows, ptr, lr = t.senders, t.row_ptr, t.long_rows
        terms = values[t.edge_ids.long()].float()
    elif form.startswith("transpose"):   # the gathered form's d x
        kw = dict(senders=t.receivers, weight=w, weight_at=t.edge_ids)
        rows, ptr, lr = t.senders, t.row_ptr, t.long_rows
        terms = k1.gathered_plain(values, t.receivers, w, t.edge_ids).float()
    else:
        kw = dict(senders=g.senders)
        if form != "gather":
            kw.update(weight=w, round_weight=form == "gather_w_rounded")
        rows, ptr, lr = g.receivers, g.row_ptr, g.long_rows
        w_e = kw["weight"][:e] if "weight" in kw else None
        terms = k1.gathered_plain(values, g.senders[:e], w_e, None,
                                  kw.get("round_weight", False))
        terms = terms.float()
    return values, rows, ptr, n, kw, lr, terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", [1, 7, 8, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_matches_plain_and_jax(name, c, form, dtype):
    """The model, rounded to the values' type, against the CPU wrapper
    (the plain version) and JAX's segment sum of the same terms, within
    the summation-order tolerance; the rows that a CTA of their own takes
    exist in the graphs where they should."""
    g = _graph(name)
    values, rows, ptr, n, kw, lr, terms = _operands(g, form, c, dtype)
    e = g.n_edges
    elt = values.element_size()
    f = c // (kw["weight"].shape[1] if "weight" in kw
              and kw["weight"].ndim == 2 else 1)
    lay = spmm_layout(c, f, elt, e / n, n, MODEL_SMS.get(name, SMS))
    model = spmm_walk_model(ptr.numpy(), terms.numpy(), lay,
                            lr.tolist(), g.long_edges, lay.vec * elt)
    model_t = torch.from_numpy(model).to(dtype).float().numpy()
    plain = k1.segment_sum(values, rows, ptr, n, n_edges=e,
                           long_rows=lr, long_edges=g.long_edges, **kw)
    assert plain.dtype == dtype and plain.shape == (n, c)
    abs_sum = k1.segment_sum_plain(terms.abs(), rows[:e], n).numpy()
    _close_sums(model_t, plain.float().numpy(), abs_sum, dtype, "plain")
    ref = jax.ops.segment_sum(jnp.asarray(terms.numpy()),
                              jnp.asarray(rows[:e].numpy()), n,
                              indices_are_sorted=True)
    _close_sums(model, np.asarray(ref), abs_sum, torch.float32, "jax")
    assert k1.segment_sum.launches == 0
    if name == "dense":
        assert lay.row_warps > 1
        assert g.long_rows.tolist() == [7]
    if name == "hub" and form.startswith("transpose"):
        assert lr.tolist() == [5]


def test_model_reaches_every_row_group():
    """The graphs above put rows on one warp (several rows a warp, and
    among them rows of more than two steps of their group that the whole
    warp takes; a row a warp), on several warps and on a CTA of their
    own."""
    seen = set()
    for name in GRAPHS:
        g = _graph(name)
        deg = np.diff(g.row_ptr.numpy())
        for c in (1, 7, 8, 64):
            lay = spmm_layout(c, c, 4, g.n_edges / g.n_nodes, g.n_nodes,
                              MODEL_SMS.get(name, SMS))
            seen.add("rows a warp" if lay.group < 32 else
                     "a row a warp" if lay.row_warps == 1 else
                     "warps a row")
            step = lay.group // lay.lpe * k1.UNROLL
            if (lay.group < 32 and lay.row_warps == 1 and lay.vec * 4 <= 8
                    and ((deg > 2 * step) & (deg <= g.long_edges)).any()):
                seen.add("a big row on its warp")
        if g.long_rows.numel():
            seen.add("a CTA a row")
    assert seen == {"rows a warp", "a row a warp", "warps a row",
                    "a big row on its warp", "a CTA a row"}


#: (heads, f) of the dot mode's cases: widths 8, 40 and 64 at 1 and 8
#: heads, and 5 heads of 9 scalars, whose third head straddles the two
#: slabs of 23 and 22 vectors.
DOT_WIDTHS = [(1, 8), (8, 1), (1, 40), (8, 5), (1, 64), (8, 8), (5, 9)]


def _dot_operands(g, heads, f, dtype, orient):
    """The dot mode's operands on ``g``: over the transpose (``orient``
    "transpose": the gathered form's backward, ``values`` the output's
    gradient read at the receivers, ``own`` the forward's table at the
    senders, the weights at the edge ids) or over ``row_ptr`` ("forward":
    the table at the senders, ``own`` at the receivers). Returns (values,
    own, w, rows, row_ptr, keyword arguments, long rows, the walked edge
    ids, and the operands of JAX's ``spmm_weighted`` whose weight gradient
    is the dot: (its x, its cotangent))."""
    rng = np.random.default_rng(heads * 100 + f)
    n, c = g.n_nodes, heads * f
    values, own = (torch.from_numpy(rng.normal(size=(n, c)).astype(
        np.float32)).to(dtype) for _ in range(2))
    w = torch.from_numpy(rng.uniform(-1.0, 1.0, (g.n_edge_pad, heads))
                         .astype(np.float32))
    w = w[:, 0] if heads == 1 else w
    if orient == "transpose":
        t = g.transpose
        kw = dict(senders=t.receivers, weight=w, weight_at=t.edge_ids)
        walk = (t.senders, t.row_ptr, kw, t.long_rows, t.edge_ids.long())
        jax_ops = (own, values)
    else:
        kw = dict(senders=g.senders, weight=w)
        walk = (g.receivers, g.row_ptr, kw, g.long_rows,
                torch.arange(g.n_edges))
        jax_ops = (values, own)
    return (values, own, w, *walk, jax_ops)


@pytest.mark.parametrize("orient", ["transpose", "forward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads, f", DOT_WIDTHS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_dot_matches_plain_and_jax(name, heads, f, dtype, orient):
    """The dot mode: the model's per-edge, per-head dot (in the kernel's
    fold order) against the CPU wrapper (the plain per-edge dot) and
    against JAX's gradient of ``spmm_weighted`` in its weights, whose
    operands hold the same values in float32, within the summation-order
    tolerance; the model's sum is the walk without the dot; the plain
    version's dot alone equals it bit for bit, its padding rows are 0."""
    g = _graph(name)
    jg = _graphs(name)[0]
    e, n, c = g.n_edges, g.n_nodes, heads * f
    values, own, w, rows, ptr, kw, lr, ids, (jx, jcot) = _dot_operands(
        g, heads, f, dtype, orient)
    elt = values.element_size()
    lay = spmm_layout(c, f, elt, e / n, n, MODEL_SMS.get(name, SMS))
    idx = kw["senders"][:e].long()
    at = kw.get("weight_at")
    terms = k1.gathered_plain(values, kw["senders"][:e],
                              w[:e] if at is None else w,
                              None if at is None else at[:e]).float()
    model, dots = spmm_walk_model(
        ptr.numpy(), terms.numpy(), lay, lr.tolist(), g.long_edges,
        lay.vec * elt, dot=(values.float().numpy()[idx.numpy()],
                            own.float().numpy(), f))
    model_dw = np.zeros((g.n_edge_pad, heads), np.float32)
    model_dw[ids.numpy()] = dots
    out, dw = k1.segment_sum(values, rows, ptr, n, n_edges=e, long_rows=lr,
                             long_edges=g.long_edges, dot=own, **kw)
    alone = k1.segment_sum(values, rows, ptr, n, n_edges=e, long_rows=lr,
                           long_edges=g.long_edges, dot=own, need_sum=False,
                           **kw)
    assert alone[0] is None and torch.equal(alone[1], dw)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert not dw[e:].any()
    dw = dw.reshape(-1, heads)
    plain = k1.segment_sum(values, rows, ptr, n, n_edges=e, long_rows=lr,
                           long_edges=g.long_edges, **kw)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    abs_sum = k1.segment_sum_plain(terms.abs(), rows[:e], n).numpy()
    _close_sums(torch.from_numpy(model).to(dtype).float().numpy(),
                plain.float().numpy(), abs_sum, dtype, "sum")
    x_at = own.float()[rows[:e].long()].reshape(e, heads, f)
    dot_abs = (values.float()[idx].reshape(e, heads, f) * x_at).abs().sum(
        -1).numpy()
    # ids[i] is the edge that the walk takes i-th; the dots by edge id
    by_id = np.zeros((g.n_edge_pad, heads))
    by_id[ids.numpy()] = dot_abs
    _close_sums(model_dw[:e], dw[:e].numpy(), by_id[:e], torch.float32,
                "plain dot")
    shape = (n, f) if heads == 1 else (n, heads, f)

    def jloss(jw):
        out = jops.spmm_weighted(
            jg, jw, jnp.asarray(jx.float().numpy().reshape(shape)))
        return jnp.sum(out * jnp.asarray(jcot.float().numpy().reshape(
            shape)))

    gw = np.asarray(jax.grad(jloss)(jnp.asarray(w.numpy())))
    _close_sums(model_dw[:e], gw.reshape(-1, heads)[:e], by_id[:e],
                torch.float32, "jax")
    assert k1.segment_sum.launches == k1.segment_sum_dw.launches == 0


def test_dot_walk_reaches_every_row_group():
    """The dot mode's cases above reach every row group of the walk: rows
    a warp (and a big row on its warp), a row a warp, warps a row, a CTA
    a row; and heads folded over 1 to 16 vectors, and split over slabs."""
    seen, runs = set(), set()
    for name in GRAPHS:
        g = _graph(name)
        for orient in ("transpose", "forward"):
            ptr = g.transpose.row_ptr if orient == "transpose" else g.row_ptr
            lr = (g.transpose.long_rows if orient == "transpose"
                  else g.long_rows)
            deg = np.diff(ptr.numpy())
            for heads, f in DOT_WIDTHS:
                for elt in (4, 2):
                    c = heads * f
                    lay = spmm_layout(c, f, elt, g.n_edges / g.n_nodes,
                                      g.n_nodes, MODEL_SMS.get(name, SMS))
                    seen.add("rows a warp" if lay.group < 32 else
                             "a row a warp" if lay.row_warps == 1 else
                             "warps a row")
                    step = lay.group // lay.lpe * k1.UNROLL
                    if (lay.group < 32 and lay.row_warps == 1
                            and lay.vec * elt <= 8
                            and ((deg > 2 * step)
                                 & (deg <= g.long_edges)).any()):
                        seen.add("a big row on its warp")
                    if lr.numel():
                        seen.add("a CTA a row")
                    runs.add(min(f // lay.vec, lay.per))
                    if lay.n_slabs > 1 and lay.per % (f // lay.vec):
                        seen.add("a head over two slabs")
    assert seen == {"rows a warp", "a row a warp", "warps a row",
                    "a big row on its warp", "a CTA a row",
                    "a head over two slabs"}
    assert {1, 2, 5, 8, 10, 16} <= runs


# ------------------------------------- the plain version, bit for bit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gathered_plain_is_the_callers_old_products(dtype):
    """``spmm``'s and ``spmm_weighted``'s plain versions on the CPU equal,
    bit for bit, the aggregation of the gathered copies that they formed
    before the gather moved into the kernel: ``x[s] * w.to(x.dtype)``, and
    ``(x[s].float() * w).to(x.dtype)`` for 1 and 4 heads."""
    g = _graph("random")
    e, n = g.n_edges, g.n_nodes
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32)).to(
        dtype)
    old = (x[g.senders] * g.edge_weight[:, None].to(dtype))[:e]
    want = k1.segment_sum_plain(old, g.receivers[:e], n)
    torch.testing.assert_close(tops.spmm(g, x), want, rtol=0, atol=0)
    for heads in (1, 4):
        w = torch.from_numpy(rng.uniform(0, 1, (g.n_edge_pad, heads))
                             .astype(np.float32))
        xh = x.reshape(n, heads, -1)
        old = (xh[g.senders].float() * w[:, :, None]).to(dtype)
        want = k1.segment_sum_plain(old.reshape(g.n_edge_pad, -1)[:e],
                                    g.receivers[:e], n)
        got = tops.spmm_weighted(g, w if heads > 1 else w[:, 0],
                                 xh if heads > 1 else x)
        torch.testing.assert_close(got.reshape(n, -1), want, rtol=0,
                                   atol=0)


# --------------------------------------------------- launch arguments


def test_launch_args_without_a_card():
    """``spmm_args`` in each form, and in the dot mode: each argument
    converts to its declared ctypes type; the layout, the head width, the
    long rows, the weight's rounding and the dot's operands are the
    host's."""
    g = _graph("hub")
    t = g.transpose
    argtypes = k1._ENTRIES["gnn_segment_sum"]
    w8 = torch.zeros(g.n_edge_pad, 8)
    cases = [
        (torch.zeros(g.n_edge_pad, 8), None, None, None, False, g.row_ptr,
         g.long_rows, 8),
        (torch.zeros(g.n_nodes, 64), g.senders, w8, None, False, g.row_ptr,
         g.long_rows, 8),
        (torch.zeros(g.n_nodes, 128, dtype=torch.bfloat16), g.senders,
         g.edge_weight, None, True, g.row_ptr, g.long_rows, 128),
        (torch.zeros(g.n_nodes, 64), t.receivers, w8, t.edge_ids, False,
         t.row_ptr, t.long_rows, 8),
        (torch.zeros(g.n_edge_pad, 8), t.edge_ids, None, None, False,
         t.row_ptr, t.long_rows, 8),
    ]
    for values, idx, w, w_at, rnd, ptr, lr, f in cases:
        c = values.shape[1]
        out = torch.empty(g.n_nodes, c, dtype=values.dtype)
        args = k1.spmm_args(values, idx, w, w_at, rnd, ptr, lr,
                            g.long_edges, out, g.n_edges, 0, SMS)
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            kind(arg)
        lay = spmm_layout(c, f, values.element_size(), g.mean_row_edges,
                          g.n_nodes, SMS)
        assert args[7:11] == [g.n_nodes, c, f,
                              0 if values.dtype == torch.float32 else 1]
        assert args[11:18] == lay.args()
        assert args[18:21] == [lr.numel(), g.long_edges, int(rnd)]
        assert [a is None for a in args[1:4]] == [
            idx is None, w is None, w_at is None]
        assert args[21:24] == [None, None, 0]
    # the dot mode, the sum's store left out: x, dw and dw's rows
    x = torch.zeros(g.n_nodes, 64)
    dw = torch.zeros(1, g.n_edge_pad, 8)
    args = k1.spmm_args(x, t.receivers, w8, t.edge_ids, False, t.row_ptr,
                        t.long_rows, g.long_edges, None, g.n_edges, 0, SMS,
                        x, dw)
    for arg, kind in zip(args, argtypes):
        kind(arg)
    assert args[6] is None and args[21:24] == [x.data_ptr(), dw.data_ptr(),
                                               g.n_edge_pad]


def test_weights_need_the_gathered_form():
    g = _graph("random")
    with pytest.raises(ValueError, match="gathered form"):
        k1.segment_sum(torch.zeros(g.n_edge_pad, 4), g.receivers, g.row_ptr,
                       g.n_nodes, weight=g.edge_weight)
    with pytest.raises(ValueError, match="weighted form"):
        k1.segment_sum(torch.zeros(g.n_nodes, 4), g.receivers, g.row_ptr,
                       g.n_nodes, senders=g.senders,
                       dot=torch.zeros(g.n_nodes, 4))


# ------------------------------------------ parity with the JAX package


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pad_zero(v, g):
    v = v.copy()
    v[g.n_edges:] = 0.0
    return v


def _hold(t, j, dtype):
    """float32: rtol 1e-5 and atol 1e-6 of the largest entry; bfloat16:
    2e-2 of the largest entry (module docstring)."""
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    scale = max(float(np.abs(j).max()), 1.0)
    if dtype == torch.float32:
        np.testing.assert_allclose(t / scale, j / scale, rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(t / scale, j / scale, rtol=0, atol=2e-2)


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
#: (graph, dtypes) of the parity cases. JAX's bfloat16 segment sums add in
#: bfloat16: on the hub graph's 700-edge row they drift up to ~8 % of the
#: output's scale from float32, where the port adds in float32, so the
#: bfloat16 parity runs on the graph of short rows (the walk test holds the
#: port's bfloat16 sums on the hub graph to float32 sums of the same
#: products).
CASES = [("random", DTYPES[0]), ("hub", DTYPES[0]), ("random", DTYPES[1])]
CASE_IDS = ["random-f32", "hub-f32", "random-bf16"]


@pytest.mark.parametrize("name, dtypes", CASES, ids=CASE_IDS)
def test_spmm_forward_and_grads_match_jax(name, dtypes):
    """``spmm`` and its gradients in x and in the edge weights."""
    td, jd = dtypes
    jg, tg = _graphs(name)
    n = tg.n_nodes
    x, cot = _rand(n, 16, seed=8), _rand(n, 16, seed=9)

    def jloss(x, w):
        out = jops.spmm(jg.with_weights(w), x.astype(jd)).astype(jnp.float32)
        return jnp.sum(out * cot)

    gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jg.edge_weight)
    tx = torch.tensor(x, requires_grad=True)
    tw = tg.edge_weight.clone().requires_grad_(True)
    tout = tops.spmm(tg.with_weights(tw), tx.to(td))
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    _hold(tout, jops.spmm(jg, jnp.asarray(x).astype(jd)), td)
    _hold(tx.grad, gx, td)
    _hold(tw.grad[:tg.n_edges], gw[:jg.n_edges], td)
    assert torch.all(tw.grad[tg.n_edges:] == 0.0)


@pytest.mark.parametrize("name, dtypes", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("heads", [1, 8])
def test_spmm_weighted_forward_and_grads_match_jax(heads, name, dtypes):
    """``spmm_weighted`` with [E] (x [N, F]) and [E, 8] (x [N, 8, F])
    weights: the forward and the gradients in x and in the weights."""
    td, jd = dtypes
    jg, tg = _graphs(name)
    n = tg.n_nodes
    xs = (n, 8) if heads == 1 else (n, heads, 8)
    ws = (jg.n_edge_pad,) if heads == 1 else (jg.n_edge_pad, heads)
    x, cot = _rand(*xs, seed=10), _rand(*xs, seed=12)
    w = _pad_zero(_rand(*ws, seed=11), jg)

    def jloss(x, w):
        out = jops.spmm_weighted(jg, w, x.astype(jd)).astype(jnp.float32)
        return jnp.sum(out * cot)

    jout = jops.spmm_weighted(jg, jnp.asarray(w), jnp.asarray(x).astype(jd))
    gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tout = tops.spmm_weighted(tg, tw, tx.to(td))
    assert tout.shape == xs and tout.dtype == td
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    _hold(tout, jout, td)
    _hold(tx.grad, gx, td)
    _hold(tw.grad[:tg.n_edges], gw[:jg.n_edges], td)
    assert torch.all(tw.grad[tg.n_edges:] == 0.0)


@pytest.mark.parametrize("name, dtypes", CASES, ids=CASE_IDS)
def test_gat_scores_and_edge_softmax_match_jax(name, dtypes):
    """GAT-COO's attention as the layers compute it, from ``h`` [N, 4, 8]
    in the compute dtype: float32 logits ``f_src``, ``f_dst``, the sender
    and receiver gathers, LeakyReLU, ``edge_softmax``, ``spmm_weighted``;
    the weights, the output and the gradients in ``h`` and in both
    attention vectors. JAX rounds the weights to bfloat16 before the
    aggregation where the port keeps them float32 (ROADMAP's deliberate
    differences), inside the bfloat16 tolerance."""
    td, jd = dtypes
    jg, tg = _graphs(name)
    n, heads, f = tg.n_nodes, 4, 8
    h = _rand(n, heads, f, seed=13)
    a_src, a_dst = _rand(heads, f, seed=14), _rand(heads, f, seed=15)
    cot = _rand(n, heads, f, seed=16)

    def jlayer(h, a_s, a_d):
        h = h.astype(jd)
        hf = h.astype(jnp.float32)
        fs = jnp.einsum("nhf,hf->nh", hf, a_s)
        fd = jnp.einsum("nhf,hf->nh", hf, a_d)
        s = jops.sddmm_additive(jg.senders, jg.receivers, fs, fd)
        alpha = jops.edge_softmax(jg, jax.nn.leaky_relu(s, 0.2))
        return alpha, jops.spmm_weighted(jg, alpha.astype(jd), h)

    def jloss(*args):
        return jnp.sum(jlayer(*args)[1].astype(jnp.float32) * cot)

    jargs = (jnp.asarray(h), jnp.asarray(a_src), jnp.asarray(a_dst))
    jalpha, jout = jlayer(*jargs)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    targs = [torch.tensor(v, requires_grad=True) for v in (h, a_src, a_dst)]
    th, ta_s, ta_d = targs
    hc = th.to(td)
    fs = torch.einsum("nhf,hf->nh", hc.float(), ta_s)
    fd = torch.einsum("nhf,hf->nh", hc.float(), ta_d)
    scores = (aggregate.gather_senders(tg, fs)
              + aggregate.gather_receivers(tg, fd))
    alpha = tops.edge_softmax(tg, torch.nn.functional.leaky_relu(scores,
                                                                 0.2))
    out = tops.spmm_weighted(tg, alpha, hc)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    _hold(alpha[:tg.n_edges], jalpha[:jg.n_edges], td)
    _hold(out, jout, td)
    for t, j in zip(targs, jgrads):
        _hold(t.grad, j, td)


@pytest.mark.parametrize("name", ["random", "hub"])
def test_gathers_backward_equal_index_backward(name):
    """The two gathers' backward (K1 over ``row_ptr`` and over the
    transpose) against PyTorch's indexing backward on the real edges."""
    _, tg = _graphs(name)
    e = tg.n_edges
    t = torch.from_numpy(_rand(tg.n_nodes, 3, seed=2)).requires_grad_()
    cot = torch.from_numpy(_rand(tg.n_edge_pad, 3, seed=3))
    cot[e:] = 0.0
    for gather, index in ((aggregate.gather_senders, tg.senders),
                          (aggregate.gather_receivers, tg.receivers)):
        got = torch.autograd.grad((gather(tg, t) * cot).sum(), t)[0]
        want = torch.autograd.grad((t[index] * cot).sum(), t)[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["f32", "bf16"])
def test_coo_models_match_flax(kind, dtype, small):
    """GCN-COO and GAT-COO end to end, on K1's gathered form and its
    transposed backward: logits and every parameter's gradient against
    flax (``test_torch_models``' tolerances)."""
    (jl, jlogits, jgrads), (tl, tlogits, tgrads) = _run_both(kind, dtype,
                                                             small)
    tol = F32_TOL if dtype is None else BF16_TOL
    scale = 1.0 if dtype is None else float(np.abs(np.asarray(jlogits)).max())
    np.testing.assert_allclose(tlogits.detach().numpy() / scale,
                               np.asarray(jlogits) / scale, **tol)
    gs = 1.0 if dtype is None else max(float(g.abs().max())
                                       for g in jgrads.values())
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k].numpy() / gs, g.numpy() / gs,
                                   err_msg=k, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_gtn_end_to_end_matches_jax(dtype, stack):
    """The sparse GTN, whose compositions, degree read-backs and final
    convolution run on K1's forms: logits and gradients against JAX's
    ``SparseGTN`` (``test_torch_gtn``'s tolerances)."""
    from graphneuralnetwork_tpu.nn import gtn_sparse as jsparse

    adj, x, params = stack
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    tp, jp = _plans(adj)

    def jloss(p):
        return jnp.sum(jsparse.SparseGTN(
            num_classes=GTN_CLASSES, hidden=GTN_HIDDEN, dtype=jd).apply(
                {"params": p}, jp, jnp.asarray(x)) ** 2)

    want = jsparse.SparseGTN(num_classes=GTN_CLASSES, hidden=GTN_HIDDEN,
                             dtype=jd).apply({"params": params}, jp,
                                             jnp.asarray(x))
    tm = tsparse.SparseGTN(GTN_FEATS, GTN_T, GTN_CLASSES, hidden=GTN_HIDDEN,
                           dtype=td)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    got = tm(tp, torch.from_numpy(x))
    _close(got.detach(), want, F32_FWD if jd is None else GTN_BF16,
           "logits")
    (got ** 2).sum().backward()
    _close_grads(_grads(tm), _flat(jax.grad(jloss)(params)),
                 F32_GRAD if jd is None else GTN_BF16)
