"""The host side and the traversal of the redesigned segment max (K2,
``csrc/segment_max_kernel.cu``), which runs only on the card.

Pinned here:
  * ``segmax_layout``, the column layout and row groups of the kernel, at
    the path's shapes and, as a rule, over many widths and row lengths:
    every column of a row lies in exactly one (slab, lane, vector);
  * ``Graph.long_edges`` and ``Graph.long_rows`` (the rows a CTA of their
    own takes) against numpy, on Cora, a hub graph and a graph with empty
    rows;
  * the traversal: a numpy model of the kernel (each row on a group of
    lanes, ``group / lpe`` edge lanes each taking every ``group / lpe``-th
    edge, ``UNROLL`` at a time, folded by the xor tree of the shuffles; a
    long row's 8 warps each over a contiguous share on 32 lanes, 8 edges
    at a time, folded in warp order), in the per-edge and the gathered
    form, visiting every real
    edge exactly once, against ``segment_max_plain`` and JAX's
    ``segment_max_pallas`` in TPU interpret mode, at 1, 7, 8 and 64
    columns, with a hub row, empty rows and a NaN.

Tolerance: none. A max is exact in any order, and the sentinel and a NaN
propagate the same way on every side, so the outputs are compared for
equality (a NaN equal to a NaN).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core.graph import (  # noqa: E402
    build_graph as j_build)
from graphneuralnetwork_tpu.ops.pallas.segment_max_kernel import (  # noqa: E402
    segment_max_pallas)
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import load_cora  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    segment_max_kernel as k2)
from graphneuralnetwork_tpu_torch.ops.cuda.segment_max_kernel import (  # noqa: E402
    EMPTY, segmax_layout)
from test_torch_attend_parts import _tpu_kernel  # noqa: E402

WARPS = 8          # csrc/segment_max_kernel.cu kWarps: a long row's CTA
SPLIT_UNROLL = 8   # its kSplitUnroll: edges in flight a lane there


# --------------------------------------------------------------- layout


SMS = 132   # an H100's SMs: the layout's wave


@pytest.mark.parametrize("c, mean, n_rows, aligned, want", [
    (8, 13470 / 2708, 2708, True, (4, 2, 8, 2, 1)),    # GAT-COO layer 1
    (1, 13470 / 2708, 2708, True, (1, 1, 4, 1, 1)),    # layer 2
    (8, 32.0, 65536, True, (4, 2, 8, 2, 1)),           # the 2M-edge shape
    (8, 4.5, 65536, True, (4, 2, 2, 2, 1)),            # the hub-row graph
    (500, 1.0, 2000, True, (4, 32, 32, 32, 4)),        # SAGE-max, Pubmed
    (128, 1.0, 2000, True, (4, 32, 32, 32, 1)),
    (8, 2.22, 2708, True, (4, 2, 8, 2, 1)),            # three-pass, Cora
    (8, 1.6, 131072, True, (4, 2, 2, 2, 1)),           # three-pass, 2M
    (7, 5.0, 2708, True, (1, 8, 32, 7, 1)),
    (8, 5.0, 2708, False, (1, 8, 32, 8, 1)),           # unaligned: scalars
    (1433, 3.0, 2708, True, (1, 32, 32, 32, 45)),      # wider than a slab
])
def test_segmax_layout_at_shapes(c, mean, n_rows, aligned, want):
    lay = segmax_layout(c, mean, n_rows, SMS, aligned)
    assert (lay.vec, lay.lpe, lay.group, lay.per, lay.n_slabs) == want
    assert lay.row_ctas == SMS * k2.ROW_CTAS_PER_SM


def test_segmax_layout_rule():
    """16-byte vectors where C allows; the slabs cover every vector of a
    row exactly once through (slab, lane), at most 32 a slab, over the
    fewest lanes; powers of two of lanes an edge and a row, at most a
    warp; a row's group covers twice the mean row length and at least 16
    edges in one step where a warp allows, and shrinks only where the
    rows' warps exceed a wave of the card, and no further than covering
    half the mean."""
    wave = SMS * k2.WAVE_WARPS_PER_SM
    for c in (*range(1, 70), 100, 127, 128, 129, 500, 512, 513, 1024,
              1433, 2048, 4100):
        for mean in (0.0, 0.4, 1.0, 1.6, 4.97, 8.0, 32.0, 100.0):
            for n_rows in (100, 2708, 65536, 10 ** 6):
                lay = segmax_layout(c, mean, n_rows, SMS)
                assert lay.vec == (4 if c % 4 == 0 else 1)
                assert lay.per <= lay.lpe <= 32 and lay.lpe // 2 < lay.per
                for v in (lay.lpe, lay.group):
                    assert v & (v - 1) == 0 and 1 <= v <= 32
                assert lay.lpe <= lay.group
                vpe = c // lay.vec
                covered = np.zeros(vpe, np.int64)
                for y in range(lay.n_slabs):   # the kernel's (slab, sub)
                    for sub in range(lay.per):
                        if y * lay.per + sub < vpe:
                            covered[y * lay.per + sub] += 1
                assert (covered == 1).all(), (c, mean)
                assert lay.n_slabs == -(-vpe // k2.SLAB_VECS)
                epg = lay.group // lay.lpe
                full = min(32 // lay.lpe, _pow2_ceil(
                    max(2 * mean, 16) / k2.UNROLL))
                lanes = n_rows * lay.n_slabs * lay.lpe
                assert epg <= full
                if epg < full:   # shrunk: twice as many took over a wave
                    assert lanes * 2 * epg > 32 * wave
                    assert epg * k2.UNROLL * 2 >= mean
                assert not (epg > 1 and lanes * epg > 32 * wave
                            and epg // 2 * k2.UNROLL * 2 >= mean)


def _pow2_ceil(v):
    return 1 << max(int(np.ceil(v)) - 1, 0).bit_length()


# ---------------------------------------------------------- the graphs


def _hub(n=512):
    """Three in-edges a node, one hub row of 700, one row of exactly 33
    (one past the threshold) and nodes 480.. with no in-edge."""
    rng = np.random.default_rng(3)
    r = np.concatenate([np.repeat(np.arange(480), 3), np.full(700, 300),
                        np.full(30, 17)])
    s = rng.integers(0, n, r.shape[0])
    return s.astype(np.int32), r.astype(np.int32), n


def _random(n=600):
    """About five in-edges a node (some more than 32), nodes 580.. with
    none."""
    rng = np.random.default_rng(4)
    deg = rng.poisson(5, n - 20)
    deg[::97] = 40
    r = np.repeat(np.arange(n - 20), deg)
    s = rng.integers(0, n, r.shape[0])
    return s.astype(np.int32), r.astype(np.int32), n


GRAPHS = {"hub": _hub, "random": _random}


@functools.lru_cache(maxsize=None)
def _graphs(name):
    s, r, n = GRAPHS[name]()
    return j_build(s, r, n), tgraph.build_graph(s, r, n, device="cpu")


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["cora"])
def test_long_rows_match_numpy(name):
    if name == "cora":
        tg = load_cora(seed=0, layout="coo", device="cpu").graph
    else:
        tg = _graphs(name)[1]
    deg = np.diff(tg.row_ptr.numpy())
    mean = tg.n_edges / tg.n_nodes
    assert tg.mean_row_edges == mean
    want_edges = max(32, 4 * int(np.ceil(mean)))
    assert tg.long_edges == want_edges
    rows = tg.long_rows
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(),
                                  np.flatnonzero(deg > want_edges))
    assert tg.long_rows is rows   # kept
    if name == "hub":
        np.testing.assert_array_equal(rows.numpy(), [17, 300])
    if name == "cora":   # GAT-COO's graph: no row takes a CTA
        assert tg.long_edges == 32 and rows.numel() == 0


# ------------------------------------------------------ the traversal


def _max_nan(m, s):
    """The kernel's max: a NaN from either side stays."""
    return np.where((s > m) | np.isnan(s), s, m)


def _fold(lanes):
    """The xor tree of the shuffles over a group's edge lanes: after it,
    every lane holds the group's max; lane 0's is returned."""
    lanes = list(lanes)
    off = 1
    while off < len(lanes):
        lanes = [_max_nan(lanes[i], lanes[i ^ off])
                 for i in range(len(lanes))]
        off <<= 1
    return lanes[0]


def segmax_walk_model(graph, src, senders=None):
    """K2's traversal in numpy: rows on groups of ``segmax_layout``'s
    width, each of its ``group / lpe`` edge lanes taking every ``group /
    lpe``-th edge of the row, ``UNROLL`` at a time, folded by the
    shuffles' xor tree; a row in ``graph.long_rows`` on 8 warps, each a
    contiguous share of the row on 32 lanes, 8 edges at a time, folded in
    warp order. Asserts
    that every real edge is read once and no padding edge; returns out
    [N, C] as ``segment_max``."""
    vals = src.numpy()
    c = vals.shape[1]
    lay = segmax_layout(c, graph.mean_row_edges, graph.n_nodes, SMS)
    row_ptr = graph.row_ptr.numpy()
    idx = (np.arange(vals.shape[0]) if senders is None
           else senders.numpy())
    long_rows = set(graph.long_rows.tolist())
    seen = np.zeros(graph.n_edge_pad, np.int64)
    out = np.full((graph.n_nodes, c), EMPTY, np.float32)
    for row in range(graph.n_nodes):
        lo, hi = int(row_ptr[row]), int(row_ptr[row + 1])
        n_e = hi - lo
        if row in long_rows:
            assert n_e > graph.long_edges
            share = -(-n_e // WARPS)
            spans = [(lo + min(w * share, n_e),
                      min(lo + min(w * share, n_e) + share, hi))
                     for w in range(WARPS)]
            epg, step = 32 // lay.lpe, SPLIT_UNROLL
        else:
            assert n_e <= graph.long_edges
            spans, epg = [(lo, hi)], lay.group // lay.lpe
            step = k2.UNROLL
        partials = []
        for wlo, whi in spans:
            lanes = []
            for eg in range(epg):
                m = np.full(c, EMPTY, np.float32)
                for e in range(wlo + eg, whi, epg * step):
                    for u in range(step):
                        ee = e + u * epg
                        if ee < whi:
                            seen[ee] += 1
                            m = _max_nan(m, vals[idx[ee]])
                lanes.append(m)
            partials.append(_fold(lanes))
        best = np.full(c, EMPTY, np.float32)
        for part in partials:   # warp order
            best = _max_nan(best, part)
        out[row] = best
    np.testing.assert_array_equal(seen[:graph.n_edges], 1)
    assert not seen[graph.n_edges:].any()
    return torch.from_numpy(out)


def _operands(tg, c, gather):
    """Random values with a NaN on a real edge: per-edge scores whose
    padding rows hold 1e6 (which must not be read), or a node table."""
    rng = np.random.default_rng(c)
    if gather:
        src = rng.normal(size=(tg.n_nodes, c)).astype(np.float32)
        src[int(tg.senders[5]), c // 2] = np.nan
    else:
        src = rng.normal(size=(tg.n_edge_pad, c)).astype(np.float32)
        src[tg.n_edges:] = 1e6
        src[5, c // 2] = np.nan
    return torch.from_numpy(src)


def _jax_segmax(jg, rows):
    """``segment_max_pallas`` in TPU interpret mode on the gathered
    per-edge values ``rows`` [E_pad, C], the padding masked to its
    sentinel, as the JAX package's callers mask it."""
    masked = np.where(np.asarray(jg.edge_mask)[:, None], rows, -3.0e38)
    call = functools.partial(segment_max_pallas, n_out=jg.n_nodes,
                             max_chunks=jg.max_chunks)
    return np.asarray(_tpu_kernel(call, jg.chunk_off, jg.chunk_cnt,
                                  jg.receivers.reshape(-1, 1),
                                  jnp.asarray(masked)))


@pytest.mark.parametrize("gather", [False, True], ids=["edges", "gather"])
@pytest.mark.parametrize("c", [1, 7, 8, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_matches_plain_and_jax(name, c, gather):
    """The model equals ``segment_max_plain`` (and the CPU wrapper) and
    JAX's kernel exactly: empty rows get the sentinel, the row with the
    NaN reads NaN there, and the hub row, split over a CTA, its max."""
    jg, tg = _graphs(name)
    src = _operands(tg, c, gather)
    senders = tg.senders if gather else None
    e = tg.n_edges
    rows = src[tg.senders.long()] if gather else src
    model = segmax_walk_model(tg, src, senders)
    plain = k2.segment_max_plain(rows[:e], tg.receivers[:e], tg.n_nodes)
    np.testing.assert_array_equal(model.numpy(), plain.numpy())
    np.testing.assert_array_equal(
        k2.segment_max(tg, src, senders).numpy(), plain.numpy())
    np.testing.assert_array_equal(model.numpy(),
                                  _jax_segmax(jg, rows.numpy()))
    deg = np.diff(tg.row_ptr.numpy())
    assert (model.numpy()[deg == 0] == EMPTY).all() and (deg == 0).any()
    assert np.isnan(model.numpy()).any()
    assert tg.long_rows.numel() > 0
    assert k2.segment_max.launches == 0


def test_launch_args_without_a_card():
    """``segmax_args`` at the path's widths: each argument converts to its
    declared ctypes type, and the layout and partition are the host's."""
    _, tg = _graphs("hub")
    for c, gather in ((8, False), (1, False), (500, True), (128, True)):
        src = torch.zeros(tg.n_nodes if gather else tg.n_edge_pad, c)
        out = torch.empty(tg.n_nodes, c)
        args = k2.segmax_args(tg, src, tg.senders if gather else None, out,
                              0, SMS)
        argtypes = k2._ENTRIES["gnn_segment_max"]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            kind(arg)
        lay = segmax_layout(c, tg.mean_row_edges, tg.n_nodes, SMS)
        assert args[5:13] == [tg.n_nodes, c, *lay.args()]
        assert args[13:15] == [tg.long_rows.numel(), tg.long_edges]
        assert (args[1] is None) == (not gather)
