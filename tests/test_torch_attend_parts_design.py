"""The three-pass attend's remainder partials (K8) and tile partials (K9) on
the row walk of ``csrc/attend_walk.cuh``: two modes of the kernel that
runs K10 (``csrc/attend_fused_kernel.cu``), which runs only on the card.

Pinned here:
  * the algebra of each mode: a torch model of the kernel (K8: each
    receiver row's remainder edges, the stream's entries ``[0, nr)``, rows
    whose remainder alone holds more than the long-row threshold split into
    8 warps' shares; K9: its tile slots, entries ``[nr, len)``, rows above
    the threshold of ``HybridGraph.row_edges`` split as K10 splits them;
    batches of 32, ``p`` from the given shift with the exponent clamped at
    0, no seeds and no division, the warps added in warp order, a head
    wider than a warp holds in parts of its columns) against
    ``rem_attend_plain`` / ``tile_parts_plain`` and JAX's
    ``_rem_attend_kernel`` / ``_attend_kernel`` in TPU interpret mode, at
    8x8, 1x7 and 2x600 (two parts), with and without dropout, with the
    three-pass shift and with the profiler's ``m = 0``; on the hub fixture
    with the graph's own rule and with every row above 4 entries split;
  * ``HybridGraph.rem_long_rows``, K8's long rows, against a numpy count
    from ``rem.row_ptr``: empty on the hub fixture, whose long rows are
    all long by their tile slots; not empty on the same hub with its dense
    tiles left in the remainder, where the model splits them by the
    graph's own rule;
  * K8's and K9's launch arguments (``rem_attend_args``,
    ``tile_parts_args``), built without a card at 8x256, 4x512 and 2x600
    in float32 and bfloat16: the walk's column layout of ``x`` and
    ``num``, no windows; K8 names no tile operand, K9 the row masks, the
    forward row lengths and long rows.

Tolerances: the forward's of ``tests/test_torch_attend_design.py`` (the
JAX package's own for its kernels against its XLA path), ``rtol=2e-4,
atol=2e-5``: the sides sum in float32 in other orders.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.ops import bcsr_attention as jatt  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core.bcsr import LONG_ROW_EDGES  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    attend_parts_kernel as k910, rem_attend_kernel as k8)
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import (  # noqa: E402
    attend_layout, leaky, walk_layout)
from test_torch_attend_design import (  # noqa: E402
    BATCH, GRAPHS, WARPS, _hub, _hybrids, _stream)
from test_torch_attend_parts import (  # noqa: E402, F401 (graphs: a fixture)
    N, NO_TILE_ROWS, _jax_shift, _t, _tpu_kernel, graphs)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
SLOPE, KEEP = 0.2, 0.6


def _rem_stream(hg, keep_mul):
    """The remainder's real edges with their receiver and their place in
    the receiver's stream (entries ``[0, nr)``), as K8 walks them."""
    rem = hg.rem
    e = rem.n_edges
    recv = rem.receivers[:e].long()
    pos = torch.arange(e) - rem.row_ptr[:-1].long()[recv]
    keep = None if keep_mul is None else keep_mul[:e]
    return recv, rem.senders[:e].long(), rem.edge_weight[:e], pos, keep


def parts_walk_model(mode, hg, x, f_src, f_dst, m, bits, keep_mul, slope,
                     keep_prob, long_edges):
    """K8's (``mode="rem"``) or K9's (``"tiles"``) arithmetic in torch:
    each row's part of the stream in order; a row longer than
    ``long_edges`` (K8: by its remainder edges alone; K9: by
    ``HybridGraph.row_edges``, remainder plus tile slots, as K10) splits
    its part into 8 contiguous shares, one a warp, the others stay on one
    warp; each warp sums its share in batches of 32, ``p = w * exp(min(
    score - m, 0))`` and ``p * keep * x_s`` over each part of the slab
    (``attend_layout``), from zero; the warps add in warp order. Returns
    ``(num, den)`` as ``rem_attend`` / ``tile_parts``."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    lay = attend_layout(heads, feat, x.element_size())
    nr = (hg.rem.row_ptr[1:] - hg.rem.row_ptr[:-1]).long()
    if mode == "rem":
        recv, send, w, pos, keep = _rem_stream(hg, keep_mul)
        count = length = nr
    else:   # the stream from the first tile slot on, counted from there
        ones = (torch.ones(hg.rem.n_edge_pad, heads) if keep_prob < 1.0
                else None)
        recv, send, w, _, pos, keep = _stream(hg, bits, ones, heads,
                                              keep_prob)
        tile = pos >= nr[recv]
        recv, send, w, pos = recv[tile], send[tile], w[tile], pos[tile]
        pos = pos - nr[recv]
        keep = None if keep is None else keep[tile]
        length = hg.row_edges[0].long()
        count = length - nr
    share = torch.where(length > long_edges, -(-count // WARPS),
                        count.clamp_min(1))
    warp = pos // share[recv]
    assert (warp < WARPS).all()
    batch = (pos - warp * share[recv]) // BATCH
    slot = recv * WARPS + warp                        # one (row, warp)
    p = w[:, None] * torch.exp(torch.clamp_max(
        leaky(f_dst[recv] + f_src[send], slope) - m[recv], 0.0))
    pn = p if keep is None else p * keep
    xs = x[send].float().view(-1, heads, feat)
    den = torch.zeros(n * WARPS, heads)
    num = torch.zeros(n * WARPS, heads, feat)
    vph = feat // lay.vec
    per = -(-vph // lay.parts)
    for b in range(int(batch.max()) + 1 if batch.numel() else 0):
        sel = batch == b
        den.index_add_(0, slot[sel], p[sel])
        for part in range(lay.parts):   # attend_walk.cuh:slab_of
            c0 = part * per * lay.vec
            c1 = min((part + 1) * per, vph) * lay.vec
            num[..., c0:c1].index_add_(
                0, slot[sel], pn[sel, :, None] * xs[sel, :, c0:c1])
    den, num = den.view(n, WARPS, heads), num.view(n, WARPS, heads, feat)
    den_row = torch.zeros(n, heads)
    num_row = torch.zeros(n, heads, feat)
    for q in range(WARPS):   # warp order
        den_row += den[:, q]
        num_row += num[:, q]
    return num_row.reshape(n, hf), den_row


def _operands(jh, n, heads, feat, dropout, shift, seed):
    """Random operands for both packages: x, the logits, the shift (the
    three-pass one, or 0) and the JAX-drawn masks under dropout, as (jax
    dict, port dict)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, heads * feat)).astype(np.float32)
    fs, fd = (rng.normal(size=(n, heads)).astype(np.float32)
              for _ in range(2))
    m = (_jax_shift(jh, fs, fd) if shift == "exact"
         else np.zeros((n, heads), np.float32))
    bits = keep_mul = None
    if dropout:
        key = jax.random.PRNGKey(seed)
        bits = np.asarray(jax.random.bits(
            jax.random.fold_in(key, 0), (jh.bcsr.tiles.shape[0], 128, 128),
            jnp.uint32))
        keep_mul = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 1), KEEP,
            (jh.rem.senders.shape[0], heads)).astype(jnp.float32) / KEEP)
    kp = KEEP if dropout else 1.0
    j = dict(x=jnp.asarray(x).reshape(n, heads, feat), fs=jnp.asarray(fs),
             fd=jnp.asarray(fd), m=jnp.asarray(m),
             bits=jnp.asarray(bits if dropout else np.zeros(
                 (jh.bcsr.tiles.shape[0], 1, 1), np.uint32)),
             keep_mul=None if keep_mul is None else jnp.asarray(keep_mul),
             kp=kp)
    t = dict(x=_t(x), fs=_t(fs), fd=_t(fd), m=_t(m),
             bits=None if bits is None else _t(bits),
             keep_mul=None if keep_mul is None else _t(keep_mul), kp=kp)
    return j, t


def _model(mode, th, t, long_edges):
    return parts_walk_model(mode, th, t["x"], t["fs"], t["fd"], t["m"],
                            t["bits"], t["keep_mul"], SLOPE, t["kp"],
                            long_edges)


def _plain(mode, th, t):
    if mode == "rem":
        return k8.rem_attend_plain(th, t["x"], t["fs"], t["fd"], t["m"],
                                   t["keep_mul"], SLOPE)
    return k910.tile_parts_plain(th, t["x"], t["fs"], t["fd"], t["m"],
                                 t["bits"], SLOPE, t["kp"])


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g).reshape(g.shape[0], -1),
                                   np.asarray(w).reshape(g.shape[0], -1),
                                   **FWD_TOL)


CASES = [(md, h, f, d, s) for md in ("rem", "tiles")
         for h, f in ((8, 8), (1, 7), (2, 600))
         for d in (False, True) for s in ("exact", "zero")]


@pytest.mark.parametrize(
    "mode, heads, feat, dropout, shift", CASES,
    ids=[f"{'K8' if md == 'rem' else 'K9'}-{h}x{f}-"
         f"{'dropout' if d else 'plain'}-m_{s}"
         for md, h, f, d, s in CASES])
def test_parts_walk_matches_plain_and_jax(graphs, mode, heads, feat,
                                          dropout, shift):
    """The model, with the graph's own long-row rule and with every row
    above 4 entries split, equals the plain version and JAX's kernel; rows
    without edges in the mode's part get zeros. At 2 x 600 the slab is one
    head in two parts."""
    jh, th = graphs
    j, t = _operands(jh, N, heads, feat, dropout, shift, seed=feat + heads)
    assert (attend_layout(heads, feat, 4).parts > 1) == (feat == 600)
    if mode == "rem":
        k_out = _tpu_kernel(jatt._rem_parts_impl, jh.rem, j["x"], j["fs"],
                            j["fd"], j["m"], j["keep_mul"], SLOPE)
    else:
        k_out = _tpu_kernel(jatt._tile_parts_impl, jh.bcsr, j["bits"],
                            j["x"], j["fs"], j["fd"], j["m"], SLOPE, j["kp"])
    plain = _plain(mode, th, t)
    for long_edges in (LONG_ROW_EDGES, 4):
        got = _model(mode, th, t, long_edges)
        _close(got, plain)
        _close(got, k_out)
    num, den = got
    empty = (th.rem.row_ptr[1:] == th.rem.row_ptr[:-1] if mode == "rem"
             else torch.zeros(N, dtype=torch.bool))
    if mode == "tiles":
        empty[NO_TILE_ROWS] = True
    assert empty.any()
    assert not num[empty].any() and not den[empty].any()
    assert k8.rem_attend.launches == k910.tile_parts.launches == 0


@pytest.fixture(scope="module")
def hub():
    return _hybrids("hub", torch.float32)


@pytest.mark.parametrize("mode", ["rem", "tiles"], ids=["K8", "K9"])
@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("heads, feat", [(2, 8), (1, 600)])
def test_parts_walk_splits_hub_rows(hub, mode, heads, feat, dropout):
    """On the hub fixture (row block 0: 8 dense tiles and ~2,600 remainder
    edges) the model equals the plain version with the graph's own rule
    (K9: the rows of ``long_rows[0]`` split their tile slots over 8 warps;
    K8: no row, since none is long by its remainder) and with every row
    above 4 entries split."""
    jh, th = hub
    j, t = _operands(jh, th.n_nodes, heads, feat, dropout, "exact",
                     seed=heads)
    plain = _plain(mode, th, t)
    for long_edges in (LONG_ROW_EDGES, 4):
        _close(_model(mode, th, t, long_edges), plain)


def _np_rem_long_rows(hg):
    counts = np.diff(hg.rem.row_ptr.numpy())
    return np.flatnonzero(counts > LONG_ROW_EDGES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_rem_long_rows_match_numpy(name, dtype):
    """K8's long rows: the rows whose remainder alone holds more than
    ``LONG_ROW_EDGES`` edges, ascending, int32, built once and kept. On
    the hub fixture every row of ``long_rows[0]`` (123) is long by its tile
    slots and none holds more than 32 remainder edges, so K8 splits none."""
    _, th = _hybrids(name, dtype)
    rows = th.rem_long_rows
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), _np_rem_long_rows(th))
    assert th.rem_long_rows is rows   # kept
    if name == "hub":
        nr = np.diff(th.rem.row_ptr.numpy())
        long_rows = th.long_rows[0].numpy()
        assert long_rows.size == 123
        tile_slots = th.row_edges[0].numpy() - nr
        assert (tile_slots[long_rows] > 0).all()
        assert nr.max() <= 32 and rows.numel() == 0


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_rem_long_rows_split_on_a_hub_without_tiles(dropout):
    """The hub fixture with a ``min_edges_per_tile`` that no tile reaches:
    its hub rows stay in the remainder, so K8's own rule splits them, and
    the model with that rule equals ``rem_attend_plain``."""
    s, r, n = _hub()
    th = tbcsr.build_hybrid(s, r, n, min_edges_per_tile=10 ** 6,
                            device="cpu")
    assert th.bcsr.n_edges == 0
    rows = th.rem_long_rows
    np.testing.assert_array_equal(rows.numpy(), _np_rem_long_rows(th))
    assert rows.numel() > 0
    heads, feat = 2, 8
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(n, heads * feat, generator=gen)
    fs, fd, m = (torch.randn(n, heads, generator=gen) for _ in range(3))
    keep_mul = ((torch.rand(th.rem.n_edge_pad, heads, generator=gen) < KEEP)
                .float() / KEEP if dropout else None)
    t = dict(x=x, fs=fs, fd=fd, m=m, bits=None, keep_mul=keep_mul, kp=1.0)
    _close(_model("rem", th, t, LONG_ROW_EDGES), _plain("rem", th, t))


def _converts(args, argtypes):
    """Each argument converts to its declared ctypes type (a pointer is an
    int or None, an int an int, a float a float)."""
    assert len(args) == len(argtypes)
    for arg, kind in zip(args, argtypes):
        if kind in (ctypes.c_int, ctypes.c_uint32):
            assert isinstance(arg, int), (arg, kind)
        kind(arg)


WIDE = [(8, 256), (4, 512), (2, 600)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads, feat", WIDE,
                         ids=[f"{h}x{f}" for h, f in WIDE])
def test_parts_launch_args_at_wide_heads(graphs, heads, feat, dtype):
    """``rem_attend_args`` and ``tile_parts_args`` without a card: every
    argument converts to its ctypes type; the layout is ``walk_layout`` of
    ``x`` and ``num`` (slabs or parts on the grid, no windows); K8's
    pointers name the remainder, ``keep_mul`` and ``rem_long_rows`` and no
    tile operand; K9's the forward tiles, their row masks, the remainder's
    spans and the forward row lengths and long rows."""
    _, th = graphs
    n = th.n_nodes
    gen = torch.Generator().manual_seed(heads)
    x = torch.randn(n, heads * feat, generator=gen).to(dtype)
    fs, fd, m = (torch.randn(n, heads, generator=gen) for _ in range(3))
    num = torch.empty(n, heads * feat)
    den = torch.empty(n, heads)
    bits = torch.zeros(th.bcsr.tiles.shape, dtype=torch.int32)
    keep_mul = torch.ones(th.rem.n_edge_pad, heads)
    lay = walk_layout(heads, x, num)
    assert lay == attend_layout(heads, feat, x.element_size())
    if feat == 600:
        assert lay.parts == 2 and lay.n_slabs == 2 * heads
    xb = int(dtype == torch.bfloat16)
    bg, rem = th.bcsr, th.rem

    k8_args = k8.rem_attend_args(th, x, fs, fd, m, keep_mul, num, den,
                                 SLOPE, 0)
    _converts(k8_args, k910.PARTS_ENTRIES["gnn_rem_attend"])
    assert k8_args[:11] == [
        x.data_ptr(), fs.data_ptr(), fd.data_ptr(), m.data_ptr(),
        rem.senders.data_ptr(), rem.edge_weight.data_ptr(),
        rem.row_ptr.data_ptr(), keep_mul.data_ptr(),
        th.rem_long_rows.data_ptr(), num.data_ptr(), den.data_ptr()]
    tile_operands = {bg.tiles.data_ptr(), bits.data_ptr(),
                     bg.col_ids.data_ptr(), bg.tile_off.data_ptr(),
                     bg.tile_cnt.data_ptr(), bg.row_masks.data_ptr(),
                     th.row_edges[0].data_ptr(), th.long_rows[0].data_ptr()}
    assert not tile_operands & set(k8_args[:11])
    assert k8_args[11:] == [n, heads, feat, xb, *lay.args(), lay.parts,
                            th.rem_long_rows.numel(), LONG_ROW_EDGES,
                            SLOPE, 1, 0]

    k9_args = k910.tile_parts_args(th, x, fs, fd, m, bits, num, den, SLOPE,
                                   KEEP, 0)
    _converts(k9_args, k910.PARTS_ENTRIES["gnn_tile_parts"])
    assert k9_args[9] == bg.row_masks.data_ptr()
    assert k9_args[10] == rem.row_ptr.data_ptr()
    assert k9_args[11] == th.row_edges[0].data_ptr()
    assert k9_args[12] == th.long_rows[0].data_ptr()
    assert k9_args[13:15] == [num.data_ptr(), den.data_ptr()]
    assert k9_args[15:27] == [n, heads, feat, xb, 0, *lay.args(), lay.parts,
                              th.long_rows[0].numel(), LONG_ROW_EDGES]
    assert k9_args[-2:] == [1, 0]   # dropping, stream
