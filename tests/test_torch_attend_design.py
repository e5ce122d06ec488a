"""The host side and the algebra of the redesigned hybrid attend kernels K4
and K6 (``csrc/attend_walk.cuh``), which run only on the card.

Pinned here:
  * ``attend_layout``, the column layout and slab rule of the walk, at the
    path's shapes and, as a rule, over many widths;
  * ``HybridGraph.row_edges`` and ``long_rows`` (the rows a CTA of their
    own takes) against numpy on the JAX package's tiles and remainders, on
    Cora, the hub fixture and a random graph with empty row blocks, float32
    and bfloat16 tiles, forward and transpose layouts;
  * the walk's algebra: a torch model of the kernel (each row's remainder
    edges then its tile slots, in batches of 32 with the online rescale,
    long rows split over 8 warps and combined in warp order) against
    ``attend_online_plain`` and JAX's ``gat_tiled_attend``, dropout on and
    off, with rows longer and shorter than 32 edges;
  * K6's walk over the parts of a head wider than a warp holds (dx by
    columns, dfs from the parts' q shares) against ``attend_bwd_b_plain``.

Tolerances: as in ``tests/test_torch_attend.py`` (the JAX package's own
for its kernels against its XLA path): the forward's ``rtol=2e-4,
atol=2e-5``, the backward's ``rtol=5e-4, atol=5e-5``; both sides sum in
float32 in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.ops import bcsr_attention as jatt  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core.bcsr import ROW_BLOCK  # noqa: E402
from graphneuralnetwork_tpu_torch.data import load_cora  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import attend_common  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    attend_bwd_kernel as k56, attend_online_kernel as k4)
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import (  # noqa: E402
    NEG, attend_layout, keep_factors, leaky)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=5e-4, atol=5e-5)
SLOPE, KEEP = 0.2, 0.6
WARPS, BATCH = 8, 32   # csrc/attend_common.cuh kWarps; a batch of edges


# --------------------------------------------------------------- layout


@pytest.mark.parametrize("heads, feat, itemsize, want", [
    (8, 8, 4, (4, 1, 16, 8, 1, 1)),       # Cora GAT layer 1, f32
    (8, 8, 2, (8, 1, 8, 8, 1, 1)),        # bf16
    (1, 7, 4, (1, 1, 8, 1, 1, 1)),        # Cora GAT layer 2
    (1, 7, 2, (1, 1, 8, 1, 1, 1)),
    (8, 128, 4, (4, 4, 32, 4, 1, 2)),     # the large shape, f32
    (8, 128, 2, (8, 1, 32, 2, 1, 4)),     # bf16: one vector a lane
    (2, 8, 4, (4, 1, 4, 2, 1, 1)),        # the hub fixture of the tests
    (4, 32, 4, (4, 1, 32, 4, 1, 1)),      # the community fixture
    (1, 1024, 4, (4, 4, 32, 1, 2, 2)),    # a head wider than a warp
    (1, 512, 2, (8, 2, 32, 1, 1, 1)),     # bf16: two vectors hold it
    (32, 1, 4, (1, 1, 8, 8, 1, 4)),       # more heads than a slab
])
def test_attend_layout_at_shapes(heads, feat, itemsize, want):
    lay = attend_layout(heads, feat, itemsize)
    assert (lay.vec, lay.nv, lay.lpe, lay.slab_heads, lay.parts,
            lay.n_slabs) == want


def test_attend_layout_unaligned_rows_take_scalars():
    assert attend_layout(8, 128, 4, aligned=False).vec == 1
    assert attend_layout(8, 8, 2, aligned=False).vec == 1


@pytest.mark.parametrize("itemsize", [4, 2])
def test_attend_layout_rule(itemsize):
    """Vectors of 16 bytes where the head width allows, else scalars; at
    most 16 columns a lane, and four float32 vectors, one bfloat16 vector
    (two for a head wider than 32 of them) or four scalars; a power of two
    of lanes an edge;
    whole heads in a slab (at most 8) unless one head is wider than a
    warp holds, then equal parts; the slabs cover every column once."""
    for heads in (1, 2, 3, 4, 7, 8, 12, 16, 32):
        for feat in (*range(1, 41), 63, 64, 96, 100, 128, 200, 256, 512,
                     513, 1024, 2048):
            lay = attend_layout(heads, feat, itemsize)
            full = 16 // itemsize
            assert lay.vec == (full if feat % full == 0 else 1)
            assert lay.nv in (1, 2, 4) and lay.nv * lay.vec <= 16
            assert lay.lpe in (1, 2, 4, 8, 16, 32)
            assert lay.nv == 1 or lay.lpe == 32
            vph = feat // lay.vec
            group = lay.lpe * lay.nv
            covered = np.zeros(heads * vph, np.int64)
            for sl in range(lay.n_slabs):   # attend_walk.cuh:slab_of
                if lay.parts == 1:
                    h0 = sl * lay.slab_heads
                    hs = min(lay.slab_heads, heads - h0)
                    v0, v1 = h0 * vph, (h0 + hs) * vph
                    assert 1 <= hs <= attend_common.SLAB_HEADS
                else:
                    per = -(-vph // lay.parts)
                    h0, part = divmod(sl, lay.parts)
                    v0 = h0 * vph + part * per
                    v1 = min(v0 + per, (h0 + 1) * vph)
                    assert lay.slab_heads == 1
                assert 0 < v1 - v0 <= group
                covered[v0:v1] += 1
            assert (covered == 1).all(), (heads, feat)
            # the fewest lanes an edge, and the fewest vectors a lane
            if lay.nv == 1 and lay.lpe > 1:
                widest = (lay.slab_heads * vph if lay.parts == 1
                          else -(-vph // lay.parts))
                assert lay.lpe // 2 < widest
            # a slab takes as many heads as fit (up to 8)
            vecs = (attend_common.VECS_PER_LANE[itemsize] if lay.vec > 1
                    else attend_common.MAX_VECS_PER_LANE)
            if vph > 32 * vecs:   # a wide head: up to 16 columns a lane
                vecs = min(4, 16 // lay.vec)
            assert lay.nv <= vecs
            if lay.parts == 1 and lay.slab_heads < min(heads, 8):
                assert (lay.slab_heads + 1) * vph > 32 * min(vecs,
                                                             16 // lay.vec)


# ------------------------------------------------------ row edges, long rows


def _community(seed, n=512, e=8192, comm=64):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    base = (s // comm) * comm
    r = np.where(intra, np.minimum(base + rng.integers(0, comm, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32), n


def _hub(n=4096):
    """The hub fixture of ``tests/test_torch_attend.py``: row block 0 has 8
    dense tiles and ~2,600 remainder edges, so its rows hold 30-60 edges."""
    rng = np.random.default_rng(1)
    dense_s = np.concatenate([cb * 128 + rng.integers(0, 128, 256)
                              for cb in range(1, 9)])
    bg_r = np.repeat(np.arange(n), 4)
    s = np.concatenate([dense_s, rng.integers(0, n, 3000),
                        rng.integers(0, n, bg_r.shape[0])]).astype(np.int32)
    r = np.concatenate([rng.integers(0, 128, dense_s.shape[0]),
                        rng.integers(0, 128, 3000), bg_r]).astype(np.int32)
    return s, r, n


def _sparse_blocks():
    """1,000 nodes whose row blocks 1-4 and 6 receive no edge at all and
    whose row block 0 has one dense tile (the rest stays remainder): empty
    row blocks and empty rows."""
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.arange(0, 128), np.arange(640, 768),
                           np.arange(896, 1000)])
    r = rng.choice(rows, 3000)
    s = rng.integers(0, 1000, 3000)
    ds = rng.integers(128, 256, 400)
    dr = rng.integers(0, 128, 400)
    return (np.concatenate([s, ds]).astype(np.int32),
            np.concatenate([r, dr]).astype(np.int32), 1000)


GRAPHS = {"community": lambda: (*_community(0), 48),
          "hub": lambda: (*_hub(), 192),
          "sparse_blocks": lambda: (*_sparse_blocks(), 192)}


def _hybrids(name, dtype):
    s, r, n, fill = GRAPHS[name]()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (jbcsr.build_hybrid(s, r, n, min_edges_per_tile=fill, dtype=jdt),
            tbcsr.build_hybrid(s, r, n, min_edges_per_tile=fill, dtype=dtype,
                               device="cpu"))


def _np_row_edges(bg, rem, n):
    """Per row: the nonzero slots of its tile rows plus its remainder's
    real edges, from the JAX package's arrays."""
    tiles = np.asarray(bg.tiles.astype(jnp.float32))
    rows = (np.asarray(bg.row_ids)[:, None] * ROW_BLOCK
            + np.arange(ROW_BLOCK)).ravel()
    counts = np.zeros(int(bg.n_node_pad), np.int64)
    np.add.at(counts, rows, (tiles != 0).sum(-1).ravel())
    recv = np.asarray(rem.receivers)[:rem.n_edges]
    return counts[:n] + np.bincount(recv, minlength=n)[:n]


def _np_popcounts(bg):
    """Per row: the set bits of its tile rows' masks (what the kernels
    walk), by numpy."""
    words = bg.row_masks.numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> np.arange(32)) & 1
    per_row = bits.reshape(bg.n_tiles, ROW_BLOCK, -1).sum(-1)
    rows = (bg.row_ids.numpy()[:, None] * ROW_BLOCK
            + np.arange(ROW_BLOCK)).ravel()
    counts = np.zeros(bg.n_node_pad, np.int64)
    np.add.at(counts, rows, per_row.ravel())
    return counts[:bg.n_nodes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_row_edges_and_long_rows_match_numpy(name, dtype):
    jh, th = _hybrids(name, dtype)
    n = th.n_nodes
    for transpose, (jbg, jrem), (tbg, trem) in (
            (False, (jh.bcsr, jh.rem), (th.bcsr, th.rem)),
            (True, (jh.bcsr_t, jh.rem_t), (th.bcsr_t, th.rem_t))):
        want = _np_row_edges(jbg, jrem, n)
        got = th.row_edges[int(transpose)]
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        rem_deg = np.diff(trem.row_ptr.numpy())
        np.testing.assert_array_equal(want, _np_popcounts(tbg) + rem_deg)
        rows = th.long_rows[int(transpose)]
        assert rows.dtype == torch.int32
        np.testing.assert_array_equal(
            rows.numpy(), np.flatnonzero(want > tbcsr.LONG_ROW_EDGES))
        assert th.long_rows[int(transpose)] is rows   # kept
    if name == "hub":   # rows both above and below one batch
        counts = th.row_edges[0].numpy()
        assert counts.max() > BATCH and (counts <= BATCH).sum() > 1000
        assert th.long_rows[0].numel() > 0
    if name == "sparse_blocks":
        assert (th.bcsr.tile_cnt == 0).any() and (th.row_edges[0] == 0).any()


def test_row_edges_on_cora():
    hg = load_cora(seed=0, layout="auto", layout_objective="attention",
                   device="cpu", model="gat").graph
    for transpose, bg, rem in ((0, hg.bcsr, hg.rem), (1, hg.bcsr_t,
                                                      hg.rem_t)):
        want = _np_popcounts(bg) + np.diff(rem.row_ptr.numpy())
        np.testing.assert_array_equal(hg.row_edges[transpose].numpy(), want)
        assert int(want.sum()) == hg.n_edges
    # no Cora row reaches the threshold: no CTA of its own
    assert attend_common.LONG_ROW_EDGES == tbcsr.LONG_ROW_EDGES == 32
    assert hg.long_rows[0].numel() == 0 and hg.long_rows[1].numel() == 0


# ------------------------------------------------------------ the algebra


def _stream(hg, bits, keep_mul, heads, keep_prob):
    """Every edge of the forward layout with its row and its place in the
    row's stream: the remainder edges in order, then the tile slots by
    tile and column, as the kernel walks them."""
    n = hg.n_nodes
    rem = hg.rem
    e = rem.n_edges
    r_recv = rem.receivers[:e].long()
    r_pos = torch.arange(e) - rem.row_ptr[:-1].long()[r_recv]
    nr = (rem.row_ptr[1:] - rem.row_ptr[:-1]).long()
    t, i, j, t_recv, t_send, t_w = attend_common.tile_slots(hg.bcsr)
    order = torch.sort(t_recv, stable=True).indices   # by row, then t, j
    t, i, j = t[order], i[order], j[order]
    t_recv, t_send, t_w = t_recv[order], t_send[order], t_w[order]
    first = torch.zeros(n + 1, dtype=torch.long)
    first[1:] = torch.bincount(t_recv, minlength=n).cumsum(0)
    t_pos = nr[t_recv] + torch.arange(t_recv.numel()) - first[t_recv]
    recv = torch.cat([r_recv, t_recv])
    send = torch.cat([rem.senders[:e].long(), t_send])
    w = torch.cat([rem.edge_weight[:e], t_w])
    live = torch.cat([rem.edge_weight[:e] > 0, t_w != 0])
    pos = torch.cat([r_pos, t_pos])
    keep = None
    if keep_prob < 1.0:
        keep = torch.cat([keep_mul[:e],
                          keep_factors(bits[t, i, j], heads, keep_prob)])
    return recv, send, w, live, pos, keep


def walk_model(hg, x, f_src, f_dst, bits, keep_mul, slope, keep_prob,
               long_edges):
    """The kernel's arithmetic in torch: rows with more than
    ``long_edges`` edges split into 8 contiguous shares (one a warp); each
    warp walks its share in batches of 32 with the online rescale (batch
    max over the live edges, m <- max(m, batch max), den and num scaled by
    exp(m_old - m_new)); the warps combine in warp order. Returns (out,
    den, m) as ``attend_online``."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    recv, send, w, live, pos, keep = _stream(hg, bits, keep_mul, heads,
                                             keep_prob)
    length = torch.bincount(recv, minlength=n)
    split = length > long_edges
    share = torch.where(split, -(-length // WARPS), length.clamp_min(1))
    warp = pos // share[recv]
    batch = (pos - warp * share[recv]) // BATCH
    slot = recv * WARPS + warp                        # one (row, warp)
    m = torch.full((n * WARPS, heads), NEG)
    den = torch.zeros(n * WARPS, heads)
    num = torch.zeros(n * WARPS, heads, feat)
    score = leaky(f_dst[recv] + f_src[send], slope)
    xs = x[send].float().view(-1, heads, feat)
    for b in range(int(batch.max()) + 1 if batch.numel() else 0):
        sel = batch == b
        idx = slot[sel]
        bmax = torch.full_like(m, NEG).scatter_reduce_(
            0, idx[:, None].expand(-1, heads),
            torch.where(live[sel, None], score[sel], NEG), "amax")
        m_new = torch.maximum(m, bmax)
        scale = torch.exp(m - m_new)
        p = w[sel, None] * torch.exp(torch.clamp_max(
            score[sel] - m_new[idx], 0.0))
        pn = p if keep is None else p * keep[sel]
        den = (den * scale).index_add_(0, idx, p)
        num = (num * scale[..., None]).index_add_(0, idx,
                                                  pn[..., None] * xs[sel])
        m = m_new
    m, den, num = (m.view(n, WARPS, heads), den.view(n, WARPS, heads),
                   num.view(n, WARPS, heads, feat))
    m_row = m.max(1).values
    out_num = torch.zeros(n, heads, feat)
    den_row = torch.zeros(n, heads)
    for q in range(WARPS):   # warp order
        sc = torch.exp(m[:, q] - m_row)
        den_row += den[:, q] * sc
        out_num += num[:, q] * sc[..., None]
    out = out_num / den_row.clamp_min(1e-16)[..., None]
    return out.reshape(n, hf), den_row, m_row


def _operands(n, heads, feat, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, heads, feat)).astype(np.float32),
            rng.normal(size=(n, heads)).astype(np.float32),
            rng.normal(size=(n, heads)).astype(np.float32))


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("long_edges", [32, 10 ** 6],
                         ids=["split", "unsplit"])
@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("name", ["hub", "community"])
def test_walk_algebra_matches_plain_and_jax(name, dropout, long_edges):
    """Rows of the hub fixture hold up to ~60 edges (two batches, or eight
    shares when split); the community fixture's rows are shorter than a
    batch. The model equals ``attend_online_plain`` (out, den and the exact
    shift m) and JAX's ``gat_tiled_attend``."""
    jh, th = _hybrids(name, torch.float32)
    n = th.n_nodes
    heads, feat = (2, 8) if name == "hub" else (4, 32)
    x, fs, fd = _operands(n, heads, feat, seed=3)
    if name == "hub":
        assert int(th.row_edges[0].max()) > BATCH
    bits = keep_mul = None
    keep_prob = 1.0
    kw = {}
    if dropout:
        rng = jax.random.PRNGKey(9)
        jbits = jax.random.bits(jax.random.fold_in(rng, 0),
                                (jh.bcsr.tiles.shape[0], 128, 128),
                                jnp.uint32)
        jkeep = jax.random.bernoulli(jax.random.fold_in(rng, 1), KEEP,
                                     (jh.rem.senders.shape[0], heads))
        bits = _t(jbits)
        keep_mul = _t(np.asarray(jkeep.astype(jnp.float32) / KEEP))
        keep_prob = KEEP
        kw = dict(attn_dropout=1 - KEEP, dropout_rng=rng)
    xt = _t(x).reshape(n, -1)
    args = (th, xt, _t(fs), _t(fd), bits, keep_mul, SLOPE, keep_prob)
    out, den, m = walk_model(*args, long_edges=long_edges)
    r_out, r_den, r_m = k4.attend_online_plain(*args)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), r_den.numpy(), **FWD_TOL)
    np.testing.assert_array_equal(m.numpy(), r_m.numpy())   # exact max
    ref = jatt.gat_tiled_attend(jh, jnp.asarray(x), jnp.asarray(fs),
                                jnp.asarray(fd), **kw)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref).reshape(n, -1), **FWD_TOL)


def test_walk_algebra_bf16_tiles_and_empty_rows():
    """bfloat16 tiles and a graph with empty row blocks: empty rows get
    out = 0, den = 0 and m = NEG, as in the plain version."""
    _, th = _hybrids("sparse_blocks", torch.bfloat16)
    n = th.n_nodes
    x, fs, fd = _operands(n, 2, 8, seed=4)
    args = (th, _t(x).reshape(n, -1), _t(fs), _t(fd), None, None, SLOPE,
            1.0)
    out, den, m = walk_model(*args, long_edges=4)
    r_out, r_den, r_m = k4.attend_online_plain(*args)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), r_den.numpy(), **FWD_TOL)
    np.testing.assert_array_equal(m.numpy(), r_m.numpy())
    empty = th.row_edges[0] == 0
    assert empty.any()
    assert (out[empty] == 0).all() and (den[empty] == 0).all()
    assert (m[empty] == NEG).all()


def bwd_b_parts_model(hg, x, gn, f_src, fdm3, bits, keep_mul, slope,
                      keep_prob):
    """K6's arithmetic for a head split into parts (``attend_layout``'s
    ``parts > 1``): the row's warp walks the parts in turn; each part
    writes its columns of dx and adds its q shares (``gn_r . x_s`` over its
    columns, times p * keep * leaky') to dfs, and the first part also the
    dden term. Returns (dx, dfs) as ``attend_bwd_b``."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    lay = attend_layout(heads, feat, x.element_size())
    assert lay.parts > 1 and lay.slab_heads == 1
    send, recv, w, keep = k56._transpose_edges(hg, bits, keep_mul, heads,
                                               keep_prob)
    fd, m, dden = (fdm3[:, :heads], fdm3[:, heads:2 * heads],
                   fdm3[:, 2 * heads:])
    pre = fd[recv] + f_src[send]
    p = w[:, None] * torch.exp(torch.clamp_max(leaky(pre, slope) - m[recv],
                                               0.0))
    pk = p if keep is None else p * keep
    pa = pk * attend_common.leaky_grad(pre, slope)
    gr = gn[recv].float().view(-1, heads, feat)
    xs = x[send].float().view(-1, heads, feat)
    dx = torch.zeros(n, heads, feat)
    dfs = torch.zeros(n, heads)
    vph, per = feat // lay.vec, -(-(feat // lay.vec) // lay.parts)
    for part in range(lay.parts):   # attend_walk.cuh:slab_of, in order
        c0, c1 = part * per * lay.vec, min((part + 1) * per, vph) * lay.vec
        dx[:, :, c0:c1].index_add_(0, send, pk[..., None] * gr[..., c0:c1])
        q = (gr[..., c0:c1] * xs[..., c0:c1]).sum(-1)
        term = pa * q
        if part == 0:
            term = term + p * attend_common.leaky_grad(pre, slope) * \
                dden[recv]
        dfs.index_add_(0, send, term)
    return dx.reshape(n, hf).to(x.dtype), dfs


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("feat", [600, 251])
def test_bwd_b_parts_algebra_matches_plain(feat, dropout):
    """K6 at one head wider than a warp holds (600 float32 features: two
    parts of 16-byte vectors; 251: two unequal parts of scalars), on the
    hub fixture reversed, whose hub rows are K6's long (split) rows: the
    parts' dx columns and summed q shares equal ``attend_bwd_b_plain``."""
    s, r, n = _hub()
    th = tbcsr.build_hybrid(r, s, n, min_edges_per_tile=192, device="cpu")
    assert th.long_rows[1].numel() > 0
    rng = np.random.default_rng(6)
    x, gn = (torch.from_numpy(rng.normal(size=(n, feat)).astype(np.float32))
             for _ in range(2))
    fs, fd, m, dden = (torch.from_numpy(
        rng.normal(size=(n, 1)).astype(np.float32)) for _ in range(4))
    fdm3 = torch.cat([fd, m.abs() + 2.0, dden], 1)
    bits = keep_mul = None
    keep_prob = 1.0
    if dropout:
        gen = torch.Generator().manual_seed(2)
        keep_prob = KEEP
        bits = torch.randint(-2 ** 31, 2 ** 31 - 1, th.bcsr.tiles.shape,
                             generator=gen, dtype=torch.int32)
        keep_mul = (torch.rand(th.rem.n_edge_pad, 1, generator=gen)
                    < KEEP).float() / KEEP
    args = (th, x, gn, fs, fdm3, bits, keep_mul, SLOPE, keep_prob)
    dx, dfs = bwd_b_parts_model(*args)
    r_dx, r_dfs = k56.attend_bwd_b_plain(*args)
    np.testing.assert_allclose(dx.numpy(), r_dx.numpy(), **BWD_TOL)
    np.testing.assert_allclose(dfs.numpy(), r_dfs.numpy(), **BWD_TOL)


def test_layout_of_the_wrappers_operands():
    """``walk_layout`` reads the operands' addresses: a row operand at an
    address that is not a multiple of 16 bytes takes scalar loads."""
    x = torch.zeros(16, 8 * 8 + 1)[:, 1:]   # rows 4 bytes off 16
    assert x.data_ptr() % 16 != 0
    lay = attend_common.walk_layout(8, x.contiguous())
    assert lay.vec == 4
    assert attend_common.walk_layout(8, torch.zeros(16, 64),
                                     x).vec == 1
    assert dataclasses.asdict(lay) == dataclasses.asdict(
        attend_layout(8, 8, 4))
