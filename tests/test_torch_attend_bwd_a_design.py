"""Pass A of the hybrid GAT gradient (K5) on the row walk of
``csrc/attend_walk.cuh``, which runs only on the card, and the per-head
width limit that K5 and K8-K10 had on the card.

Pinned here:
  * the new K5's algebra: a torch model of the kernel (each receiver row's
    remainder edges then its tile slots, in batches of 32; rows above the
    long-row threshold split into 8 warps' shares that add in warp order;
    a head wider than a warp holds walked part by part; per (row, head)
    ``dfd = dden * sum p * leaky' + gn_r . sum p * keep * leaky' * x_s``)
    against ``attend_bwd_a_plain`` and JAX's ``attend_bwd_a_pallas`` in TPU
    interpret mode, on the hub and community fixtures of
    ``tests/test_torch_attend_design.py``, dropout on and off, with and
    without split rows, at one head of 600, 251 and 301 features (two parts
    of 16-byte vectors, one part of eight scalars a lane, two parts of
    eight), and on bfloat16 tiles with empty rows;
  * K5's column layout: a head of scalars takes up to eight a lane before
    it splits into parts (``WIDE_SCALARS_PER_LANE``), where K4 and K6 take
    four; every other layout is theirs;
  * the launch arguments of K5 (``bwd_a_args``), K8 (``rem_attend_args``),
    K9 (``tile_parts_args``) and K10 (``attend_fused_args``), built without
    a card at 8x256, 4x512 and 2x600, heads wider than a lane group of 32
    columns a lane holds, where the host once raised: each on the walk's
    layout (K5's own for a head of scalars); each argument converts to its
    ctypes type;
  * the port's plain K5 and K8-K10 at 8x256 against JAX's kernels in TPU
    interpret mode.

Tolerances: as in ``tests/test_torch_attend_design.py`` (the JAX package's
own for its kernels against its XLA path): backward ``rtol=5e-4,
atol=5e-5`` (K5), forward ``rtol=2e-4, atol=2e-5`` (K8-K10's partials);
both sides sum in float32 in other orders.
"""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.ops import bcsr_attention as jatt  # noqa: E402
from graphneuralnetwork_tpu.ops.pallas.attend_bwd_kernel import (  # noqa: E402
    attend_bwd_a_pallas)
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    attend_bwd_kernel as k56, attend_parts_kernel as k910,
    rem_attend_kernel as k8)
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import (  # noqa: E402
    MAX_VECS_PER_LANE, WIDE_SCALARS_PER_LANE, attend_layout, leaky,
    leaky_grad)
from test_torch_attend_design import (  # noqa: E402
    BATCH, WARPS, _hybrids, _stream)
from test_torch_attend_parts import (  # noqa: E402, F401 (graphs: a fixture)
    N, NO_TILE_ROWS, _jax_shift, _tpu_kernel, _t, graphs)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=5e-4, atol=5e-5)
SLOPE, KEEP = 0.2, 0.6


def k5_layout(heads, feat, itemsize):
    """K5's column layout (``bwd_a_args``)."""
    return attend_layout(heads, feat, itemsize,
                         wide_scalars=WIDE_SCALARS_PER_LANE)


# ---------------------------------------------------------- the layout


@pytest.mark.parametrize("heads, feat, itemsize, want", [
    (1, 251, 4, (1, 8, 32, 1, 1, 1)),     # one part of eight scalars
    (1, 251, 2, (1, 8, 32, 1, 1, 1)),
    (1, 256, 4, (4, 2, 32, 1, 1, 1)),     # vectors: K4's and K6's layout
    (1, 301, 4, (1, 8, 32, 1, 2, 2)),     # two parts of eight scalars
    (1, 301, 2, (1, 8, 32, 1, 2, 2)),
    (1, 600, 4, (4, 4, 32, 1, 2, 2)),
    (3, 42, 4, (1, 4, 32, 3, 1, 1)),      # whole heads: four scalars
])
def test_k5_layout_at_shapes(heads, feat, itemsize, want):
    lay = k5_layout(heads, feat, itemsize)
    assert (lay.vec, lay.nv, lay.lpe, lay.slab_heads, lay.parts,
            lay.n_slabs) == want


@pytest.mark.parametrize("itemsize", [4, 2])
def test_k5_layout_differs_only_for_wide_scalar_heads(itemsize):
    """K5's layout is K4's and K6's except for a head wider than four
    scalars a lane cover (128): there up to eight a lane, in one part up to
    256 columns and in fewer, equal parts beyond, each of at most 256."""
    for heads in (1, 2, 3, 8, 16):
        for feat in (*range(1, 41), 63, 100, 127, 129, 200, 251, 255, 256,
                     257, 301, 511, 513, 600, 1024, 1025):
            lay = k5_layout(heads, feat, itemsize)
            base = attend_layout(heads, feat, itemsize)
            if lay.vec > 1 or feat <= 32 * MAX_VECS_PER_LANE:
                assert lay == base, (heads, feat)
                continue
            assert (lay.nv, lay.lpe, lay.slab_heads) == (8, 32, 1)
            assert lay.parts == -(-feat // 256) <= base.parts
            assert -(-feat // lay.parts) <= 32 * lay.nv
            assert lay.n_slabs == heads * lay.parts


# ------------------------------------------------------------ the walk



def bwd_a_walk_model(hg, x, gn, f_src, fdm3, bits, keep_mul, slope,
                     keep_prob, long_edges):
    """K5's arithmetic in torch: rows with more than ``long_edges`` edges
    split into 8 contiguous shares (one a warp), the others on one warp;
    each warp walks its share in batches of 32, per part of the slab
    (``k5_layout``; one part unless a head is wider than a warp holds), accumulating ``acc = sum pa * x_s`` over the part's columns
    (``pa = p * keep * leaky'``) and then its share ``gn_r . acc``; the
    first part adds ``dden * sum p * leaky'``; the warps' partials add in
    warp order. Returns dfd [N, H] as ``attend_bwd_a``."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    lay = k5_layout(heads, feat, x.element_size())
    recv, send, w, _, pos, keep = _stream(hg, bits, keep_mul, heads,
                                          keep_prob)
    length = torch.bincount(recv, minlength=n)
    split = length > long_edges
    share = torch.where(split, -(-length // WARPS), length.clamp_min(1))
    warp = pos // share[recv]
    batch = (pos - warp * share[recv]) // BATCH
    slot = recv * WARPS + warp                        # one (row, warp)
    fd, m, dden = (fdm3[:, :heads], fdm3[:, heads:2 * heads],
                   fdm3[:, 2 * heads:])
    pre = fd[recv] + f_src[send]
    p = w[:, None] * torch.exp(torch.clamp_max(leaky(pre, slope) - m[recv],
                                               0.0))
    lg = leaky_grad(pre, slope)
    pa = p * lg if keep is None else p * keep * lg
    xs = x[send].float().view(-1, heads, feat)
    own = gn.float().view(n, heads, feat).repeat_interleave(WARPS, 0)
    plg = torch.zeros(n * WARPS, heads).index_add_(0, slot, p * lg)
    dfd_w = plg * dden.repeat_interleave(WARPS, 0)   # the first part's
    vph = feat // lay.vec
    per = -(-vph // lay.parts)
    for part in range(lay.parts):   # attend_walk.cuh:slab_of, in order
        c0, c1 = part * per * lay.vec, min((part + 1) * per, vph) * lay.vec
        acc = torch.zeros(n * WARPS, heads, c1 - c0)
        for b in range(int(batch.max()) + 1 if batch.numel() else 0):
            sel = batch == b
            acc.index_add_(0, slot[sel],
                           pa[sel, :, None] * xs[sel, :, c0:c1])
        dfd_w = dfd_w + (acc * own[..., c0:c1]).sum(-1)
    dfd_w = dfd_w.view(n, WARPS, heads)
    dfd = torch.zeros(n, heads)
    for q in range(WARPS):   # warp order
        dfd += dfd_w[:, q]
    return dfd


def _jax_bwd_a(jh, x, gn, fs, fdm3, bits, keep_mul, keep_prob):
    """``attend_bwd_a_pallas`` in TPU interpret mode on the given operands
    (numpy), set up as ``_attend_bwd_kernels`` sets it up."""
    bg, rem = jh.bcsr, jh.rem
    n, hf = x.shape
    heads = fs.shape[1]
    n_pad = bg.n_node_pad
    x, gn, fs = jnp.asarray(x), jnp.asarray(gn), jnp.asarray(fs)
    dropping = keep_prob < 1.0
    dfd = _tpu_kernel(functools.partial(
        attend_bwd_a_pallas, keep_prob=keep_prob, has_keep=dropping),
        bg.tile_off, bg.tile_cnt, bg.col_ids, jh.rem_fine_off,
        jh.rem_fine_cnt, bg.tiles,
        jnp.asarray(bits) if dropping else None,
        jatt._pad_rows(x, n_pad), jatt._pad_rows(fs, n_pad).T,
        jatt._pad_rows(gn, n_pad), jatt._pad_rows(jnp.asarray(fdm3), n_pad),
        rem.receivers.reshape(-1, 1), x[rem.senders], fs[rem.senders],
        (rem.edge_weight * rem.edge_mask).astype(jnp.float32).reshape(-1, 1),
        jnp.asarray(keep_mul) if dropping else None, heads, hf // heads, n,
        bg.max_tiles, jh.rem_fine_max, SLOPE, jbcsr.ATTEND_CHUNK)
    return np.asarray(dfd[:n])


@functools.lru_cache(maxsize=None)
def _walk_case(name, heads, feat, dropout, tile_dtype="float32"):
    """One graph of ``test_torch_attend_design.GRAPHS`` with random
    operands of the given width (``fdm3``'s shift positive, as the
    forward's exact shift is on the graph's scale), the JAX-drawn masks
    under dropout, and JAX's pass A on them: (the port's ``attend_bwd_a`` arguments, JAX's dfd)."""
    dtype = getattr(torch, tile_dtype)
    jh, th = _hybrids(name, dtype)
    n = th.n_nodes
    rng = np.random.default_rng(heads * 1000 + feat)
    x, gn = (rng.normal(size=(n, heads * feat)).astype(np.float32)
             for _ in range(2))
    fs, fd, m, dden = (rng.normal(size=(n, heads)).astype(np.float32)
                       for _ in range(4))
    fdm3 = np.concatenate([fd, np.abs(m) + 2.0, dden], 1)
    bits = keep_mul = None
    keep_prob = 1.0
    if dropout:
        key = jax.random.PRNGKey(11)
        bits = np.asarray(jax.random.bits(
            jax.random.fold_in(key, 0), (jh.bcsr.tiles.shape[0], 128, 128),
            jnp.uint32))
        keep_mul = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 1), KEEP,
            (jh.rem.senders.shape[0], heads)).astype(jnp.float32) / KEEP)
        keep_prob = KEEP
    ref = _jax_bwd_a(jh, x, gn, fs, fdm3, bits, keep_mul, keep_prob)
    args = (th, _t(x), _t(gn), _t(fs), _t(fdm3),
            None if bits is None else _t(bits),
            None if keep_mul is None else _t(keep_mul), SLOPE, keep_prob)
    return args, ref


#: (graph, heads, feat, dropout): both fixtures with dropout off and on;
#: one head at 600 features (float32: two parts of 16-byte vectors) with
#: dropout, at 251 (one part of eight scalars a lane) without, at 301 (two
#: unequal parts of eight scalars a lane) with
WALK_CASES = [("hub", 2, 8, False), ("hub", 2, 8, True),
              ("community", 4, 32, False), ("community", 4, 32, True),
              ("hub", 1, 600, True), ("hub", 1, 251, False),
              ("hub", 1, 301, True)]


@pytest.mark.parametrize("long_edges", [32, 10 ** 6],
                         ids=["split", "unsplit"])
@pytest.mark.parametrize(
    "name, heads, feat, dropout", WALK_CASES,
    ids=[f"{g}-{h}x{f}-{'dropout' if d else 'plain'}"
         for g, h, f, d in WALK_CASES])
def test_bwd_a_walk_matches_plain_and_jax(name, heads, feat, dropout,
                                          long_edges):
    """The hub fixture's rows hold up to ~60 edges (two batches, or eight
    shares when split), the community fixture's fewer than a batch; at one
    head of 600 or 301 features the row's warp walks two parts in turn.
    The model equals ``attend_bwd_a_plain`` and JAX's pass A."""
    args, ref = _walk_case(name, heads, feat, dropout)
    hg = args[0]
    assert (k5_layout(heads, feat, 4).parts > 1) == (feat in (600, 301))
    if name == "hub":
        assert int(hg.row_edges[0].max()) > BATCH
        assert hg.long_rows[0].numel() > 0   # split at 32 edges
    dfd = bwd_a_walk_model(*args, long_edges=long_edges)
    plain = k56.attend_bwd_a_plain(*args)
    np.testing.assert_allclose(dfd.numpy(), plain.numpy(), **BWD_TOL)
    np.testing.assert_allclose(dfd.numpy(), ref, **BWD_TOL)
    np.testing.assert_allclose(plain.numpy(), ref, **BWD_TOL)
    assert k56.attend_bwd_a.launches == 0


def test_bwd_a_walk_bf16_tiles_and_empty_rows():
    """bfloat16 tiles and a graph with empty row blocks: empty rows get
    dfd = 0, as in the plain version and JAX's pass A."""
    args, ref = _walk_case("sparse_blocks", 2, 8, False, "bfloat16")
    hg = args[0]
    assert hg.bcsr.tiles.dtype == torch.bfloat16
    dfd = bwd_a_walk_model(*args, long_edges=4)
    plain = k56.attend_bwd_a_plain(*args)
    np.testing.assert_allclose(dfd.numpy(), plain.numpy(), **BWD_TOL)
    np.testing.assert_allclose(dfd.numpy(), ref, **BWD_TOL)
    empty = hg.row_edges[0] == 0
    assert empty.any() and (dfd[empty] == 0).all()
    assert (plain[empty] == 0).all()


# ---------------------------------------------- the launch arguments


WIDE = [(8, 256), (4, 512), (2, 600)]


def _wide_operands(th, heads, feat, dtype):
    gen = torch.Generator().manual_seed(heads)
    n = th.n_nodes
    x, gn = (torch.randn(n, heads * feat, generator=gen).to(dtype)
             for _ in range(2))
    fs, fd, m = (torch.randn(n, heads, generator=gen) for _ in range(3))
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, th.bcsr.tiles.shape,
                         generator=gen, dtype=torch.int32)
    keep_mul = (torch.rand(th.rem.n_edge_pad, heads, generator=gen)
                < KEEP).float() / KEEP
    return x, gn, fs, fd, m, bits, keep_mul


def _converts(args, argtypes):
    """Each argument converts to its declared ctypes type (a pointer is an
    int or None, an int an int, a float a float)."""
    assert len(args) == len(argtypes)
    for arg, kind in zip(args, argtypes):
        if kind in (ctypes.c_int, ctypes.c_uint32):
            assert isinstance(arg, int), (arg, kind)
        kind(arg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads, feat", WIDE,
                         ids=[f"{h}x{f}" for h, f in WIDE])
def test_launch_args_at_wide_heads(graphs, heads, feat, dtype):
    """The host side of K5, K8, K9 and K10 builds its launch arguments at
    heads wider than a lane group of 32 columns a lane holds (where the
    host once raised): all four take the walk's layout, slabs of whole
    heads or a head's parts on the grid, with no windows."""
    th = graphs[1]
    n = th.n_nodes
    x, gn, fs, fd, m, bits, keep_mul = _wide_operands(th, heads, feat, dtype)
    group = 32 // (1 << (heads - 1).bit_length())
    assert group * 32 < feat
    num = torch.empty(n, heads * feat)
    den = torch.empty(n, heads)
    fdm3 = torch.cat([fd, m, fs], 1)
    k5 = k56.bwd_a_args(th, x, gn, fs, fdm3, bits, keep_mul, den, SLOPE,
                        KEEP, 0)
    _converts(k5, k56._ENTRIES["gnn_attend_bwd_a"])
    lay = k5_layout(heads, feat, x.element_size())
    assert k5[17:29] == [n, heads, feat, int(dtype == torch.bfloat16), 0,
                         *lay.args(), lay.parts, th.long_rows[0].numel(),
                         32]
    k10 = k910.attend_fused_args(th, x, fs, fd, m, num, den, bits, num, den,
                                 SLOPE, KEEP, 0)
    _converts(k10, k910.FUSED_ENTRIES["gnn_attend_fused"])
    lay = attend_layout(heads, feat, x.element_size())
    assert k10[17:29] == [n, heads, feat, int(dtype == torch.bfloat16), 0,
                          *lay.args(), lay.parts, th.long_rows[0].numel(),
                          32]
    k8_args = k8.rem_attend_args(th, x, fs, fd, m, keep_mul, num, den,
                                 SLOPE, 0)
    _converts(k8_args, k910.PARTS_ENTRIES["gnn_rem_attend"])
    assert k8_args[11:22] == [n, heads, feat, int(dtype == torch.bfloat16),
                              *lay.args(), lay.parts,
                              th.rem_long_rows.numel(), 32]
    k9_args = k910.tile_parts_args(th, x, fs, fd, m, bits, num, den, SLOPE,
                                   KEEP, 0)
    _converts(k9_args, k910.PARTS_ENTRIES["gnn_tile_parts"])
    assert k9_args[15:27] == [n, heads, feat, int(dtype == torch.bfloat16),
                              0, *lay.args(), lay.parts,
                              th.long_rows[0].numel(), 32]
    for args in (k8_args, k9_args):
        assert args[-1] == 0 and args[-2] == 1   # stream, dropping


# ------------------------------------- JAX against the port at 8 x 256


def _wide_case(graphs, heads, feat, dropout):
    """Operands at ``heads x feat`` on the three-pass fixture for both
    packages: (jax dict, port dict)."""
    jh, _ = graphs
    rng = np.random.default_rng(feat)
    x = rng.normal(size=(N, heads * feat)).astype(np.float32)
    fs, fd = (rng.normal(size=(N, heads)).astype(np.float32)
              for _ in range(2))
    m = _jax_shift(jh, fs, fd)
    bits = keep_mul = None
    if dropout:
        key = jax.random.PRNGKey(17)
        bits = np.asarray(jax.random.bits(
            jax.random.fold_in(key, 0), (jh.bcsr.tiles.shape[0], 128, 128),
            jnp.uint32))
        keep_mul = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 1), KEEP,
            (jh.rem.senders.shape[0], heads)).astype(jnp.float32) / KEEP)
    kp = KEEP if dropout else 1.0
    j = dict(x=jnp.asarray(x).reshape(N, heads, feat), fs=jnp.asarray(fs),
             fd=jnp.asarray(fd), m=jnp.asarray(m),
             bits=jnp.asarray(bits if dropout else np.zeros(
                 (jh.bcsr.tiles.shape[0], 1, 1), np.uint32)),
             keep_mul=None if keep_mul is None else jnp.asarray(keep_mul),
             kp=kp)
    t = dict(x=_t(x), fs=_t(fs), fd=_t(fd), m=_t(m),
             bits=None if bits is None else _t(bits),
             keep_mul=None if keep_mul is None else _t(keep_mul), kp=kp)
    return j, t


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_parts_plain_match_tpu_kernels_at_8x256(graphs, dropout):
    """K8's, K9's and K10's plain versions at 8 heads x 256 against
    ``_rem_attend_kernel``, ``_attend_kernel`` and ``_attend_fused_kernel``
    in TPU interpret mode, which hold a head's width in one block."""
    heads, feat = 8, 256
    j, t = _wide_case(graphs, heads, feat, dropout)
    jh, th = graphs
    k_num, k_den = _tpu_kernel(jatt._rem_parts_impl, jh.rem, j["x"],
                               j["fs"], j["fd"], j["m"], j["keep_mul"], SLOPE)
    num, den = k8.rem_attend(th, t["x"], t["fs"], t["fd"], t["m"],
                             t["keep_mul"], SLOPE)
    np.testing.assert_allclose(num.numpy(), np.asarray(k_num).reshape(N, -1),
                               **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(k_den), **FWD_TOL)
    tile_args = (jh.bcsr, j["bits"], j["x"], j["fs"], j["fd"], j["m"], SLOPE,
                 j["kp"])
    k_num, k_den = _tpu_kernel(jatt._tile_parts_impl, *tile_args)
    num, den = k910.tile_parts(th, t["x"], t["fs"], t["fd"], t["m"],
                               t["bits"], SLOPE, t["kp"])
    np.testing.assert_allclose(num.numpy(), np.asarray(k_num).reshape(N, -1),
                               **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(k_den), **FWD_TOL)
    r_num, r_den = jatt._rem_parts_xla(jh.rem, j["x"], j["fs"], j["fd"],
                                       j["m"], j["keep_mul"], SLOPE)
    k_out, k_den = _tpu_kernel(jatt._fused_impl, *tile_args[:6], r_num,
                               r_den, SLOPE, j["kp"])
    out, den = k910.attend_fused(th, t["x"], t["fs"], t["fd"], t["m"],
                                 _t(r_num).reshape(N, -1), _t(r_den),
                                 t["bits"], SLOPE, t["kp"])
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out).reshape(N, -1),
                               **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(k_den), **FWD_TOL)
    assert not num[NO_TILE_ROWS].any()
    assert (k8.rem_attend.launches == k910.tile_parts.launches
            == k910.attend_fused.launches == 0)


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_bwd_a_plain_matches_tpu_kernel_at_8x256(graphs, dropout):
    """K5's plain version at 8 heads x 256 against ``_bwd_a_kernel`` in TPU
    interpret mode, and the walk model against both."""
    heads, feat = 8, 256
    j, t = _wide_case(graphs, heads, feat, dropout)
    jh, th = graphs
    rng = np.random.default_rng(3)
    gn = rng.normal(size=(N, heads * feat)).astype(np.float32)
    dden = rng.normal(size=(N, heads)).astype(np.float32)
    fdm3 = np.concatenate([np.asarray(j["fd"]), np.asarray(j["m"]), dden], 1)
    ref = _jax_bwd_a(jh, np.asarray(j["x"]).reshape(N, -1), gn,
                     np.asarray(j["fs"]), fdm3,
                     None if t["bits"] is None else np.asarray(j["bits"]),
                     None if t["keep_mul"] is None
                     else np.asarray(j["keep_mul"]), t["kp"])
    args = (th, t["x"], _t(gn), t["fs"], _t(fdm3), t["bits"], t["keep_mul"],
            SLOPE, t["kp"])
    plain = k56.attend_bwd_a_plain(*args)
    np.testing.assert_allclose(plain.numpy(), ref, **BWD_TOL)
    model = bwd_a_walk_model(*args, long_edges=32)
    np.testing.assert_allclose(model.numpy(), plain.numpy(), **BWD_TOL)

