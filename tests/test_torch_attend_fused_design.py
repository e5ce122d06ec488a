"""The seeded tile pass of the three-pass attend (K10) on the row walk of
``csrc/attend_walk.cuh`` (``csrc/attend_fused_kernel.cu``), which runs
only on the card.

Pinned here:
  * K10's algebra: a torch model of the kernel (each receiver row's stream
    from its first tile slot on, the remainder skipped; batches of 32
    slots; ``p`` from the given shift with the exponent clamped at 0; the
    sums seeded with the remainder's partials in the row's first warp;
    rows above the long-row threshold of ``HybridGraph.row_edges``
    (remainder plus tile slots) split into 8 warps' shares of the tile
    slots that add in warp order; a head wider than a warp holds in parts
    of its columns) against ``attend_fused_plain`` and JAX's
    ``_attend_fused_kernel`` in TPU interpret mode, at 8x8, 1x7 and 2x600
    (two parts), with and without dropout, with the three-pass shift and
    with the profiler's ``m = 0``; on the hub fixture (rows split by the
    graph's own rule) against ``attend_fused_plain``;
  * K10's launch arguments (``attend_fused_args``), built without a card
    at 8x256, 4x512 and 2x600: K4's column layout, the forward row masks,
    the remainder's spans, the row lengths and long rows.

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
from graphneuralnetwork_tpu_torch.core.bcsr import LONG_ROW_EDGES  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    attend_parts_kernel as k910)
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import (  # noqa: E402
    attend_layout, leaky, walk_layout)
from test_torch_attend_design import (  # noqa: E402
    BATCH, WARPS, _hybrids, _stream)
from test_torch_attend_parts import (  # noqa: E402, F401 (graphs: a fixture)
    N, NO_TILE_ROWS, _jax_shift, _t, _tpu_kernel, graphs)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
SLOPE, KEEP = 0.2, 0.6


def fused_walk_model(hg, x, f_src, f_dst, m, num_init, den_init, bits,
                     slope, keep_prob, long_edges):
    """K10's arithmetic in torch: each row's tile slots in stream order
    (the remainder's entries skipped); rows whose stream (remainder plus
    tile slots) holds more than ``long_edges`` entries split their tile
    slots into 8 contiguous shares, one a warp, the others on one warp;
    each warp sums its share in batches of 32, ``p = w * exp(min(score -
    m, 0))`` and ``p * keep * x_s`` over each part of the slab
    (``attend_layout``), the first warp from the seeds; the warps add in
    warp order, then ``out = num / max(den, 1e-16)``. Returns ``(out,
    den)`` as ``attend_fused``."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    lay = attend_layout(heads, feat, x.element_size())
    dropping = keep_prob < 1.0
    keep_mul = torch.ones(hg.rem.n_edge_pad, heads) if dropping else None
    recv, send, w, _, pos, keep = _stream(hg, bits, keep_mul, heads,
                                          keep_prob)
    rem_ptr = hg.rem.row_ptr.long()
    nr = rem_ptr[1:] - rem_ptr[:-1]
    tile = pos >= nr[recv]   # the stream from the first tile slot on
    recv, send, w, pos = recv[tile], send[tile], w[tile], pos[tile]
    keep = None if keep is None else keep[tile]
    tpos = pos - nr[recv]
    length = hg.row_edges[0].long()
    n_tiles = length - nr
    share = torch.where(length > long_edges, -(-n_tiles // WARPS),
                        n_tiles.clamp_min(1))
    warp = tpos // share[recv]
    assert (warp < WARPS).all()
    batch = (tpos - warp * share[recv]) // BATCH
    slot = recv * WARPS + warp                        # one (row, warp)
    p = w[:, None] * torch.exp(torch.clamp_max(
        leaky(f_dst[recv] + f_src[send], slope) - m[recv], 0.0))
    pn = p if keep is None else p * keep
    xs = x[send].float().view(-1, heads, feat)
    den = torch.zeros(n, WARPS, heads)
    num = torch.zeros(n, WARPS, heads, feat)
    den[:, 0] = den_init                              # warp 0's seeds
    num[:, 0] = num_init.view(n, heads, feat)
    den, num = den.view(n * WARPS, heads), num.view(n * WARPS, heads, feat)
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
    out = num_row / den_row.clamp_min(1e-16)[..., None]
    return out.reshape(n, hf), den_row


def _operands(jh, n, heads, feat, dropout, shift, seed):
    """Random operands for both packages: x, the logits, the shift (the
    three-pass one, or 0), the JAX-drawn masks under dropout and the
    remainder's partials from JAX's XLA path, as (jax dict, port dict)."""
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
    jx = jnp.asarray(x).reshape(n, heads, feat)
    r_num, r_den = jatt._rem_parts_xla(
        jh.rem, jx, jnp.asarray(fs), jnp.asarray(fd), jnp.asarray(m),
        None if keep_mul is None else jnp.asarray(keep_mul), SLOPE)
    j = dict(x=jx, fs=jnp.asarray(fs), fd=jnp.asarray(fd), m=jnp.asarray(m),
             bits=jnp.asarray(bits if dropout else np.zeros(
                 (jh.bcsr.tiles.shape[0], 1, 1), np.uint32)),
             r_num=r_num, r_den=r_den, kp=kp)
    t = (_t(x), _t(fs), _t(fd), _t(m), _t(r_num).reshape(n, -1), _t(r_den),
         None if bits is None else _t(bits), SLOPE, kp)
    return j, t


CASES = [(h, f, d, s) for h, f in ((8, 8), (1, 7), (2, 600))
         for d in (False, True) for s in ("exact", "zero")]


@pytest.mark.parametrize(
    "heads, feat, dropout, shift", CASES,
    ids=[f"{h}x{f}-{'dropout' if d else 'plain'}-m_{s}"
         for h, f, d, s in CASES])
def test_fused_walk_matches_plain_and_jax(graphs, heads, feat, dropout,
                                          shift):
    """The model, with the graph's own long-row rule and with every row
    above 4 entries split, equals ``attend_fused_plain`` and JAX's
    ``_attend_fused_kernel``; a row whose block has no tile gets its seeds
    divided. At 2 x 600 the slab is one head in two parts."""
    jh, th = graphs
    j, t = _operands(jh, N, heads, feat, dropout, shift, seed=feat)
    args = (th, *t)
    assert (attend_layout(heads, feat, 4).parts > 1) == (feat == 600)
    k_out, k_den = _tpu_kernel(jatt._fused_impl, jh.bcsr, j["bits"], j["x"],
                               j["fs"], j["fd"], j["m"], j["r_num"],
                               j["r_den"], SLOPE, j["kp"])
    k_out = np.asarray(k_out).reshape(N, -1)
    plain_out, plain_den = k910.attend_fused_plain(*args)
    for long_edges in (LONG_ROW_EDGES, 4):
        out, den = fused_walk_model(*args, long_edges=long_edges)
        np.testing.assert_allclose(out.numpy(), plain_out.numpy(),
                                   **FWD_TOL)
        np.testing.assert_allclose(den.numpy(), plain_den.numpy(),
                                   **FWD_TOL)
        np.testing.assert_allclose(out.numpy(), k_out, **FWD_TOL)
        np.testing.assert_allclose(den.numpy(), np.asarray(k_den),
                                   **FWD_TOL)
    num_init, den_init = t[4], t[5]
    rows = NO_TILE_ROWS
    want = num_init[rows].view(-1, heads, feat) / torch.clamp_min(
        den_init[rows], 1e-16)[:, :, None]
    np.testing.assert_allclose(out[rows].numpy(),
                               want.reshape(-1, heads * feat).numpy(),
                               rtol=0, atol=0)
    assert k910.attend_fused.launches == 0


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("heads, feat", [(2, 8), (1, 600)])
def test_fused_walk_splits_hub_rows(heads, feat, dropout):
    """On the hub fixture, whose row block 0 holds 8 dense tiles and ~2,600
    remainder edges, the graph's own long rows (remainder plus tile slots
    above 32) split their tile slots over 8 warps: the model equals
    ``attend_fused_plain``."""
    jh, th = _hybrids("hub", torch.float32)
    n = th.n_nodes
    long_rows = th.long_rows[0]
    assert long_rows.numel() > 0
    nr = th.rem.row_ptr[1:] - th.rem.row_ptr[:-1]
    assert ((th.row_edges[0] - nr)[long_rows.long()] > 0).all()
    j, t = _operands(jh, n, heads, feat, dropout, "exact", seed=heads)
    args = (th, *t)
    out, den = fused_walk_model(*args, long_edges=LONG_ROW_EDGES)
    r_out, r_den = k910.attend_fused_plain(*args)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), r_den.numpy(), **FWD_TOL)


WIDE = [(8, 256), (4, 512), (2, 600)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads, feat", WIDE,
                         ids=[f"{h}x{f}" for h, f in WIDE])
def test_fused_launch_args_at_wide_heads(graphs, heads, feat, dtype):
    """``attend_fused_args`` without a card: every argument converts to its
    ctypes type; the pointers name the forward tiles' row masks, the
    remainder's spans and the forward row lengths and long rows; the
    layout is K4's ``walk_layout`` of ``x``, the seeds and ``out`` (slabs
    or parts on the grid, no windows)."""
    _, th = graphs
    n = th.n_nodes
    gen = torch.Generator().manual_seed(heads)
    x = torch.randn(n, heads * feat, generator=gen).to(dtype)
    fs, fd, m, den = (torch.randn(n, heads, generator=gen)
                      for _ in range(4))
    num = torch.randn(n, heads * feat, generator=gen)
    out = torch.empty(n, heads * feat)
    bits = torch.zeros(th.bcsr.tiles.shape, dtype=torch.int32)
    args = k910.attend_fused_args(th, x, fs, fd, m, num, den, bits, out,
                                  den, SLOPE, KEEP, 0)
    argtypes = k910.FUSED_ENTRIES["gnn_attend_fused"]
    assert len(args) == len(argtypes)
    for arg, kind in zip(args, argtypes):
        if kind in (ctypes.c_int, ctypes.c_uint32):
            assert isinstance(arg, int), (arg, kind)
        kind(arg)
    assert args[9] == th.bcsr.row_masks.data_ptr()
    assert args[10] == th.rem.row_ptr.data_ptr()
    assert args[13] == th.row_edges[0].data_ptr()
    assert args[14] == th.long_rows[0].data_ptr()
    lay = walk_layout(heads, x, num, out)
    assert lay == attend_layout(heads, feat, x.element_size())
    assert args[17:29] == [n, heads, feat, int(dtype == torch.bfloat16), 0,
                           *lay.args(), lay.parts, th.long_rows[0].numel(),
                           LONG_ROW_EDGES]
    assert args[-2:] == [1, 0]   # dropping, stream
    if feat == 600:
        assert lay.parts == 2 and lay.n_slabs == 2 * heads
