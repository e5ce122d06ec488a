"""Tiled graph attention and neighbour max on the hybrid layout.

Port of ``graphneuralnetwork_tpu/ops/bcsr_attention.py``: GAT's softmax
aggregation (below) and SAGE's max-pool (``hybrid_segment_max``: K7 on the
tiles, K2 on the remainder, a plain PyTorch backward that routes each
cotangent to the neighbours attaining the max).

``gat_tiled_attend(hg, x, f_src, f_dst)`` is exactly
``spmm_weighted(g, edge_softmax(g, scores), x)`` on the equivalent COO
graph, with ``scores = LeakyReLU(f_src[s] + f_dst[r])`` (duplicate edges
count once per multiplicity: tiles hold edge counts, the remainder its edge
weights), without any per-edge [E, H, F] tensor:

  * forward: K4 (``ops/cuda/attend_online_kernel.py``) returns the output,
    the softmax denominator ``den`` and the exact shift ``m``;
  * backward: a cheap pre-pass here (``gn = g / den``, ``dden``, the
    [N, 3H] block ``f_dst | m | dden``), then K5 for ``d f_dst`` over the
    receiver rows and K6 for ``dx`` and ``d f_src`` over the sender rows of
    the transpose layout.

``gat_tiled_attend_parts`` computes the same function as the JAX package's
three-pass attend (its path off the TPU): the exact shift ``m`` from the
neighbour max of ``f_src`` (K7 on the tiles, K2 on the remainder), the
remainder's softmax partials (K8), then the tile pass seeded with them and
divided in-register (K10); K9 is the tile pass alone. Their gradients are
those of the plain formulation, recomputed in chunks of edges, as the JAX
package differentiates its XLA formulation; it has no backward kernel for
them. ``gat_tiled_attend`` and ``GATConv`` stay on K4-K6, as the JAX
package's TPU path does; the three-pass attend is reached by direct calls
and by ``tools/profile_attend.py``.

Attention dropout masks the numerator only, which is the same as dropping
the normalised weights. Tile slots draw their mask from one uint32 word per
slot (``bits`` [T, 128, 128], hashed per head by
``ops/cuda/attend_common.py:head_keep``), remainder
edges from ``keep_mul`` [E_pad, H] (``Bernoulli(keep) / keep``). Both are
explicit operands, so the forward and both backward passes see the same
draws, and tests can feed the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.bcsr import COL_BLOCK, ROW_BLOCK, BCSRGraph, HybridGraph
from ..core.graph import Graph
from .cuda.attend_bwd_kernel import attend_bwd_a, attend_bwd_b
from .cuda.attend_common import (NEG, edge_chunks, leaky, rem_edges,
                                 softmax_weights, tile_edges)
from .cuda.attend_online_kernel import attend_online
from .cuda.attend_parts_kernel import attend_fused, tile_parts
from .cuda.neighbor_max_kernel import neighbor_max
from .cuda.rem_attend_kernel import rem_attend
from .cuda.segment_max_kernel import segment_max


def backward_operands(g: torch.Tensor, dtype: torch.dtype,
                      f_dst: torch.Tensor, out: torch.Tensor,
                      den: torch.Tensor, m: torch.Tensor):
    """The backward's pre-pass from the cotangent ``g`` [N, H*F] of the
    output: ``gn = g / den`` in ``dtype`` (0 on rows without edges) and
    ``fdm3 = [f_dst | m | dden]`` float32 [N, 3H] with ``dden = -sum_f
    g * out / den``."""
    n, hf = out.shape
    heads = den.shape[1]
    live = den > 0
    den_c = torch.clamp_min(den, 1e-16)
    g3 = g.float().view(n, heads, hf // heads)
    gn = torch.where(live[:, :, None], g3 / den_c[:, :, None], 0.0)
    dden = -torch.where(live, (g3 * out.float().view_as(g3)).sum(-1) / den_c,
                        0.0)
    return (gn.reshape(n, hf).to(dtype),
            torch.cat([f_dst, m, dden], dim=1))


class _AttendOnline(torch.autograd.Function):
    """``out = attend(x, f_src, f_dst)`` with the kernelised gradient;
    ``m`` is a constant (softmax shift invariance), tiles and masks carry
    no gradient."""

    @staticmethod
    def forward(ctx, x, f_src, f_dst, hg, bits, keep_mul, slope, keep_prob):
        out, den, m = attend_online(hg, x, f_src, f_dst, bits, keep_mul,
                                    slope, keep_prob)
        # zero the shift of rows without edges: the backward then sees
        # finite values everywhere
        m = torch.where(den > 0, m, 0.0)
        ctx.save_for_backward(x, f_src, f_dst, out, den, m, bits, keep_mul)
        ctx.hg, ctx.slope, ctx.keep_prob = hg, slope, keep_prob
        return out

    @staticmethod
    def backward(ctx, g):
        x, f_src, f_dst, out, den, m, bits, keep_mul = ctx.saved_tensors
        hg, slope, keep_prob = ctx.hg, ctx.slope, ctx.keep_prob
        gn, fdm3 = backward_operands(g, x.dtype, f_dst, out, den, m)
        dfd = attend_bwd_a(hg, x, gn, f_src, fdm3, bits, keep_mul, slope,
                           keep_prob)
        dx, dfs = attend_bwd_b(hg, x, gn, f_src, fdm3, bits, keep_mul,
                               slope, keep_prob)
        return dx, dfs, dfd, None, None, None, None, None


def draw_dropout(hg: HybridGraph, heads: int, keep_prob: float,
                 generator: Optional[torch.Generator] = None):
    """The two dropout operands, drawn from ``generator`` on the graph's
    device: ``bits``, int32 [T, 128, 128] holding uniform uint32 words
    (torch samples no uint32, so int64 draws in [0, 2^32) keep their low
    32 bits), then ``keep_mul``, float32 [E_pad, H] = Bernoulli(keep) /
    keep for the remainder's slots."""
    dev = hg.device
    words = torch.randint(0, 2 ** 32, (hg.bcsr.n_tiles, ROW_BLOCK,
                                       COL_BLOCK),
                          dtype=torch.int64, generator=generator, device=dev)
    bits = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)
    keep = torch.rand((hg.rem.n_edge_pad, heads), generator=generator,
                      device=dev) < keep_prob
    return bits, keep.float() / keep_prob


def _dropout_operands(hg, heads, attn_dropout, generator, bits, keep_mul):
    """``(keep_prob, bits, keep_mul)``: the masks as given, or drawn from
    ``generator`` where either is missing; none without dropout."""
    if attn_dropout <= 0.0:
        return 1.0, None, None
    keep_prob = 1.0 - attn_dropout
    if bits is None or keep_mul is None:
        bits, keep_mul = draw_dropout(hg, heads, keep_prob, generator)
    return keep_prob, bits, keep_mul


def gat_tiled_attend(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                     f_dst: torch.Tensor, *, negative_slope: float = 0.2,
                     attn_dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     bits: Optional[torch.Tensor] = None,
                     keep_mul: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Softmax attention aggregation over a ``HybridGraph``.

    ``x``: [N, H, F] projected features; ``f_src``/``f_dst``: [N, H]
    per-node attention logits (computed in float32). Returns [N, H, F] in
    ``x``'s type. With ``attn_dropout > 0`` the masks are drawn from
    ``generator`` (``draw_dropout``) unless ``bits`` and ``keep_mul`` are
    given; without dropout neither is used.
    """
    n, heads, feat = x.shape
    fs32 = f_src.float().contiguous()
    fd32 = f_dst.float().contiguous()
    keep_prob, bits, keep_mul = _dropout_operands(hg, heads, attn_dropout,
                                                  generator, bits, keep_mul)
    out = _AttendOnline.apply(x.reshape(n, heads * feat).contiguous(), fs32,
                              fd32, hg, bits, keep_mul,
                              float(negative_slope), float(keep_prob))
    return out.view(n, heads, feat)


# ---------------------------------------------------------------------------
# three-pass attend: shift, remainder partials (K8), seeded tile pass (K10)
# ---------------------------------------------------------------------------


def _parts_grad(edges, x, f_src, f_dst, m, g_num, g_den, slope):
    """``(dx, d f_src, d f_dst)`` of ``sum(g_num * num) + sum(g_den * den)``
    for the softmax partials over ``edges`` = (receivers, senders, weights,
    keep or None), with ``m`` a constant: autograd of the plain formulation
    (``attend_common.softmax_parts``), one chunk of edges at a time
    (``edge_chunks``). Each chunk's loss is formed from its own edges'
    terms, ``g_num[r] * p * keep * x[s]`` and ``g_den[r] * p``, so no
    temporary is larger than the chunk. Float32 throughout; ``dx`` in
    ``x``'s type."""
    recv, send, w, keep = edges
    n, hf = x.shape
    heads = f_src.shape[1]
    xs, fs, fd = (a.detach().float().requires_grad_()
                  for a in (x, f_src, f_dst))
    g_num = g_num.float().reshape(n, heads, -1)
    g_den = g_den.float()
    grads = [torch.zeros_like(a) for a in (xs, fs, fd)]
    with torch.enable_grad():
        for sl in edge_chunks(recv.shape[0], hf):
            r, s = recv[sl], send[sl]
            p = softmax_weights(r, s, w[sl], fs, fd, m, slope)
            pn = p if keep is None else p * keep[sl]
            vals = pn[:, :, None] * xs[s].view(-1, heads, hf // heads)
            loss = (g_num[r] * vals).sum() + (g_den[r] * p).sum()
            for acc, g in zip(grads, torch.autograd.grad(loss, (xs, fs, fd))):
                acc += g
    dx, dfs, dfd = grads
    return dx.to(x.dtype), dfs, dfd


class _RemParts(torch.autograd.Function):
    """``(num, den)`` of the remainder (K8) with the plain formulation's
    gradient; ``m`` and ``keep_mul`` carry none."""

    @staticmethod
    def forward(ctx, x, f_src, f_dst, m, hg, keep_mul, slope):
        num, den = rem_attend(hg, x, f_src, f_dst, m, keep_mul, slope)
        ctx.save_for_backward(x, f_src, f_dst, m, keep_mul)
        ctx.hg, ctx.slope = hg, slope
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        x, f_src, f_dst, m, keep_mul = ctx.saved_tensors
        dx, dfs, dfd = _parts_grad(rem_edges(ctx.hg, keep_mul), x, f_src,
                                   f_dst, m, g_num, g_den, ctx.slope)
        return dx, dfs, dfd, None, None, None, None


class _TileParts(torch.autograd.Function):
    """``(num, den)`` of the tiles (K9) with the plain formulation's
    gradient; ``m`` and ``bits`` carry none."""

    @staticmethod
    def forward(ctx, x, f_src, f_dst, m, hg, bits, slope, keep_prob):
        num, den = tile_parts(hg, x, f_src, f_dst, m, bits, slope, keep_prob)
        ctx.save_for_backward(x, f_src, f_dst, m, bits)
        ctx.hg, ctx.slope, ctx.keep_prob = hg, slope, keep_prob
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        x, f_src, f_dst, m, bits = ctx.saved_tensors
        edges = tile_edges(ctx.hg, bits, f_src.shape[1], ctx.keep_prob)
        dx, dfs, dfd = _parts_grad(edges, x, f_src, f_dst, m, g_num, g_den,
                                   ctx.slope)
        return dx, dfs, dfd, None, None, None, None, None


class _AttendFused(torch.autograd.Function):
    """``(out, den)`` of the tile pass seeded with ``num_init``/``den_init``
    (K10). ``out = num / max(den, 1e-16)`` gives ``d num = g / den_c`` and
    ``d den = g_den - sum_f g * out / den_c``; both flow into the tile
    partials' gradient and, unchanged, back to ``num_init`` and
    ``den_init`` (the remainder's partials)."""

    @staticmethod
    def forward(ctx, x, f_src, f_dst, m, num_init, den_init, hg, bits, slope,
                keep_prob):
        out, den = attend_fused(hg, x, f_src, f_dst, m, num_init, den_init,
                                bits, slope, keep_prob)
        ctx.save_for_backward(x, f_src, f_dst, m, out, den, bits)
        ctx.hg, ctx.slope, ctx.keep_prob = hg, slope, keep_prob
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        x, f_src, f_dst, m, out, den, bits = ctx.saved_tensors
        n, hf = out.shape
        heads = den.shape[1]
        den_c = torch.clamp_min(den, 1e-16)
        g3 = g_out.float().reshape(n, heads, hf // heads)
        gn = g3 / den_c[:, :, None]
        gd = g_den.float() - (g3 * out.view_as(g3)).sum(-1) / den_c
        gn = gn.reshape(n, hf)
        edges = tile_edges(ctx.hg, bits, heads, ctx.keep_prob)
        dx, dfs, dfd = _parts_grad(edges, x, f_src, f_dst, m, gn, gd,
                                   ctx.slope)
        return dx, dfs, dfd, None, gn, gd, None, None, None, None


def three_pass_shift(hg: HybridGraph, f_src: torch.Tensor,
                     f_dst: torch.Tensor, slope: float) -> torch.Tensor:
    """The three-pass attend's exact softmax shift, float32 [N, H], no
    gradient: ``m = LeakyReLU(f_dst + nmax)`` with ``nmax`` the max of
    ``f_src`` over each node's in-neighbours (K7 on the tiles, K2 on the
    remainder; LeakyReLU is monotone), and 0 where a node has none."""
    fs32 = f_src.detach().float().contiguous()
    nmax = torch.maximum(bcsr_neighbor_max(hg.bcsr, fs32),
                         _rem_segment_max(hg.rem, fs32))
    return torch.where(nmax > NEG / 2,
                       leaky(f_dst.detach().float() + nmax, slope), 0.0)


def gat_tiled_attend_parts(hg: HybridGraph, x: torch.Tensor,
                           f_src: torch.Tensor, f_dst: torch.Tensor, *,
                           negative_slope: float = 0.2,
                           attn_dropout: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           bits: Optional[torch.Tensor] = None,
                           keep_mul: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``gat_tiled_attend`` by the three-pass route: the shift
    (``three_pass_shift``: K7 and K2), the remainder's partials (K8), then
    the tile pass seeded with them (K10). The same arguments and result;
    the gradient is the plain formulation's."""
    n, heads, feat = x.shape
    slope = float(negative_slope)
    fs32 = f_src.float().contiguous()
    fd32 = f_dst.float().contiguous()
    keep_prob, bits, keep_mul = _dropout_operands(hg, heads, attn_dropout,
                                                  generator, bits, keep_mul)
    m = three_pass_shift(hg, fs32, fd32, slope)
    x2 = x.reshape(n, heads * feat).contiguous()
    num_r, den_r = _RemParts.apply(x2, fs32, fd32, m, hg, keep_mul, slope)
    out, _ = _AttendFused.apply(x2, fs32, fd32, m, num_r, den_r, hg, bits,
                                slope, float(keep_prob))
    return out.view(n, heads, feat).to(x.dtype)


# ---------------------------------------------------------------------------
# neighbour max over tiles and remainder (SAGE max-pool)
# ---------------------------------------------------------------------------


def bcsr_neighbor_max(bg: BCSRGraph, v: torch.Tensor) -> torch.Tensor:
    """Max over tiled in-neighbours: ``out[r, c] = max_{s: W[r,s] ≠ 0}
    v[s, c]`` in float32, ``NEG`` where a node has no tiled in-edge (the
    caller combines it with the remainder before substituting an empty
    value). K7 on the card. Forward only: ``hybrid_segment_max`` carries
    the gradient."""
    return neighbor_max(bg, v.detach().float().contiguous())


def _rem_segment_max(rem: Graph, v: torch.Tensor) -> torch.Tensor:
    """Per-receiver max of the node values ``v`` [N, C] over the
    remainder's in-edges, ``max_{s -> r} v[s]`` (K2 on the card, which
    reads ``v`` at ``rem.senders`` itself: no gathered copy); only the
    real edges, which ``rem.row_ptr`` spans, count, so the padding needs no
    mask. Empty rows get K2's ``EMPTY``, below ``NEG / 2``. Forward
    only."""
    return segment_max(rem, v.detach().contiguous(), rem.senders)


def _max_pool_grad(hg: HybridGraph, v: torch.Tensor, best: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """d v of ``best = max over in-neighbours of v``: each ``g[r, c]`` is
    split evenly among the in-edges ``s -> r`` (tile slots and remainder
    edges) with ``v[s, c] == best[r, c]``. Float32 throughout."""
    rows, cols = hg.bcsr.slot_edges
    rem = hg.rem
    e = rem.n_edges
    dst = torch.cat([rows, rem.receivers[:e].long()])
    src = torch.cat([cols, rem.senders[:e].long()])
    hit = v[src] == best[dst]
    ties = torch.zeros_like(best).index_add_(0, dst, hit.float())
    share = torch.where(hit, g[dst] / ties[dst].clamp_min(1.0), 0.0)
    return torch.zeros_like(v).index_add_(0, src, share)


class _HybridSegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hg, empty_value):
        v = x.detach().float().contiguous()
        best = torch.maximum(bcsr_neighbor_max(hg.bcsr, v),
                             _rem_segment_max(hg.rem, v))
        ctx.save_for_backward(v, best)
        ctx.hg = hg
        return torch.where(best > NEG / 2, best, empty_value).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        v, best = ctx.saved_tensors
        dv = _max_pool_grad(ctx.hg, v, best, g.float())
        return dv.to(g.dtype), None, None


def hybrid_segment_max(hg: HybridGraph, x: torch.Tensor,
                       empty_value: float = 0.0) -> torch.Tensor:
    """Per-node max over all in-neighbours of a ``HybridGraph`` (tiles and
    COO remainder), the SAGE max-pool aggregation; nodes without in-edges
    get ``empty_value`` (as ``ops.segment.segment_max``). Computed in
    float32, returned in ``x``'s type.

    The gradient goes to the neighbours that attain the max, split evenly
    among exact ties; the JAX package splits a tie through nested ``max``
    VJPs instead, so the two differ only where tied values carry a
    gradient."""
    return _HybridSegmentMax.apply(x, hg, float(empty_value))
