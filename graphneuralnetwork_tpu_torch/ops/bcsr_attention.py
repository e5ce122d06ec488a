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
from .cuda.attend_common import NEG
from .cuda.attend_online_kernel import attend_online
from .cuda.neighbor_max_kernel import neighbor_max
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
    if attn_dropout > 0.0:
        keep_prob = 1.0 - attn_dropout
        if bits is None or keep_mul is None:
            bits, keep_mul = draw_dropout(hg, heads, keep_prob, generator)
    else:
        keep_prob, bits, keep_mul = 1.0, None, None
    out = _AttendOnline.apply(x.reshape(n, heads * feat).contiguous(), fs32,
                              fd32, hg, bits, keep_mul,
                              float(negative_slope), float(keep_prob))
    return out.view(n, heads, feat)


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


def _rem_segment_max(rem: Graph, gathered: torch.Tensor) -> torch.Tensor:
    """Per-receiver max of the remainder's gathered edge values [E_pad, C]
    (K2 on the card); only the real edges, which ``rem.row_ptr`` spans,
    count, so the padding needs no mask. Empty rows get K2's ``EMPTY``,
    below ``NEG / 2``. Forward only."""
    return segment_max(gathered.detach().contiguous(), rem.receivers,
                       rem.row_ptr, rem.n_nodes)


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
                             _rem_segment_max(hg.rem, v[hg.rem.senders]))
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
