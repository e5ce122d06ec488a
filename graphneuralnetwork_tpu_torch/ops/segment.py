"""Segment reductions and segment softmax on padded edge lists.

Port of ``graphneuralnetwork_tpu/ops/segment.py``. ``segment_sum``,
``segment_sum_unsorted``, ``segment_mean``, ``segment_max`` and
``segment_softmax`` are plain PyTorch on every device, as the reference
leaves them to XLA. ``edge_softmax`` follows the reference's kernel
branch: the segment-max kernel (K2) on the detached scores, then the
denominator through ``aggregate_edges`` (K1), read back per edge by
``gather_receivers`` (whose backward is K1 again).

``gat_edge_softmax(graph, f_src, f_dst, slope)`` is GAT's whole attention
softmax on a COO ``Graph``, ``softmax_e(LeakyReLU(f_src[s] + f_dst[r]))``
from the per-node logits: on a card one K2 launch in its softmax mode,
and in the backward one more in its backward mode (``ds`` and ``d f_dst``)
and K1 over the transpose for ``d f_src``; on the CPU the plain versions
of both. It keeps only α and the two [N, H] tables for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import span
from .aggregate import aggregate_edges, gather_receivers
from .cuda.segment_max_kernel import gat_softmax, gat_softmax_backward
from .cuda.segment_max_kernel import segment_max as _segment_max_kernel
from .cuda.spmm_kernel import segment_sum as _segment_sum_kernel


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def segment_sum(data, segment_ids, num_segments: int):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_sum_unsorted(data, segment_ids, num_segments: int):
    """``segment_sum`` over ids in any order (``index_add_`` needs none)."""
    return segment_sum(data, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Mean over segments; padding handled via ``mask`` (bool per element)."""
    if mask is not None:
        bmask = mask.to(data.dtype)
        data = data * _expand(bmask, data)
        counts = segment_sum(bmask, segment_ids, num_segments)
    else:
        counts = segment_sum(
            torch.ones(data.shape[0], dtype=data.dtype, device=data.device),
            segment_ids, num_segments)
    totals = segment_sum(data, segment_ids, num_segments)
    counts = torch.clamp_min(counts, 1.0)
    return totals / _expand(counts, totals)


def _segment_amax(data, segment_ids, num_segments: int):
    """Per-segment max; empty segments give -inf."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = _expand(segment_ids.long(), data).expand(data.shape)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=True)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Max over segments. Empty segments yield 0."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data,
                           torch.finfo(data.dtype).min)
    out = _segment_amax(data, segment_ids, num_segments)
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_softmax(scores, segment_ids, num_segments: int,
                    mask: Optional[torch.Tensor] = None,
                    stable: bool = True):
    """Softmax of edge scores over incoming-edge segments.

    ``stable=True`` subtracts the per-segment max; ``stable=False`` is the
    raw-``exp`` formulation. Padding edges are excluded via ``mask``.
    """
    if mask is not None:
        scores = torch.where(_expand(mask, scores), scores,
                             torch.finfo(scores.dtype).min)
    if stable:
        seg_max = _segment_amax(scores, segment_ids, num_segments)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        scores = scores - seg_max[segment_ids]
    e = torch.exp(scores)
    if mask is not None:
        e = torch.where(_expand(mask, e), e, 0.0)
    denom = torch.clamp_min(segment_sum(e, segment_ids, num_segments), 1e-16)
    return e / denom[segment_ids]


@span("op.edge_softmax")
def edge_softmax(graph, scores, mask=None, stable: bool = True):
    """Softmax of ``scores`` ([E_pad] or [E_pad, H]) over each receiver's
    incoming edges, in float32, returned in the scores' dtype."""
    if mask is None:
        mask = graph.edge_mask
    squeeze = scores.ndim == 1
    s2 = scores[:, None] if squeeze else scores
    m2 = _expand(mask, s2)
    neg = torch.finfo(torch.float32).min
    s2 = torch.where(m2, s2.float(), neg)
    if stable:
        # softmax is invariant to the subtracted constant: the kernel sees
        # detached scores and autograd never differentiates it
        seg_max = _segment_max_kernel(graph, s2.detach().contiguous())
        seg_max = torch.where(seg_max > neg / 2, seg_max, 0.0)
        s2 = s2 - seg_max[graph.receivers]
    e = torch.where(m2, torch.exp(s2), 0.0)
    denom = torch.clamp_min(aggregate_edges(graph, e), 1e-16)
    alpha = (e / gather_receivers(graph, denom)).to(scores.dtype)
    return alpha[:, 0] if squeeze else alpha


class _GatEdgeSoftmax(torch.autograd.Function):
    """``gat_edge_softmax``'s forward and backward (module docstring)."""

    @staticmethod
    @span("op.edge_softmax")
    def forward(ctx, f_src, f_dst, graph, slope):
        alpha = gat_softmax(graph, f_src, f_dst, slope)
        ctx.save_for_backward(alpha, f_src, f_dst)
        ctx.graph, ctx.slope = graph, slope
        return alpha

    @staticmethod
    @span("op.edge_softmax.backward")
    def backward(ctx, d_alpha):
        alpha, f_src, f_dst = ctx.saved_tensors
        graph = ctx.graph
        ds, d_dst = gat_softmax_backward(graph, alpha, d_alpha.contiguous(),
                                         f_src, f_dst, ctx.slope)
        d_src = None
        if ctx.needs_input_grad[0]:
            # each edge's ds summed into its sender: K1 over the transpose,
            # reading ds at the edge ids (gather_senders' backward)
            t = graph.transpose
            d_src = _segment_sum_kernel(
                ds, t.senders, t.row_ptr, graph.sender_rows,
                senders=t.edge_ids, n_edges=graph.n_edges,
                long_rows=t.long_rows, long_edges=graph.long_edges)
        return d_src, d_dst, None, None


def gat_edge_softmax(graph, f_src: torch.Tensor, f_dst: torch.Tensor,
                     negative_slope: float) -> torch.Tensor:
    """α [E_pad, H], float32 (in the tables' dtype on the CPU): per head,
    the softmax of ``LeakyReLU(f_src[senders_e] + f_dst[r])`` over each
    receiver's real edges, 0 on the padding edges; ``f_src`` [sender
    rows, H] and ``f_dst`` [N, H] the per-node logits, differentiable in
    both."""
    return _GatEdgeSoftmax.apply(f_src.contiguous(), f_dst.contiguous(),
                                 graph, negative_slope)
