"""Segment reductions and segment softmax on padded edge lists.

Port of ``graphneuralnetwork_tpu/ops/segment.py``. ``segment_sum``,
``segment_sum_unsorted``, ``segment_mean``, ``segment_max`` and
``segment_softmax`` are plain PyTorch on every device, as the reference
leaves them to XLA. ``edge_softmax`` follows the reference's kernel
branch: the segment-max kernel (K2) on the detached scores, then the
denominator through ``aggregate_edges`` (K1), read back per edge by
``gather_receivers`` (whose backward is K1 again).
"""

from __future__ import annotations

from typing import Optional

import torch

from .aggregate import aggregate_edges, gather_receivers
from .cuda.segment_max_kernel import segment_max as _segment_max_kernel


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
