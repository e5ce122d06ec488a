"""The core aggregation primitive: sum per-edge values into receiver nodes.

``aggregate_edges(graph, values)`` computes ``out[r] = Σ_{e: recv_e = r}
values[e]`` over the graph's real edges, for ``values`` of shape [E_pad, F]
(or [E_pad]). SpMM, attention-weighted aggregation and the softmax
denominator are a gather plus this primitive, so the segment-sum kernel
(K1) is written once.

The backward is a gather, ``d values = g[receivers]``: no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.graph import Graph
from .cuda.spmm_kernel import segment_sum


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, receivers, row_ptr, n_out, n_edges):
        ctx.save_for_backward(receivers)
        ctx.n_edges = n_edges
        return segment_sum(values, receivers, row_ptr, n_out)

    @staticmethod
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        dv = g[receivers]
        dv[ctx.n_edges:] = 0     # edges outside the spans do not count
        return dv, None, None, None, None


def aggregate_rows(values: torch.Tensor, receivers: torch.Tensor,
                   row_ptr: torch.Tensor, n_out: int,
                   n_edges: Optional[int] = None) -> torch.Tensor:
    """``aggregate_edges`` on raw receiver-sorted arrays.

    Sums the first ``n_edges`` edges (default: all), which ``row_ptr``
    spans (``row_ptr[-1] == n_edges``). Later edges, a graph's padding, are
    ignored on every device and get a zero gradient.
    """
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    if n_edges is None:
        n_edges = values.shape[0]
    out = _Aggregate.apply(values.contiguous(), receivers, row_ptr, n_out,
                           n_edges)
    return out[:, 0] if squeeze else out


def aggregate_edges(graph: Graph, values: torch.Tensor) -> torch.Tensor:
    """Sum [E_pad, F] edge values into [n_nodes, F] receiver buckets; the
    padding edges' values are ignored."""
    return aggregate_rows(values, graph.receivers, graph.row_ptr,
                          graph.n_nodes, graph.n_edges)
