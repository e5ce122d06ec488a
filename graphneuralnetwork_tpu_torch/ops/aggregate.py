"""The core aggregation primitive, the segment sum over a receiver-sorted
edge list (K1), and the gathers whose backward it is.

``aggregate_edges(graph, values)`` computes ``out[r] = Σ_{e: recv_e = r}
values[e]`` over the graph's real edges, for ``values`` of shape [E_pad, F]
(or [E_pad]); its backward is a gather, ``d values = g[receivers]``.

``aggregate_gathered(graph, x, weight)`` is the same sum with the sender
gather folded in: ``out[r] = Σ_e round(w_e · x[senders_e])`` (per head for
``weight`` [E, H]), which SpMM and the attention-weighted aggregation are.
Its backward needs no sort: ``d x`` is the same kernel over
``Graph.transpose`` (the receivers in sender order, the weights read
through the edge ids), and where the weights need a gradient the same
launch forms ``d w``, the per-edge, per-head dot ``g[recv] · x[send]``, in
K1's dot mode: each row of the transposed walk is a sender, whose ``x``
row K1 reads once beside the ``g[recv]`` rows it already reads for ``d x``,
and each edge's dot goes to ``d w`` at its id. That replaces no TPU kernel
(the JAX package leaves the dot to XLA). Formed apart, the dot takes two
[E, C] float32 gathers, their product and its reduction: 8.8 of a 24.5 ms
GAT epoch at ogbn-arxiv's shape on an H100, against 0.3 ms in the walk.
Its bound is bytes: the walk's own, plus each row's ``x`` read once and
``d w`` written once. ``aggregate_mean`` is the gathered form with the
weights ``1 / deg(r)`` (SAGE's mean over a COO graph).

``gather_receivers`` and ``gather_senders`` index a node table by the
graph's receivers or senders ([E_pad, ...]); their backward sums the
edges' gradients into the nodes with K1, per edge over ``row_ptr`` or over
the transpose, where PyTorch's indexing backward sorts the indices on
every call. The padding edges' gradients are not summed (every caller
gives them zero).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.graph import Graph
from ..utils.profiling import span
from .cuda.spmm_kernel import segment_sum, segment_sum_mean


class _Aggregate(torch.autograd.Function):
    @staticmethod
    @span("op.aggregate")
    def forward(ctx, values, receivers, row_ptr, n_out, n_edges, long_rows,
                long_edges):
        ctx.save_for_backward(receivers)
        ctx.n_edges = n_edges
        return segment_sum(values, receivers, row_ptr, n_out,
                           n_edges=n_edges, long_rows=long_rows,
                           long_edges=long_edges)

    @staticmethod
    @span("op.aggregate.backward")
    def backward(ctx, g):
        (receivers,) = ctx.saved_tensors
        dv = g[receivers]
        dv[ctx.n_edges:] = 0     # edges outside the spans do not count
        return dv, None, None, None, None, None, None


def aggregate_rows(values: torch.Tensor, receivers: torch.Tensor,
                   row_ptr: torch.Tensor, n_out: int,
                   n_edges: Optional[int] = None,
                   long_rows: Optional[torch.Tensor] = None,
                   long_edges: int = 0) -> torch.Tensor:
    """``aggregate_edges`` on raw receiver-sorted arrays.

    Sums the first ``n_edges`` edges (default: all), which ``row_ptr``
    spans (``row_ptr[-1] == n_edges``). Later edges, a graph's padding, are
    ignored on every device and get a zero gradient. ``long_rows`` (the
    rows above ``long_edges`` edges) each take a CTA of K1.
    """
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    if n_edges is None:
        n_edges = values.shape[0]
    out = _Aggregate.apply(values.contiguous(), receivers, row_ptr, n_out,
                           n_edges, long_rows, long_edges)
    return out[:, 0] if squeeze else out


def aggregate_edges(graph: Graph, values: torch.Tensor) -> torch.Tensor:
    """Sum [E_pad, F] edge values into [n_nodes, F] receiver buckets; the
    padding edges' values are ignored."""
    return aggregate_rows(values, graph.receivers, graph.row_ptr,
                          graph.n_nodes, graph.n_edges, graph.long_rows,
                          graph.long_edges)


def sum_gathered(x: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, row_ptr: torch.Tensor, n_out: int,
                 n_edges: int, weight: torch.Tensor,
                 long_rows: Optional[torch.Tensor] = None,
                 long_edges: int = 0) -> torch.Tensor:
    """``y[r] = Σ_{e ∈ span(r)} weight[e] · x[senders[e]]`` on raw
    receiver-sorted arrays, forward only: K1's gathered form with float32
    ``weight`` [E]."""
    return segment_sum(x.contiguous(), receivers, row_ptr, n_out,
                       senders=senders, weight=weight, n_edges=n_edges,
                       long_rows=long_rows, long_edges=long_edges)


class _GatherSum(torch.autograd.Function):
    """``out = Σ_e round(w_e · x[senders_e])`` over each receiver's edges
    (module docstring); ``x`` [graph.sender_rows, C], ``w`` float32
    [E_pad] or [E_pad, H]."""

    @staticmethod
    @span("op.gather_sum")
    def forward(ctx, x, w, graph, round_weight, tally):
        ctx.save_for_backward(x, w)
        ctx.graph, ctx.round_weight, ctx.tally = graph, round_weight, tally
        return segment_sum(x, graph.receivers, graph.row_ptr, graph.n_nodes,
                           senders=graph.senders, weight=w,
                           round_weight=round_weight, n_edges=graph.n_edges,
                           long_rows=graph.long_rows,
                           long_edges=graph.long_edges, tally=tally)

    @staticmethod
    @span("op.gather_sum.backward")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        graph = ctx.graph
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_dx or need_dw:
            t = graph.transpose
            with span("op.gather_sum.backward.dx"):
                res = segment_sum(g.contiguous(), t.senders, t.row_ptr,
                                  graph.sender_rows, senders=t.receivers,
                                  weight=w, weight_at=t.edge_ids,
                                  round_weight=ctx.round_weight,
                                  n_edges=graph.n_edges,
                                  long_rows=t.long_rows,
                                  long_edges=graph.long_edges,
                                  dot=x if need_dw else None,
                                  need_sum=need_dx, tally=ctx.tally)
            dx, dw = res if need_dw else (res, None)
            if need_dw:
                dw = dw.to(w.dtype)
        return dx, dw, None, None, None


def aggregate_gathered(graph: Graph, x: torch.Tensor, weight: torch.Tensor,
                       round_weight: bool = False) -> torch.Tensor:
    """``out[r] = Σ_{e: recv_e = r} round_T(w_e · x[senders_e])`` [N, C]
    for ``x`` [N, C] in ``T`` (float32 or bfloat16) and float32 ``weight``
    [E_pad] or [E_pad, H] (head ``h`` scales columns ``[h C/H, (h+1)
    C/H)``), the weight rounded to ``T`` first where ``round_weight`` is
    set; K1's gathered form, differentiable in ``x`` and ``weight``."""
    return _GatherSum.apply(x.contiguous(), weight, graph, round_weight,
                            None)


def aggregate_mean(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``out[r]`` = the mean of ``x[s]`` over the real edges ``s -> r`` (0
    on a row without one) [N, C]: K1's gathered form with the per-edge
    weights ``Graph.mean_weights`` (``1 / deg(r)``), each product rounded
    to ``x``'s type before the float32 sum; the backward is K1 over the
    transpose with the same weights. No [E, C] tensor is formed either
    way. Its launches also count as ``K1_mean``."""
    return _GatherSum.apply(x.contiguous(), graph.mean_weights, graph, False,
                            segment_sum_mean)


class _Walk(NamedTuple):
    """How K1 sums a gather's backward: over ``row_ptr``'s spans, reading
    the edges' gradients at ``edge_ids`` (None: in order); ``rows`` is the
    row of each walked edge (the plain version's index)."""

    rows: torch.Tensor
    row_ptr: torch.Tensor
    edge_ids: Optional[torch.Tensor]
    n_edges: int
    long_rows: Optional[torch.Tensor]
    long_edges: int


class _Gather(torch.autograd.Function):
    @staticmethod
    @span("op.gather")
    def forward(ctx, table, index, walk):
        ctx.walk, ctx.shape = walk, table.shape
        return table[index]

    @staticmethod
    @span("op.gather.backward")
    def backward(ctx, g):
        w = ctx.walk
        g = g.reshape(g.shape[0], -1).contiguous()
        out = segment_sum(g, w.rows, w.row_ptr, ctx.shape[0],
                          senders=w.edge_ids, n_edges=w.n_edges,
                          long_rows=w.long_rows, long_edges=w.long_edges)
        return out.reshape(ctx.shape), None, None


def gather_rows(table: torch.Tensor, rows: torch.Tensor,
                row_ptr: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for sorted ``rows`` with CSR offsets ``row_ptr``
    (each edge's row, ``row_ptr[-1]`` of them counted); the backward sums
    the gradients of each row's edges with K1's per-edge form."""
    walk = _Walk(rows, row_ptr, None, rows.shape[0], None, 0)
    return _Gather.apply(table, rows, walk)


def gather_receivers(graph: Graph, table: torch.Tensor) -> torch.Tensor:
    """``table[graph.receivers]`` [E_pad, ...]; the backward is K1 per edge
    over ``row_ptr``."""
    walk = _Walk(graph.receivers, graph.row_ptr, None, graph.n_edges,
                 graph.long_rows, graph.long_edges)
    return _Gather.apply(table, graph.receivers, walk)


def gather_senders(graph: Graph, table: torch.Tensor) -> torch.Tensor:
    """``table[graph.senders]`` [E_pad, ...]; the backward is K1 over
    ``graph.transpose``, reading each edge's gradient at its id."""
    t = graph.transpose
    walk = _Walk(t.senders, t.row_ptr, t.edge_ids, graph.n_edges,
                 t.long_rows, graph.long_edges)
    return _Gather.apply(table, graph.senders, walk)
