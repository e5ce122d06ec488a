"""Sparse GTN: learned metapath composition without dense [N, N] tensors.

Port of ``graphneuralnetwork_tpu/nn/gtn_sparse.py``. The pattern of every
intermediate product depends only on the edge types' patterns, never on
the learned mixing weights, so the host enumerates each composition's
length-2 paths ("wedges") once (``build_gtn_plan``), and on the device one
composition ``H' = H @ (sum_u mix_u A_u)`` is a gather, a multiply and a
segment sum over the wedges. The final per-channel convolution is
``spmm_weighted`` with the channels in the heads slot. Parameters and
their names are ``GTN``'s (``SparseGTN`` subclasses it), so one state dict
serves both models.

Every sum of repeated indices here runs in a fixed order, so that a run is
bit-equal to a rerun and a captured epoch to an eager one: no atomics.

  * A composition sums with K1's gathered form (``ops/aggregate.py``)
    over the wedges sorted by (output slot, edge type): ``q[o, u] = sum
    a_w h[slot_w]``, then ``H'[o] = sum_u mix[u] q[o, u]``. The mixing
    weights enter after the segment sum, so their gradient is a plain
    reduction of ``q``. The backward, ``dh = S^T dq`` of the wedge matrix
    ``S``, is K1 again, over the same wedges sorted by input slot
    (``_Compose``).
  * The degree sums run as K1 over the patterns' rows, which the plan
    holds row-major; the degrees read back per slot (``gather_rows``)
    sum their gradient on K1 too, and the final convolution
    (``spmm_weighted``) is K1's gathered form, its ``d x`` K1 over the
    final graph's transpose.
  * A scatter whose indices are unique within one call stays
    ``index_add`` (the mixture's slots, the added diagonal, the final
    edge positions), its backward a gather.

``wedge_block`` bounds the working set: a composition of more than
``wedge_block`` channel-wedges runs in blocks of whole output rows (a row
longer than a block gets a block of its own), each block's K1 writing its
own rows, so the blocked result and its gradient are bit-equal to the
unblocked ones.

The plan keeps the reference's per-wedge arrays (``step_h_idx``,
``step_type``, ``step_a_val``, ``step_out``) on the host in the reference's
order; the device holds the two sorted orders built from them
(``step_fwd``, ``step_bwd``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from ..core.device import resolve_device
from ..core.graph import Graph, build_graph, csr_offsets
from ..ops.aggregate import aggregate_rows, gather_rows, sum_gathered
from ..ops.spmm import spmm_weighted
from .gtn import GTN


def _sorted_keys(pat, n):
    """CSR pattern -> (rows, cols, sorted int64 keys row * n + col)."""
    pat = pat.tocsr()
    pat.sort_indices()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(pat.indptr))
    cols = pat.indices.astype(np.int64)
    return rows, cols, rows * n + cols


@dataclasses.dataclass(frozen=True)
class WedgeOrder:
    """One order of a composition's wedges as a receiver-sorted ``Graph``:
    wedge ``e`` adds ``edge_weight[e] * x[senders[e]]`` into row
    ``receivers[e]``. ``ptr`` is ``graph.row_ptr`` on the host, where the
    blocks are cut."""

    graph: Graph
    ptr: np.ndarray

    def sum(self, x: torch.Tensor, limit: int) -> torch.Tensor:
        """``y[r] = sum_{e: receivers[e] = r} w_e x[senders[e]]``, float32
        [n_rows, C]: one K1 over all wedges, or one per block of whole rows
        of at most ``limit`` wedges."""
        g = self.graph
        if self.ptr[-1] <= limit:
            return sum_gathered(x, g.senders, g.receivers, g.row_ptr,
                                g.n_nodes, g.n_edges, g.edge_weight,
                                g.long_rows, g.long_edges)
        outs = []
        for r0, r1 in _blocks(self.ptr, limit):
            e0, e1 = int(self.ptr[r0]), int(self.ptr[r1])
            # a block's rows take no CTA of their own: its long rows would
            # be a slice of the graph's list (a host sync a call)
            outs.append(sum_gathered(
                x, g.senders[e0:e1], g.receivers[e0:e1] - r0,
                g.row_ptr[r0:r1 + 1] - e0, r1 - r0, e1 - e0,
                g.edge_weight[e0:e1]))
        return torch.cat(outs)


def _blocks(ptr: np.ndarray, limit: int) -> List[Tuple[int, int]]:
    """Rows [r0, r1) cut so that each block holds at most ``limit`` edges
    of the CSR offsets ``ptr``, or one row that alone holds more."""
    rows, out, r0 = len(ptr) - 1, [], 0
    while r0 < rows:
        r1 = int(np.searchsorted(ptr, ptr[r0] + limit, side="right")) - 1
        r1 = min(max(r1, r0 + 1), rows)
        out.append((r0, r1))
        r0 = r1
    return out


@dataclasses.dataclass(frozen=True)
class GTNPlan:
    """The host-built composition plan. Device tensors but for the
    reference-order wedge arrays (host numpy) and the static counts."""

    # base mixture: type t's weights scattered into P0's slots base_idx[t]
    base_idx: Tuple[torch.Tensor, ...]    # per type: int32[nnz_t]
    base_val: Tuple[torch.Tensor, ...]    # per type: float32[nnz_t]
    # per composition step s (s = 0 composes Q1 @ Q2, s >= 1 H @ Q), in
    # the reference's order, on the host:
    step_h_idx: Tuple[np.ndarray, ...]    # int32[W_s] into H's slots
    step_type: Tuple[np.ndarray, ...]     # int32[W_s] edge type a wedge
    step_a_val: Tuple[np.ndarray, ...]    # float32[W_s] A_u's weight
    step_out: Tuple[np.ndarray, ...]      # int32[W_s] into P_{s+1}'s slots
    step_row: Tuple[torch.Tensor, ...]    # int32[nnz_s] row of each slot
    step_row_ptr: Tuple[torch.Tensor, ...]  # int32[N + 1] its offsets
    step_diag: Tuple[torch.Tensor, ...]   # int32[N] diagonal slot (-1: none)
    # the same wedges sorted by (out slot, type) rows, sender the H slot;
    # and sorted by H slot, sender the (out slot, type) row
    step_fwd: Tuple[WedgeOrder, ...]
    step_bwd: Tuple[WedgeOrder, ...]
    final_graph: Graph                    # P_L + I as a padded Graph
    final_edge_pos: torch.Tensor          # int32[nnz_L] -> final edge
    final_diag: torch.Tensor              # int32[N] diagonal edges
    nnz: Tuple[int, ...]
    n_nodes: int
    n_types: int
    wedge_counts: Tuple[int, ...]

    def warm(self) -> "GTNPlan":
        """Build the first-use caches that sync with the host, before a
        CUDA graph's capture: the final graph's, and the wedge orders'
        long rows."""
        self.final_graph.warm()
        for order in (*self.step_fwd, *self.step_bwd):
            order.graph.long_rows
        return self


def _wedges(slot_csr, right, out_keys: np.ndarray, n: int):
    """Length-2 paths (i -> j) in ``slot_csr`` (data: H slot + 1), (j -> k)
    in ``right``: (h_slot, a_val, out_idx), the output slot found by
    binary search in the sorted output keys."""
    left = slot_csr.tocsr()
    left.sort_indices()
    right = right.tocsr()
    right.sort_indices()
    li = np.repeat(np.arange(n, dtype=np.int64), np.diff(left.indptr))
    lj = left.indices.astype(np.int64)
    h_slots = (left.data - 1.0).astype(np.int64)
    counts = np.diff(right.indptr)[lj]
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.int32))
    rep_edge = np.repeat(np.arange(len(lj)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    rpos = right.indptr[lj[rep_edge]] + offs
    k_idx = right.indices[rpos].astype(np.int64)
    a_val = right.data[rpos].astype(np.float32)
    out_idx = np.searchsorted(out_keys, li[rep_edge] * n + k_idx)
    return (h_slots[rep_edge].astype(np.int32), a_val,
            out_idx.astype(np.int32))


def _order(senders, receivers, weights, n_rows, device) -> WedgeOrder:
    graph = build_graph(senders, receivers, n_rows, weights, device=device)
    return WedgeOrder(graph, csr_offsets(receivers, n_rows))


def build_gtn_plan(adjs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   n_nodes: int, num_layers: int = 2,
                   max_wedges: int = 250_000_000, *,
                   device: str | torch.device = "cuda") -> GTNPlan:
    """``adjs``: per edge type (senders, receivers, weights), the sparse
    form of the [T, N, N] stack (the identity slice included). ``H[i, j]``
    nonzero means a metapath i -> j, and compositions are row-major
    products ``H @ Q``, as in the dense model. Raises where a normalised
    pattern lacks a diagonal (no identity type) or a step needs more than
    ``max_wedges`` wedges (host memory)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    n = n_nodes
    t_mats = [sp.csr_matrix((np.asarray(w, np.float32),
                             (np.asarray(s, np.int64),
                              np.asarray(r, np.int64))), shape=(n, n))
              for s, r, w in adjs]
    n_types = len(t_mats)
    union = (sum((m != 0).astype(np.float32) for m in t_mats)
             != 0).astype(np.float32).tocsr()
    eye = sp.identity(n, np.float32, format="csr")

    def diag_slots(rows, cols, *, require_full=False):
        d = np.full(n, -1, np.int64)
        on = rows == cols
        d[rows[on]] = np.flatnonzero(on)
        if require_full and (d < 0).any():
            # the dense GTN normalises with D^-1(H + I) unconditionally
            raise ValueError(
                "metapath composition pattern is missing diagonal entries "
                "- include the identity slice in the adjacency stack so "
                "that the D^-1(H+I) normalisation matches the dense GTN")
        return d.astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # P0 = the union pattern (the mixtures live on it)
    p_rows, p_cols, p_keys = _sorted_keys(union, n)
    base_idx, base_val = [], []
    for m in t_mats:
        _, _, mk = _sorted_keys((m != 0).astype(np.float32), n)
        m2 = m.tocsr()
        m2.sort_indices()
        base_idx.append(np.searchsorted(p_keys, mk).astype(np.int32))
        base_val.append(m2.data.astype(np.float32))

    step_h, step_t, step_a, step_o = [], [], [], []
    step_row, step_diag, wedge_counts = [], [], []
    fwd, bwd = [], []
    nnz = [len(p_rows)]
    cur_pat, cur_rows, cur_cols = union, p_rows, p_cols
    for s in range(num_layers):
        nxt = ((((cur_pat + eye) if s else cur_pat) @ union)
               != 0).astype(np.float32).tocsr()
        nxt_rows, nxt_cols, nxt_keys = _sorted_keys(nxt, n)
        step_row.append(cur_rows.astype(np.int32))
        # step 0 composes Q1 @ Q2 raw; later steps normalise first
        step_diag.append(diag_slots(cur_rows, cur_cols,
                                    require_full=s > 0))
        slot_csr = sp.csr_matrix(
            (np.arange(len(cur_rows), dtype=np.float64) + 1.0,
             (cur_rows, cur_cols)), shape=(n, n))
        parts = [_wedges(slot_csr, m, nxt_keys, n) for m in t_mats]
        w = sum(len(p[0]) for p in parts)
        wedge_counts.append(w)
        if w > max_wedges:
            raise ValueError(
                f"composition {s} needs {w} wedges (> {max_wedges}); "
                "raise max_wedges if the host has the memory for the plan "
                "build, or use the dense GTN for this graph")
        h = np.concatenate([p[0] for p in parts]).astype(np.int32)
        t = np.concatenate([np.full(len(p[0]), u, np.int32)
                            for u, p in enumerate(parts)])
        a = np.concatenate([p[1] for p in parts]).astype(np.float32)
        o = np.concatenate([p[2] for p in parts]).astype(np.int32)
        step_h.append(h)
        step_t.append(t)
        step_a.append(a)
        step_o.append(o)
        rows = o.astype(np.int64) * n_types + t
        fwd.append(_order(h, rows, a, len(nxt_rows) * n_types, device))
        bwd.append(_order(rows, h, a, len(cur_rows), device))
        cur_pat, cur_rows, cur_cols = nxt, nxt_rows, nxt_cols
        nnz.append(len(nxt_rows))

    # the final convolution's pattern P_L + I; H[i, j] weights neighbour j
    # in row i's output, so in the receiver-owned Graph sender j, receiver i
    fi_rows, fi_cols, fi_keys = _sorted_keys(
        ((cur_pat + eye) != 0).astype(np.float32), n)
    final_edge_pos = np.searchsorted(
        fi_keys, cur_rows * n + cur_cols).astype(np.int32)
    final_diag = np.searchsorted(
        fi_keys, np.arange(n, dtype=np.int64) * (n + 1)).astype(np.int32)

    return GTNPlan(
        base_idx=tuple(dev(a) for a in base_idx),
        base_val=tuple(dev(a) for a in base_val),
        step_h_idx=tuple(step_h), step_type=tuple(step_t),
        step_a_val=tuple(step_a), step_out=tuple(step_o),
        step_row=tuple(dev(r) for r in step_row),
        step_row_ptr=tuple(dev(csr_offsets(r, n)) for r in step_row),
        step_diag=tuple(dev(d) for d in step_diag),
        step_fwd=tuple(fwd), step_bwd=tuple(bwd),
        final_graph=build_graph(fi_cols, fi_rows, n, device=device),
        final_edge_pos=dev(final_edge_pos), final_diag=dev(final_diag),
        nnz=tuple(nnz), n_nodes=int(n), n_types=n_types,
        wedge_counts=tuple(wedge_counts))


def stacked_adj_to_sparse(adj):
    """The dense stack [T, N, N] (a tensor or an array) as per-type edge
    lists (senders, receivers, weights) for ``build_gtn_plan``."""
    if isinstance(adj, torch.Tensor):
        adj = adj.cpu().numpy()
    out = []
    for t in range(adj.shape[0]):
        r, c = np.nonzero(adj[t])
        out.append((r.astype(np.int64), c.astype(np.int64),
                    adj[t][r, c].astype(np.float32)))
    return out


class _Compose(torch.autograd.Function):
    """``q = S h`` over one step's wedges (``fwd`` order) and
    ``dh = S^T dq`` (``bwd`` order): K1 both ways, blocks of whole rows."""

    @staticmethod
    def forward(ctx, h, fwd: WedgeOrder, bwd: WedgeOrder, limit: int):
        ctx.bwd, ctx.limit = bwd, limit
        return fwd.sum(h, limit)

    @staticmethod
    def backward(ctx, dq):
        return ctx.bwd.sum(dq.contiguous(), ctx.limit), None, None, None


class SparseGTN(GTN):
    """``GTN`` over a ``GTNPlan`` in place of the dense stack: the same
    parameters and results (the summation order aside), O(nnz) memory.
    ``wedge_block`` caps the channel-wedges of one K1 call (module
    docstring)."""

    def __init__(self, in_features: int, num_types: int, num_classes: int,
                 channels: int = 2, num_layers: int = 2, hidden: int = 64,
                 dtype: Optional[torch.dtype] = None,
                 wedge_block: int = 8_000_000):
        super().__init__(in_features, num_types, num_classes, channels,
                         num_layers, hidden, dtype)
        self.wedge_block = wedge_block

    def _compose(self, plan: GTNPlan, h: torch.Tensor, mix: torch.Tensor,
                 s: int) -> torch.Tensor:
        """``H' = H @ (sum_u mix_u A_u)`` on step ``s``'s patterns; ``h``
        float32 [nnz_s, C], ``mix`` [C, T]. A plan sharded over a mesh
        (``parallel.gtn_sparse.ShardedGTNPlan``) composes over each rank's
        wedges."""
        limit = max(1, self.wedge_block // self.channels)
        if hasattr(plan, "sh_h_idx"):
            from ..parallel.gtn_sparse import compose_sharded
            return compose_sharded(plan, h, mix, s, limit)
        q = _Compose.apply(h, plan.step_fwd[s], plan.step_bwd[s], limit)
        q = q.view(plan.nnz[s + 1], plan.n_types, self.channels)
        return (q * mix.t()).sum(dim=1)

    @staticmethod
    def _normalize(h: torch.Tensor, rows: torch.Tensor,
                   row_ptr: torch.Tensor, diag: torch.Tensor,
                   n: int) -> torch.Tensor:
        """D^-1(H + I) of the values ``h`` [nnz, C] of a row-major pattern
        with every diagonal slot ``diag``."""
        h = h.index_add(0, diag, h.new_ones(diag.shape[0], h.shape[1]))
        deg = aggregate_rows(h, rows, row_ptr, n)
        return h / torch.clamp_min(gather_rows(deg, rows, row_ptr), 1e-12)

    def forward(self, plan: GTNPlan, x: torch.Tensor) -> torch.Tensor:
        c, n = self.channels, plan.n_nodes
        mix = self.gt0.conv1.mix()
        h = mix.new_zeros(plan.nnz[0], c)
        for t in range(plan.n_types):
            h = h.index_add(0, plan.base_idx[t],
                            plan.base_val[t][:, None] * mix[:, t])
        h = self._compose(plan, h, self.gt0.conv2.mix(), 0)
        for i in range(1, self.num_layers):
            h = self._normalize(h, plan.step_row[i], plan.step_row_ptr[i],
                                plan.step_diag[i], n)
            h = self._compose(plan, h, getattr(self, f"gt{i}").conv1.mix(),
                              i)

        # the final D^-1(H + I) on P_L + I, then the per-channel conv
        fg = plan.final_graph
        ew = h.new_zeros(fg.n_edges, c).index_add(0, plan.final_edge_pos, h)
        ew = self._normalize(ew, fg.receivers[:fg.n_edges], fg.row_ptr,
                             plan.final_diag, n)
        ew = F.pad(ew, (0, 0, 0, fg.n_edge_pad - fg.n_edges))
        xw = self._features(x)
        # the weights stay float32: spmm_weighted forms each product in
        # float32 and rounds it to xw's dtype once (and keeps their
        # gradient float32, where a bfloat16 cast would round it)
        z = spmm_weighted(fg, ew, xw[:, None, :].expand(n, c, xw.shape[1]))
        return self._head(F.relu(z.float()).to(xw.dtype).reshape(n, -1))
