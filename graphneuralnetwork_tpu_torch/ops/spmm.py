"""SpMM and SDDMM on padded COO edge lists.

``spmm(graph, x)`` computes ``out[r] = Σ_{(s,r) ∈ E} w_sr · x[s]``: on a
``Graph``, K1's gathered form (``aggregate_gathered``: the sender gather
read inside the kernel, no [E, F] copy), whose backward is K1 again over
the graph's sender-sorted transpose for d x, and the per-edge dot
``g[recv] · x[send]`` for d w. On a ``HybridGraph``, the dense tiles'
``bcsr_spmm`` (K3) plus the same COO SpMM over the remainder. On a
partitioned graph (``parallel/``), this rank's rows: ``spmm_halo`` on a
``HaloGraph`` (the boundary exchange), ``spmm_sharded`` on a
``ShardedGraph`` (the all-gather).
"""

from __future__ import annotations

import torch

from ..core.bcsr import HybridGraph
from ..core.graph import Graph
from .aggregate import aggregate_gathered, aggregate_rows
from .bcsr_spmm import bcsr_spmm


def spmm(graph: Graph | HybridGraph, x: torch.Tensor) -> torch.Tensor:
    """out[r] = Σ_e w_e · x[senders_e] for receivers_e == r; [N, F]."""
    if hasattr(graph, "halo_size"):
        from ..parallel.halo import spmm_halo
        return spmm_halo(graph, x)
    if hasattr(graph, "mesh"):
        from ..parallel.sharded import spmm_sharded
        return spmm_sharded(graph, x)
    if hasattr(graph, "bcsr"):
        return bcsr_spmm(graph.bcsr, x, graph.bcsr_t) + spmm(graph.rem, x)
    # each product as x[senders] * w.to(x.dtype): the weight rounded to
    # x's type first
    return aggregate_gathered(graph, x, graph.edge_weight, round_weight=True)


def spmm_weighted(graph: Graph, edge_weight: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """SpMM with externally supplied (e.g. attention) edge weights.

    ``edge_weight`` may be [E] or [E, H] (multi-head); with heads ``x`` is
    [N, H, F] and the result [N, H, F], computed in ONE aggregation of
    [E, H·F] values. The products ``x[s] * w`` are formed in float32 and
    cast to ``x``'s type once, where they enter the aggregation, so their
    gradients (per-edge dot products for ``w``) stay float32 as well.
    """
    w = edge_weight.float()
    if w.ndim == 1:
        return aggregate_gathered(graph, x, w)
    if x.ndim != 3:
        raise ValueError("multi-head spmm expects x of shape [N, H, F]")
    n, h, f = x.shape
    out = aggregate_gathered(graph, x.reshape(n, h * f), w)
    return out.reshape(graph.n_nodes, h, f)


def spmm_coo(senders, receivers, weights, x, n_out: int) -> torch.Tensor:
    """Raw-array SpMM over receiver-sorted edges (padding weight 0). Builds
    the row offsets on the fly; prefer ``spmm(graph, x)`` in hot loops."""
    counts = torch.bincount(receivers, minlength=n_out)
    if counts.shape[0] != n_out:
        raise ValueError(f"receiver ids exceed n_out={n_out}")
    row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    if receivers.numel() > 1 and bool((receivers[1:] < receivers[:-1]).any()):
        raise ValueError("spmm_coo needs receiver-sorted edges")
    gathered = x[senders] * weights[:, None].to(x.dtype)
    return aggregate_rows(gathered, receivers, row_ptr, n_out)


def sddmm_dot(senders, receivers, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """e_k = a[senders_k] · b[receivers_k] — [E] (or [E, H] for [N, H, F])."""
    return torch.sum(a[senders] * b[receivers], dim=-1)


def sddmm_additive(senders, receivers, f_src: torch.Tensor,
                   f_dst: torch.Tensor) -> torch.Tensor:
    """e_k = f_src[senders_k] + f_dst[receivers_k] — GAT's additive edge
    score; ``f_src``/``f_dst`` are [N] or [N, H]."""
    return f_src[senders] + f_dst[receivers]
