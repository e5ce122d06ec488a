"""Edge-partitioned graph execution over a mesh (owner-computes), with the
node features all-gathered.

Port of ``graphneuralnetwork_tpu/parallel/sharded.py``:

  * nodes are sharded row-wise over the mesh's ranks;
  * each rank owns exactly the edges whose **receiver** it owns, so the
    aggregation is local;
  * sender features cross the mesh: every rank all-gathers the node
    features (``collectives.all_gather_rows``) before its local gather and
    aggregation.

The host partitioner builds every shard's arrays from the same numpy
inputs, stacked ``[D, ...]`` and byte-equal to JAX's leaves (senders
global, receivers local, ``nodes_per_shard`` rounded to ``ROW_BLOCK · D``,
padding on the last local row with weight 0, the chunk spans). A rank of a
live mesh keeps its own shard on its device as a ``Graph`` whose senders
index the all-gathered table (``Graph.n_senders``); its aggregation is K1
(``ops/aggregate.py``) with the sender gather and the weights read in the
kernel. K1 sums the real edges only: JAX also sums the zero-weight padding
into row ``nodes_per_shard - 1``, which adds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.graph import (EDGE_BLOCK as EDGE_CHUNK, ROW_BLOCK, Graph,
                          compute_chunk_spans, csr_offsets)
from ..ops.aggregate import aggregate_edges, aggregate_gathered
from .collectives import all_gather_rows
from .multihost import Mesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def nodes_per_shard(n_nodes: int, n_dev: int) -> int:
    """Rows a shard owns: ``n_nodes`` rounded up to ``ROW_BLOCK · D``, over
    D."""
    return _round_up(max(n_nodes, 1), ROW_BLOCK * n_dev) // n_dev


def shard_graph(senders: np.ndarray, receivers: np.ndarray,
                weight: np.ndarray, off: np.ndarray, cnt: np.ndarray,
                n_edges: int, nps: int, max_chunks: int, n_senders: int,
                device: torch.device) -> Graph:
    """One shard's receiver-sorted edges (``n_edges`` real ones first) as a
    ``Graph`` of ``nps`` rows on ``device``, its senders indexing a table
    of ``n_senders`` rows."""
    return Graph(
        senders=torch.from_numpy(np.ascontiguousarray(senders)),
        receivers=torch.from_numpy(np.ascontiguousarray(receivers)),
        edge_weight=torch.from_numpy(np.ascontiguousarray(weight)),
        chunk_off=torch.from_numpy(np.ascontiguousarray(off)),
        chunk_cnt=torch.from_numpy(np.ascontiguousarray(cnt)),
        row_ptr=torch.from_numpy(csr_offsets(receivers[:n_edges], nps)),
        n_nodes=nps, n_edges=int(n_edges), n_node_pad=nps,
        max_chunks=int(max_chunks), n_senders=int(n_senders)).to(device)


def pad_rows(x: np.ndarray, n_rows: int) -> np.ndarray:
    """``x`` [N, ...] zero-padded to ``n_rows`` rows."""
    x = np.asarray(x)
    pad = n_rows - x.shape[0]
    if pad > 0:
        x = np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGraph:
    """Edge-partitioned graph over a 1-D mesh.

    The stacked host arrays ([D, ...], numpy) are JAX's leaves; ``n_edges``
    holds each shard's real edge count and ``local`` the shard of this
    process's rank as a ``Graph`` (None on a ``Mesh.layout``)."""

    senders: np.ndarray        # int32[D, E_s] global ids
    receivers: np.ndarray      # int32[D, E_s] local ids
    edge_weight: np.ndarray    # f32[D, E_s]
    chunk_off: np.ndarray      # int32[D, B_s]
    chunk_cnt: np.ndarray      # int32[D, B_s]
    n_nodes: int
    n_node_pad: int
    nodes_per_shard: int
    max_chunks: int
    axis: str
    mesh: Mesh
    n_edges: tuple
    local: Optional[Graph] = None

    @property
    def n_devices(self) -> int:
        return int(self.senders.shape[0])

    def shard(self, rank: int, device: str | torch.device) -> Graph:
        """Shard ``rank`` as a ``Graph`` on ``device``."""
        return shard_graph(
            self.senders[rank], self.receivers[rank], self.edge_weight[rank],
            self.chunk_off[rank], self.chunk_cnt[rank], self.n_edges[rank],
            self.nodes_per_shard, self.max_chunks, self.n_node_pad,
            torch.device(device))


def partition_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    mesh: Mesh,
    axis: str = "data",
) -> ShardedGraph:
    """Host-side partitioner: receiver-owner edge partition and per-shard
    receiver-sorted padding; a live rank's shard goes to its device."""
    n_dev = mesh.shape[axis]
    senders = np.asarray(senders, np.int32).ravel()
    receivers = np.asarray(receivers, np.int32).ravel()
    if edge_weight is None:
        edge_weight = np.ones(len(senders), np.float32)
    edge_weight = np.asarray(edge_weight, np.float32).ravel()

    nps = nodes_per_shard(n_nodes, n_dev)
    n_node_pad = nps * n_dev

    shard_edges = []
    for d in range(n_dev):
        lo, hi = d * nps, (d + 1) * nps
        m = (receivers >= lo) & (receivers < hi)
        s, r, w = senders[m], receivers[m] - lo, edge_weight[m]
        order = np.argsort(r, kind="stable")
        shard_edges.append((s[order], r[order], w[order]))

    e_s = max(
        _round_up(max((len(s) for s, _, _ in shard_edges), default=1),
                  EDGE_CHUNK), EDGE_CHUNK)
    S = np.zeros((n_dev, e_s), np.int32)
    R = np.zeros((n_dev, e_s), np.int32)
    W = np.zeros((n_dev, e_s), np.float32)
    OFF, CNT = [], []
    max_chunks = 1
    for d, (s, r, w) in enumerate(shard_edges):
        k = len(s)
        S[d, :k] = s
        R[d, :k] = r
        W[d, :k] = w
        if k < e_s:  # padding: last local row, zero weight
            R[d, k:] = nps - 1
            S[d, k:] = 0
        lo_, cnt_, mc = compute_chunk_spans(R[d], nps)
        OFF.append(lo_)
        CNT.append(cnt_)
        max_chunks = max(max_chunks, mc)

    sg = ShardedGraph(
        senders=S, receivers=R, edge_weight=W,
        chunk_off=np.stack(OFF), chunk_cnt=np.stack(CNT),
        n_nodes=int(n_nodes), n_node_pad=int(n_node_pad),
        nodes_per_shard=int(nps), max_chunks=int(max_chunks), axis=axis,
        mesh=mesh, n_edges=tuple(len(s) for s, _, _ in shard_edges))
    if mesh.live:
        sg = dataclasses.replace(sg, local=sg.shard(mesh.rank, mesh.device))
    return sg


def local_rows(x: np.ndarray, n_node_pad: int, nps: int, rank: int,
               device: str | torch.device) -> torch.Tensor:
    """Rank ``rank``'s rows of ``x`` [N, ...] zero-padded to
    ``n_node_pad``, on ``device``."""
    x = pad_rows(x, n_node_pad)[rank * nps:(rank + 1) * nps]
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def shard_nodes(x: np.ndarray, sg: ShardedGraph) -> torch.Tensor:
    """This rank's rows of a [N, ...] node array padded to
    ``n_node_pad``, on its device."""
    return local_rows(x, sg.n_node_pad, sg.nodes_per_shard, sg.mesh.rank,
                      sg.mesh.device)


def spmm_sharded(sg: ShardedGraph, x: torch.Tensor) -> torch.Tensor:
    """``out = Â @ x`` for this rank's rows ``x`` [nps, F]; returns this
    rank's rows of the result.

    All-gather ``x`` over the mesh, then K1's gathered form over the local
    edges (the global senders read from the gathered table in the kernel,
    each product ``x[s] * w`` rounded to ``x``'s type as JAX forms it)."""
    x_full = all_gather_rows(x, sg.mesh)
    return aggregate_gathered(sg.local, x_full, sg.local.edge_weight,
                              round_weight=True)


def aggregate_sharded(sg: ShardedGraph,
                      edge_values: torch.Tensor) -> torch.Tensor:
    """Sum this rank's per-edge values [E_s, F] into its owned rows."""
    return aggregate_edges(sg.local, edge_values)
