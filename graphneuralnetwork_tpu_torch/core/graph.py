"""Static-shape graph container and host-side builders.

Port of the JAX package's ``core/graph.py``. A graph of ``NATIVE_EDGES``
edges or more is built and normalised on the host by the C++ engine
(``sampling/native.py``), as in JAX, byte-exact with the numpy build. The
on-device representation is the same padded, receiver-sorted COO edge list:

  * ``senders`` / ``receivers``: int32[E_pad], sorted by receiver;
  * ``edge_weight``: float32[E_pad], 0.0 on padding edges;
  * ``chunk_off`` / ``chunk_cnt`` / ``max_chunks``: the per-128-row edge
    chunk spans of the TPU layout, kept so the arrays compare equal with
    the JAX builder;
  * ``row_ptr``: int32[N+1] CSR offsets of the real edges, which the CUDA
    segment kernels walk; ``row_ptr[N] = n_edges``;
  * ``long_rows`` (built at first use and kept): the rows with more than
    ``long_edges`` edges, which the segment max (K2) and the segment sum
    (K1) split over a CTA;
  * ``transpose`` (built at first use and kept): the real edges in sender
    order with the sender offsets, over which K1 sums the backward of a
    gather by sender (``ops/aggregate.py``);
  * ``n_senders`` (default ``n_nodes``): the rows of the table that the
    senders index. A partitioned graph's shard has more: the sharded
    partition's senders are global ids into the all-gathered rows, a halo
    shard's boundary senders index the received halo slab
    (``parallel/``). The transpose and the gathers' backward are that many
    rows long.

Padding edges self-loop on node ``n_nodes-1`` with weight 0. They lie in
no row's ``row_ptr`` span: every aggregation gives them zero values, so
the kernels skip them. A span ending at ``E_pad`` would make the last row
a hub whose edges one thread walks in turn (timed by chip_smoke.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..sampling import native
from .device import resolve_device

#: Edge lists are padded to a multiple of the JAX SpMM kernel's edge chunk,
#: so ``E_pad`` (and the chunk spans) equal the reference's.
EDGE_BLOCK = 1024
#: Node counts are padded to a multiple of this (reference layout).
NODE_BLOCK = 8
#: Output rows per chunk span (the reference kernel's row block).
ROW_BLOCK = 128
#: The segment max (K2) and the segment sum (K1) split a row over the 8
#: warps of a CTA of its own when it holds more edges than the larger of
#: these: a fixed floor, and a multiple of the graph's mean row length
#: (``Graph.long_edges``). K1 takes K2's rule: below it, its row groups of
#: up to 8 warps (``spmm_layout``) already cover rows of a few times the
#: mean, and a hub past it would hold its group's warps while the rest
#: finish.
LONG_ROW_EDGES = 32
LONG_ROW_MEANS = 4
#: Graphs of this many edges or more are built and normalised by the C++
#: engine (JAX's threshold).
NATIVE_EDGES = 16384


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Transpose:
    """A graph's real edges in sender order (a stable sort of the
    receiver-sorted list): the rows of a walk over senders, in which K1
    sums the backward of a gather by sender."""

    edge_ids: torch.Tensor    # int32[E]: the receiver-order id of each edge
    row_ptr: torch.Tensor     # int32[N+1]: the sender offsets
    senders: torch.Tensor     # int32[E]: each edge's sender (its row here)
    receivers: torch.Tensor   # int32[E]: each edge's receiver
    long_rows: torch.Tensor   # int32: senders above ``Graph.long_edges``


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded, static-shape COO graph whose arrays live on one device."""

    senders: torch.Tensor      # int32[E_pad]
    receivers: torch.Tensor    # int32[E_pad]
    edge_weight: torch.Tensor  # float32[E_pad]; 0 on padding
    chunk_off: torch.Tensor    # int32[ceil(n_nodes/128)]
    chunk_cnt: torch.Tensor    # int32[ceil(n_nodes/128)]
    row_ptr: torch.Tensor      # int32[n_nodes+1], real edges only
    n_nodes: int
    n_edges: int
    n_node_pad: int
    max_chunks: int
    n_senders: Optional[int] = None

    @property
    def sender_rows(self) -> int:
        """Rows of the sender table: ``n_senders``, else ``n_nodes``."""
        return self.n_nodes if self.n_senders is None else self.n_senders

    @property
    def n_edge_pad(self) -> int:
        return int(self.senders.shape[0])

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def edge_mask(self) -> torch.Tensor:
        """bool[E_pad] — True on real edges."""
        return (torch.arange(self.n_edge_pad, device=self.device)
                < self.n_edges)

    @property
    def mean_row_edges(self) -> float:
        """Real edges per row, on the host (no device read)."""
        return self.n_edges / max(self.n_nodes, 1)

    @property
    def long_edges(self) -> int:
        """Edges above which K2 gives a row a CTA of its own: the larger of
        ``LONG_ROW_EDGES`` and ``LONG_ROW_MEANS`` mean rows."""
        return max(LONG_ROW_EDGES,
                   LONG_ROW_MEANS * -(-self.n_edges // max(self.n_nodes, 1)))

    @functools.cached_property
    def long_rows(self) -> torch.Tensor:
        """int32: the rows (ascending) with more than ``long_edges`` real
        edges, each split over a CTA by K2. Built at first use (a host
        sync) and kept with the graph."""
        deg = self.row_ptr[1:] - self.row_ptr[:-1]
        return torch.nonzero(deg > self.long_edges).flatten().int()

    @functools.cached_property
    def transpose(self) -> Transpose:
        """The real edges in sender order (``Transpose``, ``sender_rows``
        rows), with the sender rows above ``long_edges`` edges. Built at
        first use (a sort and a host sync) and kept with the graph."""
        e = self.n_edges
        send = self.senders[:e].long()
        order = torch.argsort(send, stable=True)
        counts = torch.bincount(send, minlength=self.sender_rows)
        return Transpose(
            edge_ids=order.int(),
            row_ptr=torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int(),
            senders=send[order].int(),
            receivers=self.receivers[:e][order].contiguous(),
            long_rows=torch.nonzero(counts > self.long_edges).flatten().int())

    def warm(self) -> "Graph":
        """Build every cache that is built at first use (``long_rows``,
        ``transpose``), so that a later use does not sync with the host (a
        CUDA graph's capture cannot)."""
        self.long_rows, self.transpose
        return self

    def with_weights(self, w: torch.Tensor) -> "Graph":
        return dataclasses.replace(self, edge_weight=w)

    def to(self, device) -> "Graph":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})


def compute_chunk_spans(receivers_sorted: np.ndarray, n_out: int,
                        chunk: int = EDGE_BLOCK):
    """Per-128-row-block (first edge chunk, chunk count, max count) for
    edge chunks of ``chunk`` edges.

    Copy of ``ops/pallas/spmm_kernel.py:compute_chunk_spans`` of the JAX
    package, kept so the layout arrays compare equal.
    """
    n_row_blocks = -(-max(n_out, 1) // ROW_BLOCK)
    bounds = np.arange(n_row_blocks + 1) * ROW_BLOCK
    row_start = np.searchsorted(receivers_sorted, bounds, side="left")
    row_start[-1] = receivers_sorted.shape[0]
    lo = row_start[:-1] // chunk
    hi = -(-row_start[1:] // chunk)
    cnt = np.maximum(hi - lo, 0).astype(np.int32)
    return lo.astype(np.int32), cnt, int(max(cnt.max(initial=1), 1))


def csr_offsets(receivers: np.ndarray, n_nodes: int) -> np.ndarray:
    """Row offsets for receiver-sorted edges: int32[n_nodes+1]."""
    counts = np.bincount(receivers, minlength=n_nodes)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _build_arrays(senders, receivers, edge_weight, n_nodes: int,
                  e_pad: int) -> tuple:
    """The numpy build of ``native.build_graph_native`` (below
    ``NATIVE_EDGES``, and the engine's reference): (s, r, w, chunk_off,
    chunk_cnt, max_chunks), the edges stably sorted by receiver and padded
    to ``e_pad`` with zero-weight self loops on node ``n_nodes-1``."""
    n_edges = len(senders)
    if n_edges > 0:
        order = np.argsort(receivers, kind="stable")
        senders, receivers, edge_weight = (
            senders[order], receivers[order], edge_weight[order])
    s = np.zeros(e_pad, dtype=np.int32)
    r = np.zeros(e_pad, dtype=np.int32)
    w = np.zeros(e_pad, dtype=np.float32)
    s[:n_edges] = senders
    r[:n_edges] = receivers
    w[:n_edges] = edge_weight
    if n_edges < e_pad:
        s[n_edges:] = n_nodes - 1 if n_nodes > 0 else 0
        r[n_edges:] = n_nodes - 1 if n_nodes > 0 else 0
    return (s, r, w) + compute_chunk_spans(r, n_nodes)


def build_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    device: str | torch.device = "cuda",
) -> Graph:
    """Host-side constructor: sort edges by receiver, pad to static shapes.
    The arrays go to ``device``: the card unless the caller asks for the
    CPU; raises if no card is present."""
    device = resolve_device(device)
    senders = np.asarray(senders, dtype=np.int32).ravel()
    receivers = np.asarray(receivers, dtype=np.int32).ravel()
    n_edges = int(senders.shape[0])
    if edge_weight is None:
        edge_weight = np.ones(n_edges, dtype=np.float32)
    else:
        edge_weight = np.asarray(edge_weight, dtype=np.float32).ravel()

    e_pad = max(_round_up(max(n_edges, 1), EDGE_BLOCK), EDGE_BLOCK)
    n_pad = max(_round_up(max(n_nodes, 1), NODE_BLOCK), NODE_BLOCK)

    if n_edges >= NATIVE_EDGES:
        arrays = native.build_graph_native(senders, receivers, edge_weight,
                                           n_nodes, e_pad, ROW_BLOCK,
                                           EDGE_BLOCK)
    else:
        arrays = _build_arrays(senders, receivers, edge_weight, n_nodes,
                               e_pad)
    s, r, w, lo, cnt, max_chunks = arrays
    return Graph(
        senders=torch.from_numpy(s),
        receivers=torch.from_numpy(r),
        edge_weight=torch.from_numpy(w),
        chunk_off=torch.from_numpy(lo),
        chunk_cnt=torch.from_numpy(cnt),
        row_ptr=torch.from_numpy(csr_offsets(r[:n_edges], n_nodes)),
        n_nodes=int(n_nodes),
        n_edges=n_edges,
        n_node_pad=int(n_pad),
        max_chunks=int(max_chunks),
    ).to(device)


def symmetrize(senders: np.ndarray, receivers: np.ndarray):
    """Make the edge set symmetric and unique."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    key = s.astype(np.int64) * (max(int(s.max(initial=0)),
                                    int(r.max(initial=0))) + 1) + r
    _, idx = np.unique(key, return_index=True)
    return s[idx], r[idx]


def add_self_loops(senders: np.ndarray, receivers: np.ndarray, n_nodes: int):
    loops = np.arange(n_nodes, dtype=np.int32)
    # Drop any existing self loops first so (A + I) has exactly one diagonal.
    keep = senders != receivers
    return (np.concatenate([senders[keep], loops]),
            np.concatenate([receivers[keep], loops]))


def _in_degree(receivers, n_nodes, edge_weight):
    deg = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(deg, receivers, edge_weight)
    return deg


def _normalized(senders, receivers, edge_weight, n_nodes: int,
                mode: str) -> np.ndarray:
    """``native.normalize_edge_weights_native`` in numpy (below
    ``NATIVE_EDGES``, and the engine's reference)."""
    deg = _in_degree(receivers, n_nodes, edge_weight)
    if mode == "sym":
        d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)),
                              0.0)
        return (edge_weight * d_inv_sqrt[senders]
                * d_inv_sqrt[receivers]).astype(np.float32)
    d_inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    return (edge_weight * d_inv[receivers]).astype(np.float32)


def sym_normalize_weights(
    senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
) -> np.ndarray:
    """w_ij = d_i^-1/2 * d_j^-1/2 — the GCN propagation weights (the caller
    has added self loops); on the C++ engine from ``NATIVE_EDGES``
    edges."""
    if edge_weight is None:
        edge_weight = np.ones(len(senders), dtype=np.float32)
    normalize = (native.normalize_edge_weights_native
                 if len(senders) >= NATIVE_EDGES else _normalized)
    return normalize(senders, receivers, edge_weight, n_nodes, "sym")


def row_normalize_weights(
    senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
) -> np.ndarray:
    """w_ij = d_i^-1 — random-walk normalisation D^-1 A over incoming
    edges; on the C++ engine from ``NATIVE_EDGES`` edges."""
    if edge_weight is None:
        edge_weight = np.ones(len(senders), dtype=np.float32)
    normalize = (native.normalize_edge_weights_native
                 if len(senders) >= NATIVE_EDGES else _normalized)
    return normalize(senders, receivers, edge_weight, n_nodes, "row")


def row_normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-normalise a feature matrix."""
    x = np.asarray(x, dtype=np.float32)
    s = x.sum(axis=1, keepdims=True)
    s = np.where(s == 0, 1.0, s)
    return x / s


def dense_adj(graph: Graph) -> torch.Tensor:
    """The weighted adjacency as a dense [N, N] matrix on the graph's
    device, receiver rows (``a[r, s]`` sums the weights of the edges
    ``s -> r``): small graphs and the node-minibatch HAN only. Only the
    real edges are scattered; the padding adds nothing."""
    n, e = graph.n_nodes, graph.n_edges
    a = torch.zeros(n, n, dtype=graph.edge_weight.dtype, device=graph.device)
    return a.index_put_((graph.receivers[:e].long(),
                         graph.senders[:e].long()),
                        graph.edge_weight[:e], accumulate=True)


def gcn_graph(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
              *, device: str | torch.device = "cuda") -> Graph:
    """Symmetrise, add self loops, sym-normalise: the GCN adjacency, on
    ``device`` (as ``build_graph``)."""
    s, r = symmetrize(np.asarray(senders, np.int32),
                      np.asarray(receivers, np.int32))
    s, r = add_self_loops(s, r, n_nodes)
    w = sym_normalize_weights(s, r, n_nodes)
    return build_graph(s, r, n_nodes, w, device=device)


def gcn_graph_hybrid(senders: np.ndarray, receivers: np.ndarray,
                     n_nodes: int, perm: Optional[np.ndarray] = None, *,
                     device: str | torch.device = "cuda"):
    """The GCN adjacency on the hybrid layout: symmetrise, add self loops,
    cluster-reorder the nodes (``perm``, e.g. from a ``choose_layout``
    probe, or ``locality_order``), sym-normalise, then tile
    (``core/bcsr.py``; symmetric, so the forward tiles are the transpose).

    Returns ``(hybrid_graph, perm)`` with ``perm[new] = old``: the caller
    permutes node arrays by ``perm`` and maps index arrays through
    ``invert_permutation(perm)``.
    """
    from .bcsr import build_hybrid
    from .reorder import locality_order, relabel_edges

    s, r = symmetrize(np.asarray(senders, np.int32),
                      np.asarray(receivers, np.int32))
    s, r = add_self_loops(s, r, n_nodes)
    if perm is None:
        perm = locality_order(s, r, n_nodes)
    s, r = relabel_edges(perm, s, r)
    w = sym_normalize_weights(s, r, n_nodes)
    return build_hybrid(s, r, n_nodes, w, symmetric=True,
                        device=device), perm


def gat_graph_hybrid(senders: np.ndarray, receivers: np.ndarray,
                     n_nodes: int, *, dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda"):
    """GAT's adjacency on the hybrid layout: symmetrise, add self loops,
    unit weights (attention normalises over the edge set itself), tiles
    in ``dtype`` (bfloat16 holds the edge counts exactly). The nodes keep
    their labels: pass edges already relabelled by a locality order."""
    from .bcsr import build_hybrid

    s, r = symmetrize(np.asarray(senders, np.int32),
                      np.asarray(receivers, np.int32))
    s, r = add_self_loops(s, r, n_nodes)
    return build_hybrid(s, r, n_nodes, symmetric=True, dtype=dtype,
                        device=device)
