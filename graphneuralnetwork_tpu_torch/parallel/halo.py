"""Halo-exchange edge-partitioned SpMM and segment max.

Port of ``graphneuralnetwork_tpu/parallel/halo.py``. Where the sharded path
(``sharded.py``) all-gathers every node feature, this one exchanges only
the **boundary** rows each rank needs:

  * owner-computes node sharding as before (receiver-owned edges);
  * each shard's edges split into INTERIOR (sender local) and BOUNDARY
    (sender on another rank);
  * for each pair of ranks the host precomputes which rows one sends the
    other; they cross in one ``all_to_all`` of padded ``[D·H, F]`` slabs
    (``collectives.all_to_all_rows``);
  * the aggregation sums the interior edges from the local rows and the
    boundary edges from the received slab, each with K1's gathered form,
    and, on a tiled partition, the interior's dense 128×128 tiles with K3
    (``ops/bcsr_spmm.py``; the max with K7, the edges' max with K2).

The host side builds every shard's arrays from the same numpy inputs,
stacked ``[D, ...]`` and byte-equal to JAX's leaves. A rank keeps its own
shard (``HaloShard``) on its device. Each rank's step is a function of
``(shard, x_local, halo)`` (``spmm_halo_local``, ``segment_max_local``),
the exchange (``exchange``) kept apart, so a caller can build the halo
slab itself (``halo_slab``) and run any rank's step in one process.

The sums count a shard's real edges only; JAX also sums the zero-weight
padding into row ``nodes_per_shard - 1``, which adds nothing. The
segment max counts them too (by position, where JAX masks by weight > 0:
the same edges wherever the real weights are positive).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.bcsr import COL_BLOCK, ROW_BLOCK as TILE_ROWS, BCSRGraph, \
    build_bcsr_transpose
from ..core.graph import EDGE_BLOCK as EDGE_CHUNK, Graph, compute_chunk_spans
from ..ops.aggregate import aggregate_gathered
from ..ops.bcsr_spmm import bcsr_spmm
from ..ops.cuda.attend_common import NEG
from ..ops.cuda.neighbor_max_kernel import neighbor_max
from ..ops.cuda.segment_max_kernel import segment_max
from .collectives import all_to_all_rows
from .multihost import Mesh
from .sharded import _round_up, local_rows, nodes_per_shard, shard_graph


@dataclasses.dataclass(frozen=True, eq=False)
class HaloShard:
    """One rank's part of a ``HaloGraph`` on its device.

    ``interior``: the edges whose sender is local (senders index
    ``x_local``); ``boundary``: the others, whose senders index the
    received halo slab ([D·H] rows, peer-major); ``send_idx`` (int64
    [D·H]): the local rows this rank sends each peer, peer-major; ``tiles``
    and ``tiles_t``: the interior's dense tiles and their transpose
    (None where the partition is not tiled or this shard has no tile);
    ``row_mask``: the local rows that are real nodes."""

    rank: int
    n_devices: int
    halo_size: int
    interior: Graph
    boundary: Graph
    send_idx: torch.Tensor
    tiles: Optional[BCSRGraph]
    tiles_t: Optional[BCSRGraph]
    row_mask: torch.Tensor
    unit_edge_weights: bool

    @property
    def nodes_per_shard(self) -> int:
        return self.interior.n_nodes


@dataclasses.dataclass(frozen=True, eq=False)
class HaloGraph:
    """Edge-partitioned graph with its precomputed halo exchange plan.

    The stacked host arrays ([D, ...], numpy) are JAX's leaves. Interior
    edges index local rows; boundary edges index the received halo slab
    ([D·H, F], peer-major slots). ``int_edges``/``bnd_edges``/``n_tiles``
    hold each shard's real interior edges, boundary edges and dense tiles;
    ``local`` is the live rank's ``HaloShard`` (None on a
    ``Mesh.layout``)."""

    int_senders: np.ndarray     # int32[D, Ei] local sender
    int_receivers: np.ndarray   # int32[D, Ei] local receiver
    int_weight: np.ndarray      # f32[D, Ei]
    int_off: np.ndarray         # int32[D, B]
    int_cnt: np.ndarray         # int32[D, B]
    bnd_senders: np.ndarray     # int32[D, Eb] halo slot (p*H + k)
    bnd_receivers: np.ndarray   # int32[D, Eb]
    bnd_weight: np.ndarray      # f32[D, Eb]
    bnd_off: np.ndarray         # int32[D, B]
    bnd_cnt: np.ndarray         # int32[D, B]
    send_idx: np.ndarray        # int32[D, D, H] local row (0 pad)
    n_nodes: int
    n_node_pad: int
    nodes_per_shard: int
    halo_size: int
    int_max_chunks: int
    bnd_max_chunks: int
    axis: str
    mesh: Mesh
    int_edges: tuple
    bnd_edges: tuple
    # the optional tiled interior: per shard, the well-filled interior
    # blocks as dense 128x128 tiles; the straggler interior edges remain in
    # int_* above. None = pure COO.
    int_tiles: Optional[np.ndarray] = None     # f32[D, T, 128, 128]
    int_tile_col: Optional[np.ndarray] = None  # int32[D, T]
    int_tile_row: Optional[np.ndarray] = None  # int32[D, T]
    n_tiles: Optional[tuple] = None
    # True iff the partition was built from unit edge weights, so tile
    # entries are integral edge multiplicities (gat_halo_attend needs it)
    unit_edge_weights: bool = True
    local: Optional[HaloShard] = None

    @property
    def n_devices(self) -> int:
        return int(self.send_idx.shape[0])

    def shard(self, rank: int, device: str | torch.device) -> HaloShard:
        """Shard ``rank`` on ``device``."""
        device = torch.device(device)
        nps, d = self.nodes_per_shard, rank
        interior = shard_graph(
            self.int_senders[d], self.int_receivers[d], self.int_weight[d],
            self.int_off[d], self.int_cnt[d], self.int_edges[d], nps,
            self.int_max_chunks, nps, device)
        boundary = shard_graph(
            self.bnd_senders[d], self.bnd_receivers[d], self.bnd_weight[d],
            self.bnd_off[d], self.bnd_cnt[d], self.bnd_edges[d], nps,
            self.bnd_max_chunks, self.n_devices * self.halo_size, device)
        tiles = tiles_t = None
        if self.int_tiles is not None and self.n_tiles[d]:
            t = self.n_tiles[d]
            tiles, tiles_t = _tile_graphs(
                self.int_tiles[d, :t], self.int_tile_col[d, :t],
                self.int_tile_row[d, :t], nps, device)
        rows = rank * nps + torch.arange(nps, device=device)
        return HaloShard(
            rank=rank, n_devices=self.n_devices, halo_size=self.halo_size,
            interior=interior, boundary=boundary,
            send_idx=torch.from_numpy(
                self.send_idx[d].reshape(-1).astype(np.int64)).to(device),
            tiles=tiles, tiles_t=tiles_t, row_mask=rows < self.n_nodes,
            unit_edge_weights=self.unit_edge_weights)


def _tile_graphs(tiles: np.ndarray, tcol: np.ndarray, trow: np.ndarray,
                 nps: int, device: torch.device):
    """A shard's real dense tiles as a ``BCSRGraph`` of ``nps`` rows (K3's
    and K7's operand), and the tiles of its transpose (K3's backward)."""
    n_rb = nps // TILE_ROWS
    cnt = np.bincount(trow, minlength=n_rb).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    t, i, j = np.nonzero(tiles)
    s = tcol[t].astype(np.int64) * COL_BLOCK + j
    r = trow[t].astype(np.int64) * TILE_ROWS + i
    bg = BCSRGraph(
        tiles=torch.from_numpy(np.ascontiguousarray(tiles)),
        col_ids=torch.from_numpy(np.ascontiguousarray(tcol, np.int32)),
        row_ids=torch.from_numpy(np.ascontiguousarray(trow, np.int32)),
        tile_off=torch.from_numpy(off), tile_cnt=torch.from_numpy(cnt),
        n_nodes=nps, n_edges=len(t), n_node_pad=nps,
        max_tiles=int(max(cnt.max(initial=1), 1))).to(device)
    bg_t = build_bcsr_transpose(s, r, nps, tiles[t, i, j], device=device)
    return bg, bg_t


def _tiled_interior(shards, nps, n_dev, min_edges_per_tile):
    """Move each shard's interior edges in well-filled (row block, col
    block) blocks into dense tiles; the stragglers stay COO."""
    RB, CB = TILE_ROWS, COL_BLOCK
    n_cb_loc = nps // CB
    per_shard = []
    for sh in shards:
        si, ri, wi = sh["si"], sh["ri"], sh["wi"]
        key = (ri // RB) * n_cb_loc + (si // CB)
        uniq, inv_k, cnt = np.unique(
            key, return_inverse=True, return_counts=True) \
            if len(key) else (np.zeros(0, np.int64),
                              np.zeros(0, np.int64),
                              np.zeros(0, np.int64))
        dense = (cnt[inv_k] >= min_edges_per_tile) if len(key) else \
            np.zeros(0, bool)
        dkey = key[dense]
        duniq, dinv = (np.unique(dkey, return_inverse=True)
                       if dense.any() else
                       (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        t = np.zeros((max(len(duniq), 1), RB, CB), np.float32)
        if dense.any():
            np.add.at(t, (dinv, ri[dense] % RB, si[dense] % CB), wi[dense])
        trow = (duniq // n_cb_loc).astype(np.int32) \
            if len(duniq) else np.zeros(1, np.int32)
        tcol = (duniq % n_cb_loc).astype(np.int32) \
            if len(duniq) else np.zeros(1, np.int32)
        per_shard.append((t, tcol, trow, len(duniq)))
        sh["si"], sh["ri"], sh["wi"] = si[~dense], ri[~dense], wi[~dense]
    T = max(t.shape[0] for t, _, _, _ in per_shard)
    TILES = np.zeros((n_dev, T, RB, CB), np.float32)
    TCOL = np.zeros((n_dev, T), np.int32)
    TROW = np.zeros((n_dev, T), np.int32)
    for d, (t, tcol, trow, _) in enumerate(per_shard):
        TILES[d, : t.shape[0]] = t
        TCOL[d, : len(tcol)] = tcol
        TROW[d, : len(trow)] = trow
        # the tail repeats the last real row block (the row ids stay
        # sorted); padded tiles are all zero
        TROW[d, len(trow):] = trow[-1] if len(trow) else 0
    return TILES, TCOL, TROW, tuple(k for _, _, _, k in per_shard)


def _pack(s, r, w, n_pad, nps):
    """Receiver-sorted, padded on row ``nps - 1``, with the chunk spans."""
    order = np.argsort(r, kind="stable")
    k = len(s)
    S = np.zeros(n_pad, np.int32)
    R = np.zeros(n_pad, np.int32)
    W = np.zeros(n_pad, np.float32)
    S[:k], R[:k], W[:k] = s[order], r[order], w[order]
    if k < n_pad:
        R[k:] = nps - 1
    return (S, R, W) + compute_chunk_spans(R, nps)


def partition_graph_halo(
    senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
    edge_weight: Optional[np.ndarray] = None, *,
    mesh: Mesh, axis: str = "data",
    tiled_interior: bool = False, min_edges_per_tile: int = 192,
) -> HaloGraph:
    """The halo partition of the graph over ``mesh``'s ranks.

    ``tiled_interior=True`` also densifies each shard's well-filled
    interior 128x128 blocks (``min_edges_per_tile`` edges or more) into
    tiles: boundary rows ride the exchange, the clustered interior the
    tiles, and only the straggler interior edges K1's COO form."""
    n_dev = mesh.shape[axis]
    senders = np.asarray(senders, np.int64).ravel()
    receivers = np.asarray(receivers, np.int64).ravel()
    unit_weights = edge_weight is None
    if edge_weight is None:
        edge_weight = np.ones(len(senders), np.float32)
    edge_weight = np.asarray(edge_weight, np.float32).ravel()
    unit_weights = unit_weights or bool(np.all(edge_weight == 1.0))

    nps = nodes_per_shard(n_nodes, n_dev)
    owner = senders // nps

    # per-shard edge splits and halo need sets: need[d][p] = the global
    # ids (sorted) that shard d reads from shard p
    shards, need = [], []
    for d in range(n_dev):
        lo, hi = d * nps, (d + 1) * nps
        m = (receivers >= lo) & (receivers < hi)
        s, r, w, o = senders[m], receivers[m] - lo, edge_weight[m], owner[m]
        interior = o == d
        shards.append(dict(
            si=s[interior] - lo, ri=r[interior], wi=w[interior],
            sb=s[~interior], rb=r[~interior], wb=w[~interior],
            ob=o[~interior]))
        need.append([np.unique(shards[d]["sb"][shards[d]["ob"] == p])
                     if p != d else np.zeros(0, np.int64)
                     for p in range(n_dev)])

    TILES = TCOL = TROW = n_tiles = None
    if tiled_interior:
        TILES, TCOL, TROW, n_tiles = _tiled_interior(
            shards, nps, n_dev, min_edges_per_tile)

    H = _round_up(max(max((len(ids) for nd in need for ids in nd),
                          default=1), 1), 8)

    # send plan: what d sends to p = need[p][d], as local rows of d
    send_idx = np.zeros((n_dev, n_dev, H), np.int32)
    for d in range(n_dev):
        for p in range(n_dev):
            ids = need[p][d]
            send_idx[d, p, :len(ids)] = (ids - d * nps).astype(np.int32)

    Ei = max(_round_up(max((len(sh["si"]) for sh in shards), default=1),
                       EDGE_CHUNK), EDGE_CHUNK)
    Eb = max(_round_up(max((len(sh["sb"]) for sh in shards), default=1),
                       EDGE_CHUNK), EDGE_CHUNK)
    interior, boundary = [], []
    for d, sh in enumerate(shards):
        interior.append(_pack(sh["si"], sh["ri"], sh["wi"], Ei, nps))
        # boundary: global sender -> halo slot p*H + (its rank in need)
        slot = np.empty(len(sh["sb"]), np.int64)
        for p in range(n_dev):
            m = sh["ob"] == p
            slot[m] = p * H + np.searchsorted(need[d][p], sh["sb"][m])
        boundary.append(_pack(slot, sh["rb"], sh["wb"], Eb, nps))

    def stack(parts, i):
        return np.stack([p[i] for p in parts])

    hg = HaloGraph(
        int_senders=stack(interior, 0), int_receivers=stack(interior, 1),
        int_weight=stack(interior, 2), int_off=stack(interior, 3),
        int_cnt=stack(interior, 4),
        bnd_senders=stack(boundary, 0), bnd_receivers=stack(boundary, 1),
        bnd_weight=stack(boundary, 2), bnd_off=stack(boundary, 3),
        bnd_cnt=stack(boundary, 4),
        send_idx=send_idx,
        n_nodes=int(n_nodes), n_node_pad=int(nps * n_dev),
        nodes_per_shard=int(nps), halo_size=int(H),
        int_max_chunks=int(max([1] + [p[5] for p in interior])),
        bnd_max_chunks=int(max([1] + [p[5] for p in boundary])),
        axis=axis, mesh=mesh,
        int_edges=tuple(len(sh["si"]) for sh in shards),
        bnd_edges=tuple(len(sh["sb"]) for sh in shards),
        int_tiles=TILES, int_tile_col=TCOL, int_tile_row=TROW,
        n_tiles=n_tiles, unit_edge_weights=unit_weights)
    if mesh.live:
        hg = dataclasses.replace(hg, local=hg.shard(mesh.rank, mesh.device))
    return hg


def _pack_clusters(labels: np.ndarray, n_dev: int, nps: int,
                   n_nodes: int) -> np.ndarray:
    """Best-fit-decreasing packing of whole clusters into shard slices.

    Shard d owns ids [d·nps, (d+1)·nps) ∩ [0, n); placing each cluster
    wholly inside one shard's range (splitting only clusters larger than a
    shard) keeps intra-cluster edges off the boundary. Returns
    ``perm[new] = old`` filling every position exactly.
    """
    caps = [max(0, min(nps, n_nodes - d * nps)) for d in range(n_dev)]
    uniq, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    bins: list[list[np.ndarray]] = [[] for _ in range(n_dev)]
    free = list(caps)
    for k in order:
        nodes = np.flatnonzero(labels == uniq[k])
        while len(nodes):
            d = int(np.argmax(free))
            take = min(len(nodes), free[d])
            if take == 0:
                break
            bins[d].append(nodes[:take])
            free[d] -= take
            nodes = nodes[take:]
    out = np.concatenate(
        [np.concatenate(b) if b else np.zeros(0, np.int64)
         for b in bins]).astype(np.int64)
    if len(out) != n_nodes:
        raise ValueError(f"cluster packing placed {len(out)} of {n_nodes} "
                         "nodes")
    return out


def partition_graph_halo_clustered(
    senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
    edge_weight: Optional[np.ndarray] = None, *,
    mesh: Mesh, axis: str = "data",
    tiled_interior: bool = True, min_edges_per_tile: int = 192,
):
    """Locality-cluster the nodes first (``core/reorder.py``), then
    partition: the ordering with the fewest cross-shard edges among
    bin-packed label-propagation clusters, plain cluster order and RCM.

    Returns ``(halo_graph, perm)`` with ``perm[new] = old``: permute node
    features and labels by ``perm`` before ``shard_nodes_halo``.
    """
    from ..core.reorder import (cluster_order, label_propagation,
                                rcm_order, relabel_edges)

    n_dev = mesh.shape[axis]
    nps = nodes_per_shard(n_nodes, n_dev)
    lab = label_propagation(senders, receivers, n_nodes)
    best_perm, best_cross = None, None
    for cand in (_pack_clusters(lab, n_dev, nps, n_nodes),
                 cluster_order(senders, receivers, n_nodes),
                 rcm_order(senders, receivers, n_nodes)):
        s2, r2 = relabel_edges(cand, senders, receivers)
        cross = int(np.sum((s2 // nps) != (r2 // nps)))
        if best_cross is None or cross < best_cross:
            best_perm, best_cross = cand, cross
    s2, r2 = relabel_edges(best_perm, senders, receivers)
    hg = partition_graph_halo(
        s2, r2, n_nodes, edge_weight, mesh=mesh, axis=axis,
        tiled_interior=tiled_interior,
        min_edges_per_tile=min_edges_per_tile)
    return hg, best_perm


def boundary_edge_fraction(hg: HaloGraph) -> float:
    """Fraction of real edges whose sender lives on another shard, the
    quantity that bounds the exchange's traffic."""
    bnd = int((hg.bnd_weight != 0).sum())
    interior = int((hg.int_weight != 0).sum())
    tiled = 0 if hg.int_tiles is None else int((hg.int_tiles != 0).sum())
    return bnd / max(bnd + interior + tiled, 1)


def shard_nodes_halo(x: np.ndarray, hg: HaloGraph) -> torch.Tensor:
    """This rank's rows of a [N, ...] node array padded to
    ``n_node_pad``, on its device."""
    return local_rows(x, hg.n_node_pad, hg.nodes_per_shard, hg.mesh.rank,
                      hg.mesh.device)


# ---------------------------------------------------------------------------
# each rank's step: a function of (shard, x_local, halo)
# ---------------------------------------------------------------------------


def exchange(sh: HaloShard, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The halo slab [D·H, ...]: the rows this rank owes each peer, sent
    in one ``all_to_all``; slot ``p·H + k`` holds peer p's k-th row."""
    return all_to_all_rows(x[sh.send_idx], mesh)


def halo_slab(x_full: torch.Tensor, hg: HaloGraph, rank: int) -> torch.Tensor:
    """The slab rank ``rank`` receives, built from the whole padded node
    array ``x_full`` [n_node_pad, ...] in one process (what ``exchange``
    delivers there). Slots past a peer's need hold its row 0, as sent."""
    nps, h = hg.nodes_per_shard, hg.halo_size
    rows = [p * nps + torch.from_numpy(
        hg.send_idx[p, rank].astype(np.int64)).to(x_full.device)
        for p in range(hg.n_devices)]
    return x_full[torch.cat(rows)].reshape(hg.n_devices * h,
                                           *x_full.shape[1:])


def spmm_halo_local(sh: HaloShard, x: torch.Tensor,
                    halo: torch.Tensor) -> torch.Tensor:
    """One rank's rows of ``Â @ x``: K1 over the interior edges from
    ``x`` [nps, F], K3 over the interior tiles, K1 over the boundary
    edges from ``halo`` [D·H, F]; each product ``x[s] * w`` rounded to
    ``x``'s type, as JAX forms it."""
    out = aggregate_gathered(sh.interior, x, sh.interior.edge_weight,
                             round_weight=True)
    if sh.tiles is not None:
        out = out + bcsr_spmm(sh.tiles, x, sh.tiles_t)
    return out + aggregate_gathered(sh.boundary, halo,
                                    sh.boundary.edge_weight,
                                    round_weight=True)


def spmm_halo(hg: HaloGraph, x: torch.Tensor) -> torch.Tensor:
    """``out = Â @ x`` for this rank's rows ``x`` [nps, F]: the boundary
    exchange, then ``spmm_halo_local``."""
    sh = hg.local
    return spmm_halo_local(sh, x, exchange(sh, x, hg.mesh))


def _edges(graph: Graph):
    e = graph.n_edges
    return graph.receivers[:e].long(), graph.senders[:e].long()


class _HaloMax(torch.autograd.Function):
    """``out[r] = max over in-neighbours`` from the local rows and the halo
    slab, 0 where a row has none; the gradient goes to the neighbours that
    attain the max, split evenly among exact ties. JAX splits a tie
    between the interior, boundary and tile parts through nested ``max``
    VJPs instead: the two differ only where tied values carry a gradient."""

    @staticmethod
    def forward(ctx, x, halo, sh):
        v = x.detach().float().contiguous()
        hv = halo.detach().float().contiguous()
        best = torch.maximum(
            segment_max(sh.interior, v, sh.interior.senders),
            segment_max(sh.boundary, hv, sh.boundary.senders))
        if sh.tiles is not None:
            best = torch.maximum(best, neighbor_max(sh.tiles, v))
        ctx.save_for_backward(v, hv, best)
        ctx.sh, ctx.dtypes = sh, (x.dtype, halo.dtype)
        return torch.where(best > NEG / 2, best, 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        v, hv, best = ctx.saved_tensors
        sh = ctx.sh
        g = g.float()
        sets = [(*_edges(sh.interior), v), (*_edges(sh.boundary), hv)]
        if sh.tiles is not None:
            sets.append((*sh.tiles.slot_edges, v))
        hits = [table[s] == best[r] for r, s, table in sets]
        ties = torch.zeros_like(best)
        for (r, _, _), hit in zip(sets, hits):
            ties.index_add_(0, r, hit.float())
        share = g / ties.clamp_min(1.0)
        dv, dh = torch.zeros_like(v), torch.zeros_like(hv)
        for (r, s, table), hit in zip(sets, hits):
            (dh if table is hv else dv).index_add_(
                0, s, torch.where(hit, share[r], 0.0))
        return dv.to(ctx.dtypes[0]), dh.to(ctx.dtypes[1]), None


def segment_max_local(sh: HaloShard, x: torch.Tensor,
                      halo: torch.Tensor) -> torch.Tensor:
    """One rank's rows of the in-neighbour max (SAGE's max-pool): K2 over
    the interior edges from ``x`` and the boundary edges from ``halo``, K7
    over the interior tiles, in float32; 0 for a row without in-edges;
    returned in ``x``'s type."""
    return _HaloMax.apply(x, halo, sh)


def segment_max_halo(hg: HaloGraph, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = max over r's in-neighbours' rows`` for this rank's rows
    ``x`` [nps, F]: the exchange, then ``segment_max_local``."""
    sh = hg.local
    return segment_max_local(sh, x, exchange(sh, x, hg.mesh))
