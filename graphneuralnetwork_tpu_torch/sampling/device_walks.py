"""Node2vec (p/q) and metapath-constrained walks on the device (torch).

Port of ``graphneuralnetwork_tpu/sampling/device_walks.py``. The host
builds the transition tables once (numpy) and the walk runs on the
tables' device, every step a uniform draw and row gathers:

  * node2vec draws by inverse CDF over a node's padded neighbour slots:
    the host stores, per node and per directed edge (u -> v), the
    normalised cumulative transition probabilities over v's slots (edge
    weight times 1/p for the return hop, 1 for a triangle, 1/q otherwise),
    and a step picks slot ``#(cum <= u)`` for one uniform u. A node's slot
    j is the directed edge ``indptr[v] + j``, which indexes the next
    step's row. This is exact sampling from ``Node2VecWalker``'s
    distribution.
  * metapath walks draw uniformly from each leg's padded neighbour table
    (``device_neighbor.build_device_neighbor_table``), the relation cycle
    repeating, in per-type local ids.

JAX packs the cumulative rows, neighbour ids, degree and row start into
one float32 row (ids exact below 2^24); the port keeps separate integer
tables, so any size is exact, and its float32 cumulative tables equal
JAX's packed columns. The draws come from an explicit ``torch.Generator``
on the tables' device; JAX's threefry keys cannot be reproduced, so the
walks follow the same distribution, not the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .device_neighbor import build_device_neighbor_table, draw_offsets
from .walks import csr_from_edges


def _padded_slots(indptr: np.ndarray, values: np.ndarray, md: int,
                  fill) -> np.ndarray:
    """[N, md]: each CSR row's first ``md`` entries of ``values``, padded
    with ``fill``."""
    n = len(indptr) - 1
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    out = np.full((n, md), fill, values.dtype)
    pos = np.arange(len(values)) - np.repeat(indptr[:-1], deg)
    sel = pos < md
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)[sel]
    out[rows, pos[sel]] = values[sel]
    return out


def _normalised_cum(probs: np.ndarray) -> np.ndarray:
    """float32 row-normalised cumulative sums; a row that sums to 0 (a
    dead end) is all ones, so a draw picks slot 0 (unused)."""
    cum = np.cumsum(probs, axis=1)
    tot = cum[:, -1:]
    return np.where(tot > 0, cum / np.maximum(tot, 1e-30),
                    1.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Node2VecTables:
    """The p/q walk's tables on the device. ``node_cum`` [N, md] and
    ``edge_cum`` [E, md] float32 are JAX's ``node_pack[:, :md]`` and
    ``edge_pack[:, :md]``; ``nbr`` [N, md] int64 holds each node's
    neighbour ids (0 past its degree), ``deg`` [N] and ``row_start`` [N]
    int64 its degree and CSR row start, ``edge_dst`` [E] int64 each
    directed edge's target."""

    deg: torch.Tensor
    row_start: torch.Tensor
    nbr: torch.Tensor
    node_cum: torch.Tensor
    edge_cum: torch.Tensor
    edge_dst: torch.Tensor
    md: int


def build_node2vec_tables(indptr: np.ndarray, indices: np.ndarray,
                          p: float = 1.0, q: float = 1.0, weights=None,
                          device: str | torch.device = "cuda"
                          ) -> Node2VecTables:
    """The tables of ``Node2VecWalker``'s distribution (vectorised numpy,
    no per-edge loop), moved to ``device``."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(indptr) - 1
    e = len(indices)
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    md = max(int(deg.max(initial=1)), 1)
    w = (np.ones(e, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    nbr = _padded_slots(indptr, indices.astype(np.int32), md, np.int32(0))
    w_slots = _padded_slots(indptr, w, md, np.float32(0))
    valid = np.arange(md)[None, :] < deg[:, None]
    node_cum = _normalised_cum(w_slots * valid)
    # edge e = (u -> v): over v's slots x, 1/p if x == u, 1 if (u, x) is an
    # edge, 1/q otherwise
    src_of = np.repeat(np.arange(n, dtype=np.int64), deg)
    xs = nbr[indices].astype(np.int64)                      # [E, md]
    edge_key = np.sort(src_of * n + indices)
    qkey = src_of[:, None] * n + xs
    pos = np.searchsorted(edge_key, qkey)
    is_nb = edge_key[np.minimum(pos, max(e - 1, 0))] == qkey
    bias = np.where(xs == src_of[:, None], 1.0 / p,
                    np.where(is_nb, 1.0, 1.0 / q)).astype(np.float32)
    edge_cum = _normalised_cum(w_slots[indices] * bias * valid[indices])
    device = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Node2VecTables(
        deg=put(deg), row_start=put(indptr[:-1]),
        nbr=put(nbr.astype(np.int64)), node_cum=put(node_cum),
        edge_cum=put(edge_cum), edge_dst=put(indices), md=md)


def _slot(cum: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[W] int64: for each row of ``cum`` [W, md] the number of entries at
    or below one uniform draw (padded slots hold 1 and are never
    reached: a draw is below 1)."""
    u = torch.rand((cum.shape[0], 1), generator=generator,
                   device=cum.device)
    return (cum <= u).sum(dim=1)


def device_node2vec_walks(generator: torch.Generator, starts: torch.Tensor,
                          length: int, t: Node2VecTables) -> torch.Tensor:
    """[W, length] int32 p/q walks on the device: the first hop draws from
    the node's edge weights, later hops from the traversed edge's biased
    row; a walker at a dead end repeats its node from then on."""
    cur = starts.long()
    steps = [cur]
    if length == 1:
        return cur.to(torch.int32)[:, None]
    j = _slot(t.node_cum[cur], generator)
    alive = t.deg[cur] > 0
    eid = t.row_start[cur] + j
    cur = torch.where(alive, t.nbr[cur, j], cur)
    steps.append(cur)
    for _ in range(length - 2):
        row = torch.where(alive, eid, 0)
        v = t.edge_dst[row]                       # the node the edge reached
        j = _slot(t.edge_cum[row], generator)
        alive = alive & (t.deg[v] > 0)
        eid = torch.where(alive, t.row_start[v] + j, eid)
        cur = torch.where(alive, t.nbr[v, j], cur)
        steps.append(cur)
    return torch.stack(steps, dim=1).to(torch.int32)


def build_metapath_tables(hetero, metapath: Sequence[Tuple[str, str, str]],
                          device: str | torch.device = "cuda"
                          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One padded neighbour table and degree vector (int32) a leg of the
    relation cycle, on ``device``."""
    legs = []
    for key in metapath:
        s, d, _ = hetero.relations[key]
        indptr, indices, _ = csr_from_edges(s, d, hetero.node_counts[key[0]])
        legs.append(build_device_neighbor_table(indptr, indices,
                                                device=device))
    return legs


def device_metapath_walks(generator: torch.Generator, starts: torch.Tensor,
                          length: int,
                          legs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                          ) -> torch.Tensor:
    """[W, length] int32 metapath walks on the device: step t draws
    uniformly from leg ``(t - 1) % len(legs)``; a walker without a next
    hop stays where it is from then on."""
    cur = starts.long()
    out = [cur]
    alive = torch.ones_like(cur, dtype=torch.bool)
    for step in range(1, length):
        table, deg = legs[(step - 1) % len(legs)]
        safe = torch.where(alive, cur, 0)
        d = deg[safe].long()
        alive = alive & (d > 0)
        u = torch.rand(cur.shape, generator=generator, device=cur.device)
        nxt = table[safe, draw_offsets(u, d)].long()
        cur = torch.where(alive, nxt, cur)
        out.append(cur)
    return torch.stack(out, dim=1).to(torch.int32)
