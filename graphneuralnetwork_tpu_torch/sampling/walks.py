"""CSR construction and random walks on the host.

Port of ``csr_from_edges``, ``uniform_walks``, ``weighted_walks``,
``Node2VecWalker``, ``metapath_walks`` and BiNE's ``bine_walks`` from the
JAX package's ``sampling/walks.py``. ``uniform_walks`` draws from the C++
engine (``sampling/native.py``) by default, as JAX's does: one seed drawn
from ``rng`` and the engine's own generator, so the same ``rng`` gives the
walks of JAX's engine. With ``use_native=False``, and in every other
walker, each walker advances in lock-step with vectorised numpy draws, so
a [n_walks, length] walk matrix takes O(length) numpy steps and the same
inputs and ``rng`` give JAX's numpy walks draw for draw, except that a
walker at a node without neighbours at the end of the CSR does not read
``indices`` past its end (where JAX's numpy path raises).

CSR convention: ``(indptr, indices)`` with the neighbours of node v at
``indices[indptr[v]:indptr[v+1]]``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from . import native
from .alias import ConcatAliasTables
from .neighbor import _take


def csr_from_edges(senders, receivers, n_nodes: int,
                   weights=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr int64 [N+1], indices int32 [E], weights float32 [E]): each
    sender's receivers, in edge order (a stable sort by sender)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    order = np.argsort(senders, kind="stable")
    s, r = senders[order], receivers[order]
    w = (np.ones(len(s), np.float32) if weights is None
         else np.asarray(weights, np.float32)[order])
    indptr = np.searchsorted(s, np.arange(n_nodes + 1))
    return indptr.astype(np.int64), r.astype(np.int32), w


def uniform_walks(indptr, indices, starts, length: int,
                  rng: np.random.Generator,
                  use_native: bool = True) -> np.ndarray:
    """[n_starts, length] int32 uniform walks; a walker at a node without
    neighbours stays there. ``use_native`` draws on the C++ engine."""
    if use_native:
        return native.uniform_walks_native(
            indptr, indices, np.asarray(starts, np.int64), length,
            int(rng.integers(0, 2**62)))
    starts = np.asarray(starts, np.int64)
    n = len(starts)
    walks = np.empty((n, length), np.int32)
    cur = starts.copy()
    walks[:, 0] = cur
    deg = indptr[1:] - indptr[:-1]
    for t in range(1, length):
        d = deg[cur]
        alive = d > 0
        off = (rng.random(n) * np.maximum(d, 1)).astype(np.int64)
        nxt = _take(indices, indptr[cur] + off)
        cur = np.where(alive, nxt, cur)
        walks[:, t] = cur
    return walks


def weighted_walks(indptr, indices, weights, starts, length: int,
                   rng: np.random.Generator) -> np.ndarray:
    """[n_starts, length] int32 walks biased by edge weight (one alias
    table a node); a walker at a node without neighbours stays there."""
    n_nodes = len(indptr) - 1
    cat = ConcatAliasTables([weights[indptr[v]:indptr[v + 1]]
                             for v in range(n_nodes)])
    starts = np.asarray(starts, np.int64)
    n = len(starts)
    walks = np.empty((n, length), np.int32)
    cur = starts.copy()
    walks[:, 0] = cur
    deg = indptr[1:] - indptr[:-1]
    for t in range(1, length):
        alive = deg[cur] > 0
        safe = np.where(alive, cur, 0)
        local = cat.draw(safe, rng)
        nxt = _take(indices, indptr[safe] + local)
        cur = np.where(alive, nxt, cur)
        walks[:, t] = cur
    return walks


class Node2VecWalker:
    """p/q-biased second-order walks over per-edge alias tables.

    The first hop draws from the node's edge weights; after the edge
    (u -> v) the next hop draws over v's neighbours x with weight w(v, x)
    times 1/p if x == u, 1 if x is a neighbour of u, 1/q otherwise. A
    walker at a dead end repeats its node from then on."""

    def __init__(self, indptr, indices, p: float = 1.0, q: float = 1.0,
                 weights=None):
        self.indptr, self.indices = indptr, indices
        n_nodes = len(indptr) - 1
        w = (np.ones(len(indices), np.float32) if weights is None
             else np.asarray(weights, np.float32))
        neigh_sets = [set(indices[indptr[v]:indptr[v + 1]].tolist())
                      for v in range(n_nodes)]
        self.node_tables = ConcatAliasTables(
            [w[indptr[v]:indptr[v + 1]] for v in range(n_nodes)])
        # one table per directed edge position e (src_of[e] -> indices[e])
        src_of = np.repeat(np.arange(n_nodes),
                           indptr[1:] - indptr[:-1]).astype(np.int64)
        tables = []
        for e in range(len(indices)):
            u, v = int(src_of[e]), int(indices[e])
            nbrs = indices[indptr[v]:indptr[v + 1]]
            ww = w[indptr[v]:indptr[v + 1]].copy()
            for k, x in enumerate(nbrs):
                if x == u:
                    ww[k] /= p
                elif int(x) not in neigh_sets[u]:
                    ww[k] /= q
            tables.append(ww)
        self.edge_tables = ConcatAliasTables(tables)

    def walk(self, starts, length: int, rng: np.random.Generator):
        """[n_starts, length] int32 walks."""
        indptr, indices = self.indptr, self.indices
        starts = np.asarray(starts, np.int64)
        n = len(starts)
        deg = indptr[1:] - indptr[:-1]
        walks = np.empty((n, length), np.int32)
        cur = starts.copy()
        walks[:, 0] = cur
        if length == 1:
            return walks
        # first hop: the node's table
        alive = deg[cur] > 0
        safe = np.where(alive, cur, 0)
        local = self.node_tables.draw(safe, rng)
        edge_pos = indptr[safe] + local            # directed edge index
        nxt = _take(indices, edge_pos)
        cur = np.where(alive, nxt, cur)
        walks[:, 1] = cur
        for t in range(2, length):
            alive = alive & (deg[cur] > 0)
            safe_edge = np.where(alive, edge_pos, 0)
            local = self.edge_tables.draw(safe_edge, rng)
            new_edge = indptr[np.where(alive, cur, 0)] + local
            nxt = _take(indices, new_edge)
            edge_pos = np.where(alive, new_edge, edge_pos)
            cur = np.where(alive, nxt, cur)
            walks[:, t] = cur
        return walks


def metapath_walks(hetero, metapath: Sequence[Tuple[str, str, str]],
                   starts: np.ndarray, length: int,
                   rng: np.random.Generator) -> np.ndarray:
    """[n_starts, length] int32 walks whose step t follows relation
    ``metapath[(t - 1) % len(metapath)]`` of ``hetero``, in per-type local
    ids; a walker without a next hop stays where it is from then on."""
    csr: Dict[Tuple[str, str, str], tuple] = {}
    for key in metapath:
        s, d, _ = hetero.relations[key]
        csr[key] = csr_from_edges(s, d, hetero.node_counts[key[0]])
    starts = np.asarray(starts, np.int64)
    n = len(starts)
    walks = np.empty((n, length), np.int32)
    cur = starts.copy()
    walks[:, 0] = cur
    alive = np.ones(n, bool)
    for t in range(1, length):
        indptr, indices, _ = csr[metapath[(t - 1) % len(metapath)]]
        deg = indptr[1:] - indptr[:-1]
        safe = np.where(alive, cur, 0)
        d = deg[safe]
        step_alive = alive & (d > 0)
        off = (rng.random(n) * np.maximum(d, 1)).astype(np.int64)
        nxt = _take(indices, indptr[safe] + off)
        cur = np.where(step_alive, nxt, cur)
        alive = step_alive
        walks[:, t] = cur
    return walks


def bine_walks(
    indptr, indices, weights, centrality: np.ndarray,
    rng: np.random.Generator, *,
    percent: float = 0.15, max_t: int = 32, min_t: int = 1,
    p_stop: float = 0.15,
) -> list[np.ndarray]:
    """BiNE HITS-biased truncated walks (BiNE/utils/sample_utils.py:27-62):
    node v gets max(int(max_t * c_v * n * percent), min_t) walks, c the
    centrality normalised to sum 1 (walk count proportional to
    centrality, :37-41), each of a geometric length (stop probability
    ``p_stop`` a step) clipped to [min_t, max_t], drawn as one weighted
    walk matrix of the longest length and cut."""
    n_nodes = len(indptr) - 1
    c = centrality / max(centrality.sum(), 1e-12)
    num_walks = np.maximum((max_t * c * n_nodes * percent).astype(np.int64),
                           min_t)
    starts = np.repeat(np.arange(n_nodes), num_walks)
    lens = np.minimum(rng.geometric(p_stop, len(starts)), max_t)
    lens = np.maximum(lens, min_t)
    full = weighted_walks(indptr, indices, weights, starts, int(lens.max()),
                          rng)
    return [full[i, :lens[i]] for i in range(len(starts))]
