"""Struc2Vec: the structural-similarity multilayer graph and its
layer-hopping walks (numpy, on the host).

Port of the JAX package's ``sampling/struc2vec.py``:

  1. ``degree_rings``: each node's k-hop BFS rings as sorted degree
     sequences;
  2. DTW distances between the rings of candidate pairs with the cost
     max(a, b) / min(a, b) - 1, summed over the layers: on the C++
     engine (``sampling/native.py``), as in JAX;
  3. ``degree_candidates``: each node's ~2 log2 n degree-nearest nodes;
  4. layer weights exp(-f_k(u, v)), one alias table a node and layer, and
     the layer-move probabilities from the count of weights above the
     layer's mean;
  5. ``Struc2VecWalker``: stay in the layer with ``stay_prob`` and step,
     else move up or down first.

The numpy distances the tests hold the engine against
(``_numpy_distances``) run the DTW over many pairs at once (``_dtw_many``:
the same cell recurrence, cell by cell, vectorised across pairs), which
gives the numbers of ``dtw_distance`` bit for bit: every cell is one
addition of its cost to an exact minimum. The walker's steps are vectorised likewise; the
same layers and ``rng`` give JAX's walks draw for draw.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import native
from .alias import ConcatAliasTables
from .neighbor import _take


def degree_rings(indptr, indices, n_nodes: int, k_max: int
                 ) -> List[List[np.ndarray]]:
    """rings[v][k]: the sorted degrees of the nodes at hop distance k from
    v, for k up to ``k_max`` or the last non-empty ring."""
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    rings: List[List[np.ndarray]] = []
    for v in range(n_nodes):
        seen = {v}
        frontier = [v]
        out = [np.array([deg[v]], np.int64)]
        for _ in range(k_max):
            nxt = set()
            for u in frontier:
                for w in indices[indptr[u]:indptr[u + 1]]:
                    if int(w) not in seen:
                        nxt.add(int(w))
            if not nxt:
                break
            seen |= nxt
            frontier = sorted(nxt)
            out.append(np.sort(deg[list(frontier)]))
        rings.append(out)
    return rings


def _cost(a, b):
    big = np.maximum(a, b).astype(np.float64)
    small = np.minimum(a, b).astype(np.float64)
    return big / np.maximum(small, 1e-12) - 1.0


def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Plain O(len(a) len(b)) DTW of two degree sequences with the
    struc2vec cost (the reference for ``_dtw_many``)."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0 if la == lb else float(max(la, lb))
    cost = _cost(np.asarray(a)[:, None], np.asarray(b)[None, :])
    d = np.full((la + 1, lb + 1), np.inf)
    d[0, 0] = 0.0
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            d[i, j] = cost[i - 1, j - 1] + min(
                d[i - 1, j], d[i, j - 1], d[i - 1, j - 1])
    return float(d[la, lb])


def _dtw_many(seqs_a: Sequence[np.ndarray], seqs_b: Sequence[np.ndarray],
              chunk: int = 2048) -> np.ndarray:
    """float64 [P]: ``dtw_distance(seqs_a[p], seqs_b[p])`` for every pair
    (each sequence non-empty), the recurrence run cell by cell across a
    chunk of pairs of similar sizes at once, one DP row kept."""
    la = np.array([len(s) for s in seqs_a], np.int64)
    lb = np.array([len(s) for s in seqs_b], np.int64)
    out = np.empty(len(la), np.float64)
    order = np.argsort(la * lb, kind="stable")
    for c0 in range(0, len(order), chunk):
        sel = order[c0:c0 + chunk]
        n_a, n_b = int(la[sel].max()), int(lb[sel].max())
        a = np.ones((len(sel), n_a), np.int64)
        b = np.ones((len(sel), n_b), np.int64)
        for r, p in enumerate(sel):
            a[r, :la[p]] = seqs_a[p]
            b[r, :lb[p]] = seqs_b[p]
        prev = np.full((len(sel), n_b + 1), np.inf)
        prev[:, 0] = 0.0
        rows = np.arange(len(sel))
        for i in range(1, n_a + 1):
            cost = _cost(a[:, i - 1:i], b)                   # [P, n_b]
            up = np.minimum(prev[:, 1:], prev[:, :-1])       # d[i-1, j], d[i-1, j-1]
            cur = np.full_like(prev, np.inf)
            for j in range(1, n_b + 1):
                cur[:, j] = cost[:, j - 1] + np.minimum(up[:, j - 1],
                                                        cur[:, j - 1])
            prev = cur
            done = la[sel] == i
            out[sel[done]] = prev[rows[done], lb[sel][done]]
    return out


def degree_candidates(deg: np.ndarray, n_candidates: int
                      ) -> List[np.ndarray]:
    """For each node the other nodes within ``n_candidates`` places of it
    in the stable degree order."""
    n = len(deg)
    order = np.argsort(deg, kind="stable")
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    out = []
    for v in range(n):
        p = pos[v]
        cand = order[max(p - n_candidates, 0):min(p + n_candidates + 1, n)]
        out.append(cand[cand != v])
    return out


def candidate_pairs(indptr, n_nodes: int, n_candidates: int | None = None
                    ) -> tuple:
    """(each node's degree-nearest candidates, [P, 2] int32 the sorted
    unique pairs (u < v) of a node and a candidate); ``n_candidates``
    defaults to max(int(2 log2 n), 2)."""
    if n_candidates is None:
        n_candidates = max(int(2 * np.log2(max(n_nodes, 2))), 2)
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    cands = degree_candidates(deg, n_candidates)
    pair_set = set()
    for u in range(n_nodes):
        for v in cands[u]:
            v = int(v)
            pair_set.add((u, v) if u < v else (v, u))
    return cands, np.array(sorted(pair_set), np.int32).reshape(-1, 2)


def _numpy_distances(indptr, indices, n_nodes: int, k_max: int, pu, pv
                     ) -> tuple:
    """``native.struc2vec_distances_native`` in numpy: (f [P, k_max+1]
    float64, the ring distances of pair p summed over layers 0..k, -1 past
    its layers; n_layers [P] int32, the fewer rings of its two nodes)."""
    rings = degree_rings(indptr, indices, n_nodes, k_max)
    pu, pv = np.asarray(pu, np.int64), np.asarray(pv, np.int64)
    n_layers = np.array([min(len(rings[a]), len(rings[b]))
                         for a, b in zip(pu, pv)], np.int32)
    jobs = [(p, k) for p in range(len(pu)) for k in range(n_layers[p])]
    dist = _dtw_many([rings[pu[p]][k] for p, k in jobs],
                     [rings[pv[p]][k] for p, k in jobs])
    f = np.full((len(pu), k_max + 1), -1.0)
    for (p, k), d in zip(jobs, dist):
        f[p, k] = (f[p, k - 1] if k else 0.0) + d
    return f, n_layers


def build_multilayer_graph(
    indptr, indices, n_nodes: int, *,
    k_max: int = 3, n_candidates: int | None = None,
) -> List[Dict[int, List[Tuple[int, float]]]]:
    """layers[k][u] = [(v, exp(-f_k(u, v)))] over u's candidates v, f_k
    the DTW distances of their rings summed over layers 0..k (a pair whose
    rings stop earlier has fewer layers); the distances on the C++
    engine."""
    cands, pairs = candidate_pairs(indptr, n_nodes, n_candidates)
    f_mat, n_layers = native.struc2vec_distances_native(
        indptr, indices, n_nodes, k_max, pairs[:, 0], pairs[:, 1])
    dist_cache: Dict[Tuple[int, int], List[float]] = {
        (int(a), int(b)): [float(x) for x in f_mat[p, :n_layers[p]]]
        for p, (a, b) in enumerate(pairs)}

    layers: List[Dict[int, List[Tuple[int, float]]]] = [
        {v: [] for v in range(n_nodes)} for _ in range(k_max + 1)]
    for u in range(n_nodes):
        for v in cands[u]:
            v = int(v)
            f = dist_cache[(u, v) if u < v else (v, u)]
            for k in range(min(len(f), k_max + 1)):
                layers[k][u].append((v, float(np.exp(-f[k]))))
    return layers


class Struc2VecWalker:
    """Layer-hopping walker over the multilayer graph: each step stays in
    its layer with ``stay_prob``, else moves up with
    log(γ + e) / (log(γ + e) + 1) (γ the node's count of weights above the
    layer's mean) or down, drops to the highest layer at or below where
    the node has neighbours, and draws a neighbour there by weight."""

    def __init__(self, layers, stay_prob: float = 0.3):
        self.n_layers = len(layers)
        self.stay_prob = stay_prob
        self.tables: List[ConcatAliasTables] = []
        self.indptr: List[np.ndarray] = []
        self.nbr_ids: List[np.ndarray] = []
        up = []
        for layer in layers:
            n = len(layer)
            nbrs = [np.array([v for v, _ in layer[u]], np.int64)
                    for u in range(n)]
            wts = [np.array([w for _, w in layer[u]], np.float64)
                   for u in range(n)]
            self.indptr.append(np.concatenate(
                [[0], np.cumsum([len(x) for x in nbrs])]).astype(np.int64))
            self.nbr_ids.append(np.concatenate(nbrs) if n
                                else np.zeros(0, np.int64))
            # an empty row gets a one-slot table (drawn, never used)
            self.tables.append(ConcatAliasTables(
                [w if len(w) else np.ones(1) for w in wts]))
            all_w = (np.concatenate([w for w in wts if len(w)])
                     if any(len(w) for w in wts) else np.ones(1))
            avg = float(all_w.mean())
            gamma = np.array([max((w > avg).sum(), 1e-9) if len(w)
                              else 1e-9 for w in wts])
            up.append(np.log(gamma + np.e) / (np.log(gamma + np.e) + 1.0))
        self.up_prob = np.stack(up)                           # [L, N]
        self.has_nbrs = np.stack([ip[1:] > ip[:-1] for ip in self.indptr])

    def walk(self, starts, length: int, rng: np.random.Generator
             ) -> np.ndarray:
        """[n_starts, length] int32 walks, every walker from layer 0."""
        starts = np.asarray(starts, np.int64)
        n = len(starts)
        walks = np.empty((n, length), np.int32)
        cur = starts.copy()
        layer = np.zeros(n, np.int64)
        walks[:, 0] = cur
        for t in range(1, length):
            stay = rng.random(n) < self.stay_prob
            up = rng.random(n) < self.up_prob[layer, cur]
            layer = np.where(
                stay, layer,
                np.where(up, np.minimum(layer + 1, self.n_layers - 1),
                         np.maximum(layer - 1, 0)))
            # down to a layer where the node has neighbours (or layer 0)
            for _ in range(self.n_layers - 1):
                empty = (layer > 0) & ~self.has_nbrs[layer, cur]
                layer = np.where(empty, layer - 1, layer)
            nxt = cur.copy()
            for k in range(self.n_layers):
                m = layer == k
                if not m.any():
                    continue
                nodes = cur[m]
                has = self.has_nbrs[k, nodes]
                local = self.tables[k].draw(np.where(has, nodes, 0), rng)
                stepped = _take(self.nbr_ids[k],
                                self.indptr[k][nodes] + local)
                nxt[m] = np.where(has, stepped, nodes)
            cur = nxt
            walks[:, t] = cur
        return walks
