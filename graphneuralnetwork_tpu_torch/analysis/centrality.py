"""Centrality and graph-structure metrics as dense tensor iterations.

Port of ``graphneuralnetwork_tpu/analysis/centrality.py``, the toolkit of
the reference's networkx demo (Basis/networkx_study.py:11-31: degree,
connected components, diameter, degree/eigenvector/betweenness/closeness
centrality, pagerank, HITS).

Every metric works on a dense float32 adjacency ``A`` ([N, N], ``A[i, j]
= w`` for the edge i -> j) on one device: a tensor's own, or ``device``
(the card unless the caller asks for the CPU) for a numpy array or a list.
BFS is level-synchronous (the frontier of every source is an [N, N] 0/1
matrix advanced by one product a level), Brandes' betweenness runs over
all sources at once (one product a level of each sweep), and the power
iterations stop on JAX's tolerance tests, read on the host after every
iteration, so that they take JAX's iteration counts. The products run in
full float32 (``_full_float32``: TF32 off), as JAX's do; BFS on 0/1
matrices and Brandes' path counts are exact in float32 below 2^24.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graph import Graph

_Adj = Union[torch.Tensor, np.ndarray, Graph]

#: Sentinel for "unreachable" in the integer distance matrix.
_UNREACHED = torch.iinfo(torch.int32).max


def _full_float32(fn):
    """Run ``fn`` with float32 matrix products in full precision (no TF32),
    the caller's setting restored after."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kw)
        finally:
            torch.set_float32_matmul_precision(prev)
    return wrapped


def to_dense_adjacency(graph: Graph, symmetrize: bool = False) -> torch.Tensor:
    """Densify a padded COO ``Graph`` into float32 [N, N] on its device
    (weights summed over repeated edges; padding edges carry zero weight
    and vanish)."""
    n = graph.n_nodes
    flat = graph.senders.long() * n + graph.receivers.long()
    a = torch.zeros(n * n, device=graph.device).index_put_(
        (flat,), graph.edge_weight.float(), accumulate=True).view(n, n)
    if symmetrize:
        a = torch.maximum(a, a.T)
    return a


def _as_dense(a: _Adj, device=None) -> torch.Tensor:
    if isinstance(a, Graph):
        return to_dense_adjacency(a)
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32),
                           device=resolve_device(device or "cuda"))


# ---------------------------------------------------------------------------
# Degree
# ---------------------------------------------------------------------------

def degree_centrality(a: _Adj, device=None) -> torch.Tensor:
    """deg(v) / (n - 1) over the binarized adjacency (nx.degree_centrality)."""
    a = _as_dense(a, device)
    n = a.shape[0]
    deg = (a > 0).sum(dim=1).float()
    return deg / float(max(n - 1, 1))


# ---------------------------------------------------------------------------
# Spectral: eigenvector / pagerank / HITS (power iterations)
# ---------------------------------------------------------------------------

def _iterate(body, x: torch.Tensor, threshold: float, max_iter: int):
    """``x, err = body(x)`` while the last ``err > threshold`` (compared in
    float32, as JAX's ``while_loop`` does) and fewer than ``max_iter``
    iterations ran."""
    threshold = torch.tensor(threshold, dtype=torch.float32)
    for _ in range(max_iter):
        x, err = body(x)
        if not bool(err.cpu() > threshold):
            break
    return x


@_full_float32
def eigenvector_centrality(a: _Adj, max_iter: int = 200, tol: float = 1e-8,
                           device=None) -> torch.Tensor:
    """Principal eigenvector of A, L2-normalized.

    Power iteration on (A + I) — the shift keeps bipartite graphs from
    oscillating without changing the eigenvector, the same trick networkx's
    eigenvector_centrality uses (x ← x + Aᵀx per sweep).
    """
    a = _as_dense(a, device)
    n = a.shape[0]

    def body(x):
        nxt = x + a.T @ x
        nxt = nxt / torch.clamp_min(torch.linalg.vector_norm(nxt), 1e-30)
        return nxt, torch.abs(nxt - x).sum()

    return _iterate(body, torch.full((n,), 1.0 / n, device=a.device),
                    n * tol, max_iter)


@_full_float32
def pagerank(a: _Adj, alpha: float = 0.85, max_iter: int = 200,
             tol: float = 1e-10, device=None) -> torch.Tensor:
    """Standard PageRank with dangling-node mass redistribution
    (nx.pagerank semantics: L1-normalized, personalization uniform)."""
    a = _as_dense(a, device)
    n = a.shape[0]
    out_w = a.sum(dim=1)
    dangling = out_w <= 0
    p = torch.where(dangling[:, None], 0.0,
                    a / torch.clamp_min(out_w, 1e-30)[:, None])

    def body(x):
        dangle_mass = torch.where(dangling, x, 0.0).sum()
        nxt = alpha * (p.T @ x + dangle_mass / n) + (1.0 - alpha) / n
        return nxt, torch.abs(nxt - x).sum()

    return _iterate(body, torch.full((n,), 1.0 / n, device=a.device),
                    n * tol, max_iter)


@_full_float32
def hits(a: _Adj, max_iter: int = 200, tol: float = 1e-8, device=None):
    """HITS hubs/authorities (nx.hits semantics: max-normalized during
    iteration, L1-normalized outputs). Returns ``(hubs, authorities)``."""
    a = _as_dense(a, device)
    n = a.shape[0]

    def body(h):
        auth = a.T @ h
        auth = auth / torch.clamp_min(auth.max(), 1e-30)
        hub = a @ auth
        hub = hub / torch.clamp_min(hub.max(), 1e-30)
        return hub, torch.abs(hub - h).sum()

    h = _iterate(body, torch.full((n,), 1.0 / n, device=a.device), tol,
                 max_iter)
    auth = a.T @ h
    return (h / torch.clamp_min(h.sum(), 1e-30),
            auth / torch.clamp_min(auth.sum(), 1e-30))


# ---------------------------------------------------------------------------
# BFS family: distances / closeness / diameter / components
# ---------------------------------------------------------------------------

@_full_float32
def bfs_distances(a: _Adj, device=None) -> torch.Tensor:
    """All-pairs unweighted shortest-path lengths, int32 [N, N].

    Level-synchronous: the frontier of every source advances together via
    one [N, N] @ [N, N] product per BFS level. Unreachable pairs hold
    ``iinfo(int32).max``.
    """
    a = (_as_dense(a, device) > 0).float()
    n = a.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    dist = torch.full((n, n), _UNREACHED, dtype=torch.int32,
                      device=a.device).masked_fill_(eye, 0)
    frontier, d = eye.float(), 0
    while d < n and bool(frontier.sum().cpu() > 0):
        nxt = ((frontier @ a) > 0) & (dist == _UNREACHED)
        dist = torch.where(nxt, d + 1, dist)
        frontier, d = nxt.float(), d + 1
    return dist


def closeness_centrality(a: _Adj, device=None) -> torch.Tensor:
    """nx.closeness_centrality (wf_improved=True): for each node v with
    r reachable nodes and distance sum s, ``(r-1)/s * (r-1)/(n-1)``."""
    a = _as_dense(a, device)
    n = a.shape[0]
    dist = bfs_distances(a)
    reach = dist != _UNREACHED
    s = torch.where(reach, dist, 0).sum(dim=1).float()
    r = reach.sum(dim=1).float()  # includes self
    cc = torch.where(s > 0, (r - 1.0) / torch.clamp_min(s, 1e-30), 0.0)
    return cc * (r - 1.0) / float(max(n - 1, 1))


def diameter(a: _Adj, device=None) -> int:
    """Longest shortest path (raises on disconnected graphs, like nx)."""
    dist = bfs_distances(_as_dense(a, device))
    if bool((dist == _UNREACHED).any()):
        raise ValueError("graph is not connected: diameter is infinite")
    return int(dist.max())


def connected_components(a: _Adj, device=None) -> torch.Tensor:
    """Component labels int32 [N] (label = min node index in the component),
    via min-label propagation: one masked min-reduction over neighbors per
    round, O(diameter) rounds."""
    a = _as_dense(a, device) > 0
    a = a | a.T  # components are defined on the undirected closure
    n = a.shape[0]
    lab = torch.arange(n, dtype=torch.int32, device=a.device)
    while True:
        nbr = torch.where(a, lab[None, :], n).min(dim=1).values
        nxt = torch.minimum(lab, nbr.to(torch.int32))
        changed = bool(torch.any(nxt != lab))
        lab = nxt
        if not changed:
            return lab


# ---------------------------------------------------------------------------
# Betweenness: batched all-sources Brandes
# ---------------------------------------------------------------------------

@_full_float32
def betweenness_centrality(a: _Adj, normalized: bool = True,
                           device=None) -> torch.Tensor:
    """Shortest-path betweenness for undirected graphs (nx defaults).

    Brandes' algorithm vectorized over ALL sources simultaneously. With
    ``dist``/``sigma``/``delta`` as [S, N] matrices (S = N sources), each
    BFS level of the forward (path-counting) pass and the backward
    (dependency) pass is one dense product:

      forward:   σ_d   += ((σ ⊙ [dist = d-1]) @ A) ⊙ [dist = d]
      backward:  δ_d-1 += σ ⊙ (((1+δ) / σ ⊙ [dist = d]) @ Aᵀ) ⊙ [dist = d-1]

    which is the level-set form of Brandes' predecessor sums. Accumulation
    skips w = s (delta[s, s] never counts), matching the sequential
    algorithm. ``normalized=True`` divides by (n-1)(n-2); ``False`` halves
    (undirected double count) — both per nx._rescale.
    """
    a = (_as_dense(a, device) > 0).float()
    a = torch.maximum(a, a.T)
    n = a.shape[0]
    dist = bfs_distances(a)  # [S, N]
    reach = dist != _UNREACHED
    maxd = int(torch.where(reach, dist, 0).max())

    sigma = torch.eye(n, device=a.device)
    for d in range(1, maxd + 1):
        prev = torch.where(dist == d - 1, sigma, 0.0)
        sigma = sigma + (prev @ a) * (dist == d)

    delta = torch.zeros((n, n), device=a.device)
    for d in range(maxd, 0, -1):
        coeff = torch.where(dist == d,
                            (1.0 + delta) / torch.clamp_min(sigma, 1e-30),
                            0.0)
        delta = delta + (coeff @ a.T) * (dist == d - 1) * sigma
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    bc = torch.where(eye, 0.0, delta).sum(dim=0)
    scale = 1.0 / max((n - 1) * (n - 2), 1) if normalized else 0.5
    return bc * scale
