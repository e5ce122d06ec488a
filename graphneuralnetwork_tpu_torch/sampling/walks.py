"""CSR construction and uniform random walks on the host (numpy).

Port of ``csr_from_edges`` and the numpy path of ``uniform_walks`` from
``graphneuralnetwork_tpu/sampling/walks.py``: every walker advances in
lock-step with vectorised draws, so a [n_walks, length] walk matrix takes
O(length) numpy steps. The JAX package prefers its C++ engine
(``sampling/native.py``), whose draws come from another generator; the
port has no native engine yet, so its walks are those of the JAX function
with ``use_native=False``, draw for draw from the same ``rng``, except
that a walker at a node without neighbours at the end of the CSR does not
read ``indices`` past its end (where JAX's numpy path raises).

CSR convention: ``(indptr, indices)`` with the neighbours of node v at
``indices[indptr[v]:indptr[v+1]]``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
                  rng: np.random.Generator) -> np.ndarray:
    """[n_starts, length] int32 uniform walks; a walker at a node without
    neighbours stays there."""
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
