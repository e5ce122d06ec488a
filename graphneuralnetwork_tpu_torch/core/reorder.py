"""Locality reordering (host numpy): relabel nodes so neighbours get nearby
indices.

Copy of ``graphneuralnetwork_tpu/core/reorder.py``, so that ``--layout
auto`` probes exactly the ordering the reference probes and makes the same
decision. ``perm[new_id] = old_id`` throughout.
"""

from __future__ import annotations

import numpy as np


def rcm_order(senders: np.ndarray, receivers: np.ndarray,
              n_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee permutation over the symmetrised pattern."""
    from scipy import sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    data = np.ones(2 * len(s), np.int8)
    a = sparse.csr_matrix(
        (data, (np.concatenate([s, r]), np.concatenate([r, s]))),
        shape=(n_nodes, n_nodes))
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                      dtype=np.int64)


def label_propagation(senders: np.ndarray, receivers: np.ndarray,
                      n_nodes: int, iters: int = 8) -> np.ndarray:
    """Community labels by synchronous majority label propagation (ties go
    to the smaller label)."""
    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    ss = np.concatenate([s, r])
    rr = np.concatenate([r, s])
    lab = np.arange(n_nodes, dtype=np.int64)
    for _ in range(iters):
        key = rr * n_nodes + lab[ss]
        uk, cnt = np.unique(key, return_counts=True)
        node = uk // n_nodes
        klab = uk % n_nodes
        order = np.lexsort((klab, -cnt, node))
        first = np.concatenate(
            [[True], node[order][1:] != node[order][:-1]])
        new = lab.copy()
        new[node[order][first]] = klab[order][first]
        if np.array_equal(new, lab):
            break
        lab = new
    return lab


def cluster_order(senders: np.ndarray, receivers: np.ndarray,
                  n_nodes: int, iters: int = 8) -> np.ndarray:
    """Permutation grouping nodes by propagated community label."""
    lab = label_propagation(senders, receivers, n_nodes, iters)
    return np.argsort(lab, kind="stable").astype(np.int64)


def locality_order(senders: np.ndarray, receivers: np.ndarray,
                   n_nodes: int) -> np.ndarray:
    """The ordering (RCM or label-propagation clusters) that puts more edge
    mass into dense 128x128 tiles, tie-broken by tile-store bytes (the
    reference's ``method="auto"``)."""
    from .layout import bcsr_memory_bytes, tiled_edge_fraction

    best_perm, best_key = None, None
    for cand in (rcm_order(senders, receivers, n_nodes),
                 cluster_order(senders, receivers, n_nodes)):
        s2, r2 = relabel_edges(cand, senders, receivers)
        key = (-tiled_edge_fraction(s2, r2, n_nodes),
               bcsr_memory_bytes(s2, r2, n_nodes))
        if best_key is None or key < best_key:
            best_perm, best_key = cand, key
    return best_perm


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def relabel_edges(perm: np.ndarray, senders: np.ndarray,
                  receivers: np.ndarray):
    """Relabel edge endpoints under ``perm[new] = old``."""
    inv = invert_permutation(np.asarray(perm, np.int64))
    return (inv[np.asarray(senders, np.int64)].astype(np.int32),
            inv[np.asarray(receivers, np.int64)].astype(np.int32))


def bandwidth_stats(senders: np.ndarray, receivers: np.ndarray) -> dict:
    """Locality diagnostics: the distribution of |s - r| over the edge
    list (max, mean, 95th percentile)."""
    d = np.abs(np.asarray(senders, np.int64) -
               np.asarray(receivers, np.int64))
    if len(d) == 0:
        return dict(max=0, mean=0.0, p95=0)
    return dict(max=int(d.max()), mean=float(d.mean()),
                p95=int(np.percentile(d, 95)))
