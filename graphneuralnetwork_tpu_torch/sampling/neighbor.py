"""Fanout neighbour sampling on the host (numpy) for mini-batch GraphSAGE.

Port of ``graphneuralnetwork_tpu/sampling/neighbor.py``: per hop, each
frontier node draws ``fanout`` neighbours with replacement (fixed shapes);
a node without neighbours repeats itself. The JAX ``sample_neighbors``
prefers its C++ engine (``sampling/native.py``), whose draws come from
another generator, and draws its seed from ``rng`` before it learns
whether the engine exists. The port has no native engine yet: this numpy
sampler is its only path, and it draws exactly what the JAX function draws
with ``use_native=False`` from the same ``rng`` (nothing else). One
difference: JAX's numpy path reads ``indices`` one past its end for a node
without neighbours whose CSR row starts there (the last nodes, when they
have none) and raises; the port clamps that read, whose value is never
used.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _take(indices, pos):
    """``indices[pos]``, with a position past the end (a node without
    neighbours at the end of the CSR, whose draw is not used) clamped."""
    if len(indices) == 0:
        return np.zeros(np.shape(pos), np.int32)
    return indices[np.minimum(pos, len(indices) - 1)]


def sample_neighbors(nodes: np.ndarray, fanout: int, indptr, indices,
                     rng: np.random.Generator) -> np.ndarray:
    """[len(nodes) * fanout] int32 neighbours drawn with replacement."""
    nodes = np.asarray(nodes, np.int64).ravel()
    deg = (indptr[1:] - indptr[:-1])[nodes]
    off = (rng.random((len(nodes), fanout)) *
           np.maximum(deg, 1)[:, None]).astype(np.int64)
    nbrs = _take(indices, indptr[nodes][:, None] + off)
    self_rep = np.broadcast_to(nodes[:, None], nbrs.shape)
    return np.where(deg[:, None] > 0, nbrs, self_rep).ravel().astype(np.int32)


def multihop_sampling(nodes: np.ndarray, fanouts: Sequence[int],
                      indptr, indices,
                      rng: np.random.Generator) -> List[np.ndarray]:
    """[hop 0 nodes, hop 1 nodes, ...] flat int32 arrays; hop k has
    len(nodes) * prod(fanouts[:k]) entries."""
    result = [np.asarray(nodes, np.int32).ravel()]
    for f in fanouts:
        result.append(sample_neighbors(result[-1], f, indptr, indices, rng))
    return result
