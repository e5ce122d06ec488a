"""Fanout neighbour sampling on the host for mini-batch GraphSAGE.

Port of the JAX package's ``sampling/neighbor.py``: per hop, each frontier
node draws ``fanout`` neighbours with replacement (fixed shapes); a node
without neighbours repeats itself. ``sample_neighbors`` draws from the C++
engine (``sampling/native.py``) by default, as JAX's does: one seed drawn
from ``rng`` and the engine's own generator, so the same ``rng`` gives the
draws of JAX's engine, and ``multihop_sampling`` passes nothing, so the
sampled GraphSAGE loops draw from it. With ``use_native=False`` the numpy
sampler draws exactly what JAX's does with ``use_native=False`` from the
same ``rng``, with one difference: JAX's numpy path reads ``indices`` one
past its end for a node without neighbours whose CSR row starts there (the
last nodes, when they have none) and raises; the port clamps that read,
whose value is never used.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import native


def _take(indices, pos):
    """``indices[pos]``, with a position past the end (a node without
    neighbours at the end of the CSR, whose draw is not used) clamped."""
    if len(indices) == 0:
        return np.zeros(np.shape(pos), np.int32)
    return indices[np.minimum(pos, len(indices) - 1)]


def sample_neighbors(nodes: np.ndarray, fanout: int, indptr, indices,
                     rng: np.random.Generator,
                     use_native: bool = True) -> np.ndarray:
    """[len(nodes) * fanout] int32 neighbours drawn with replacement.
    ``use_native`` draws on the C++ engine."""
    if use_native:
        return native.sample_neighbors_native(
            indptr, indices, np.asarray(nodes, np.int64).ravel(), fanout,
            int(rng.integers(0, 2**62)))
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
