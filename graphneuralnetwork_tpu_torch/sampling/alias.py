"""Alias-method O(1) weighted sampling (numpy).

Port of ``build_alias_table``, ``sample_alias``, ``ConcatAliasTables`` and
``CachedWeightedSampler`` from ``graphneuralnetwork_tpu/sampling/alias.py``:
``NegativeSampler`` draws with the first two, the weighted, node2vec and
struc2vec walkers with the packed tables. The same inputs and ``rng`` give the same tables
and draws.
"""

from __future__ import annotations

import numpy as np


def build_alias_table(probs: np.ndarray):
    """One alias table for unnormalised ``probs``: (accept float32 [n],
    alias int32 [n])."""
    probs = np.asarray(probs, np.float64)
    n = len(probs)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    scaled = probs * n / probs.sum()
    accept = np.zeros(n, np.float64)
    alias = np.zeros(n, np.int32)
    small = [i for i, p in enumerate(scaled) if p < 1.0]
    large = [i for i, p in enumerate(scaled) if p >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for rest in (small, large):
        while rest:
            accept[rest.pop()] = 1.0
    return accept.astype(np.float32), alias


def sample_alias(accept, alias, rng: np.random.Generator, size):
    """``size`` draws from one alias table."""
    n = len(accept)
    i = rng.integers(0, n, size)
    keep = rng.random(size) < accept[i]
    return np.where(keep, i, alias[i])


class ConcatAliasTables:
    """Many alias tables packed into flat arrays: table t occupies
    ``[offsets[t], offsets[t + 1])`` of ``accept`` and ``alias``."""

    def __init__(self, tables: list[np.ndarray]):
        self.sizes = np.array([len(t) for t in tables], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        accepts, aliases = [], []
        for t in tables:
            a, al = build_alias_table(t) if len(t) else (
                np.zeros(0, np.float32), np.zeros(0, np.int32))
            accepts.append(a)
            aliases.append(al)
        self.accept = (np.concatenate(accepts) if accepts
                       else np.zeros(0, np.float32))
        self.alias = (np.concatenate(aliases) if aliases
                      else np.zeros(0, np.int32))

    def draw(self, t_idx: np.ndarray, rng: np.random.Generator):
        """One local index in each table of ``t_idx`` (tables must be
        non-empty): a uniform slot, kept with its ``accept`` probability,
        else its alias."""
        t_idx = np.asarray(t_idx, np.int64)
        sz = self.sizes[t_idx]
        base = self.offsets[t_idx]
        i = (rng.random(len(t_idx)) * sz).astype(np.int64)
        g = base + i
        keep = rng.random(len(t_idx)) < self.accept[g]
        return np.where(keep, i, self.alias[g])


class CachedWeightedSampler:
    """Batch-cached weighted draws — the ``RandomGenerator`` pattern
    (GraphEmbedding/DeepWalk/data_utils.py:97-113) backed by an alias table
    instead of random.choices."""

    def __init__(self, weights, rng: np.random.Generator,
                 cache: int = 10000):
        self.accept, self.alias = build_alias_table(np.asarray(weights))
        self.rng = rng
        self.cache = cache
        self._buf = None
        self._i = 0

    def draw(self) -> int:
        """One draw, from a buffer of ``cache`` draws refilled when spent."""
        if self._buf is None or self._i >= len(self._buf):
            self._buf = sample_alias(self.accept, self.alias, self.rng,
                                     self.cache)
            self._i = 0
        v = int(self._buf[self._i])
        self._i += 1
        return v

    def draw_batch(self, size: int) -> np.ndarray:
        return sample_alias(self.accept, self.alias, self.rng, size)
