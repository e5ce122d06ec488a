"""Alias-method O(1) weighted sampling (numpy).

Port of ``build_alias_table`` and ``sample_alias`` from
``graphneuralnetwork_tpu/sampling/alias.py``, which ``NegativeSampler``
draws with; the same inputs and ``rng`` give the same tables and draws.
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
