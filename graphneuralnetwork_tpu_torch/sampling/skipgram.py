"""Negative sampling (numpy): the port of ``NegativeSampler`` from
``graphneuralnetwork_tpu/sampling/skipgram.py``, which the unsupervised
GraphSAGE loop draws its negatives with. The same weights and ``rng`` give
the same draws."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .alias import build_alias_table, sample_alias


class NegativeSampler:
    """Negatives drawn from weight^power by an alias table, rejecting the
    positive context (``exclude``) in up to three redraws."""

    def __init__(self, weights: np.ndarray, power: float = 0.75):
        w = np.asarray(weights, np.float64) ** power
        self.accept, self.alias = build_alias_table(w)

    def draw(self, shape, rng: np.random.Generator,
             exclude: Optional[np.ndarray] = None) -> np.ndarray:
        out = sample_alias(self.accept, self.alias, rng, shape)
        if exclude is not None:
            for _ in range(3):  # rejection passes
                bad = out == exclude
                if not bad.any():
                    break
                out = np.where(
                    bad, sample_alias(self.accept, self.alias, rng, shape),
                    out)
        return out
