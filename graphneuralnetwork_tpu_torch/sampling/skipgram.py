"""The skip-gram data pipeline (numpy, on the host).

Port of ``graphneuralnetwork_tpu/sampling/skipgram.py``:
``token_frequencies``, ``subsample`` (frequency discard, P(keep) =
sqrt(t / f)), ``centers_and_contexts`` (random half-window contexts),
``NegativeSampler`` (weight^0.75 negatives, the positive rejected),
``TypedNegativeSampler`` (MetaPath2Vec's alternating-type negatives),
``batchify`` (contexts and negatives padded into rows with labels and
masks), ``skipgram_dataset`` and ``minibatches``. The same walks and
``rng`` give the same arrays, draw for draw.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from .alias import build_alias_table, sample_alias


def token_frequencies(walks: np.ndarray, n_tokens: int) -> np.ndarray:
    """int64 [n_tokens] counts of the walks' tokens (-1 marks a dropped
    position and is not counted)."""
    flat = walks.ravel()
    flat = flat[flat >= 0]
    return np.bincount(flat, minlength=n_tokens).astype(np.int64)


def subsample(walks: np.ndarray, n_tokens: int,
              rng: np.random.Generator, t: float = 1e-4) -> np.ndarray:
    """int64 walks with each position dropped (set to -1) unless a uniform
    falls below min(sqrt(t / f), 1), f its token's frequency."""
    counts = token_frequencies(walks, n_tokens)
    total = counts.sum()
    freq = counts / max(total, 1)
    keep_p = np.minimum(np.sqrt(t / np.maximum(freq, 1e-12)), 1.0)
    u = rng.random(walks.shape)
    return np.where(u < keep_p[walks], walks, -1).astype(np.int64)


def centers_and_contexts(walks: np.ndarray, window: int,
                         rng: np.random.Generator):
    """(centers [P], contexts [P, 2 * window] padded -1): every valid
    position with at least one context, its contexts the valid tokens
    within a half-window drawn in [1, window], in offset order."""
    n, L = walks.shape
    win = rng.integers(1, window + 1, size=(n, L))
    offs = np.arange(-window, window + 1)
    offs = offs[offs != 0]
    pos = np.arange(L)
    ctx_buf = np.full((n, L, 2 * window), -1, np.int64)
    fill = np.zeros((n, L), np.int64)
    for o in offs:
        valid_pos = (pos + o >= 0) & (pos + o < L)
        take = np.zeros((n, L), bool)
        take[:, valid_pos] = True
        vals = walks[:, np.clip(pos + o, 0, L - 1)]
        m = take & (np.abs(o) <= win) & (vals >= 0) & (walks >= 0)
        idx_n, idx_l = np.nonzero(m)
        ctx_buf[idx_n, idx_l, fill[idx_n, idx_l]] = vals[idx_n, idx_l]
        fill[idx_n, idx_l] += 1
    idx_n, idx_l = np.nonzero((walks >= 0) & (fill > 0))
    return walks[idx_n, idx_l], ctx_buf[idx_n, idx_l]


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


class TypedNegativeSampler:
    """Alternating-type negatives for a bipartite skip-gram: a row's noise
    words alternate between the two token types (0, 1), starting with the
    type opposite its last context token, each type drawn from its own
    weight^power table; draws equal to a context of the row are redrawn in
    up to three passes."""

    def __init__(self, weights: np.ndarray, token_types: np.ndarray,
                 power: float = 0.75):
        self.types = np.asarray(token_types, np.int64)
        if not set(np.unique(self.types)) <= {0, 1}:
            raise ValueError("typed negatives need token types 0 and 1")
        w = np.asarray(weights, np.float64) ** power
        self.ids = []
        self.tables = []
        for t in (0, 1):
            ids = np.flatnonzero(self.types == t)
            self.ids.append(ids)
            self.tables.append(build_alias_table(np.maximum(w[ids], 1e-12)))

    def _draw_all(self, shape, slot_types, rng):
        out = np.zeros(shape, np.int64)
        for t in (0, 1):
            accept, alias = self.tables[t]
            loc = sample_alias(accept, alias, rng, shape)
            out = np.where(slot_types == t, self.ids[t][loc], out)
        return out

    def draw(self, contexts: np.ndarray, num_negatives: int,
             rng: np.random.Generator) -> np.ndarray:
        """contexts [P, C] padded -1 -> negatives [P, C * num_negatives],
        -1 beyond num_negatives times the row's context count."""
        P, C = contexts.shape
        K = C * num_negatives
        n_ctx = (contexts >= 0).sum(1)
        last_ctx = contexts[np.arange(P), np.maximum(n_ctx - 1, 0)]
        last_type = self.types[np.maximum(last_ctx, 0)]
        j = np.arange(K)[None, :]
        slot_types = (1 - last_type[:, None] + j) % 2
        out = self._draw_all((P, K), slot_types, rng)
        for _ in range(3):
            bad = (out[:, :, None] == contexts[:, None, :]).any(-1)
            if not bad.any():
                break
            out = np.where(bad, self._draw_all((P, K), slot_types, rng),
                           out)
        keep = j < (num_negatives * n_ctx)[:, None]
        return np.where(keep, out, -1)


def batchify(centers: np.ndarray, contexts: np.ndarray,
             negatives: np.ndarray):
    """(centers int32 [P], ctx_neg int32 [P, C + K], labels float32, mask
    float32): contexts then negatives in one row, label 1 on a context, 0
    on a negative, mask 0 (and id 0) on padding."""
    P, _ = contexts.shape
    K = negatives.shape[1]
    ctx_neg = np.concatenate([contexts, negatives], axis=1)
    labels = np.concatenate(
        [(contexts >= 0).astype(np.float32), np.zeros((P, K), np.float32)],
        axis=1)
    mask = (ctx_neg >= 0).astype(np.float32)
    ctx_neg = np.where(ctx_neg >= 0, ctx_neg, 0)
    return centers.astype(np.int32), ctx_neg.astype(np.int32), labels, mask


def skipgram_dataset(
    walks: np.ndarray, n_tokens: int, *,
    window: int = 5, num_negatives: int = 5,
    rng: Optional[np.random.Generator] = None,
    subsample_t: Optional[float] = 1e-4,
    neg_weights: Optional[np.ndarray] = None,
    token_types: Optional[np.ndarray] = None,
):
    """walks -> (centers, ctx_neg, labels, mask) of the whole corpus:
    subsampling (unless ``subsample_t`` is None), contexts, and
    ``num_negatives`` negatives per context from the walks' token counts
    (or ``neg_weights``); ``token_types`` switches to the typed draw."""
    rng = rng or np.random.default_rng(0)
    counts = token_frequencies(walks, n_tokens)
    sent = (subsample(walks, n_tokens, rng, subsample_t)
            if subsample_t else walks.astype(np.int64))
    centers, contexts = centers_and_contexts(sent, window, rng)
    weights = (neg_weights if neg_weights is not None
               else np.maximum(counts, 1))
    if token_types is not None:
        typed = TypedNegativeSampler(weights, token_types)
        return batchify(centers, contexts,
                        typed.draw(contexts, num_negatives, rng))
    sampler = NegativeSampler(weights)
    n_ctx = (contexts >= 0).sum(1)
    K = int(num_negatives * max(contexts.shape[1], 1))
    negs = sampler.draw((len(centers), K), rng)
    keep = np.arange(K)[None, :] < (num_negatives * n_ctx)[:, None]
    return batchify(centers, contexts, np.where(keep, negs, -1))


def minibatches(arrays: Sequence[np.ndarray], batch_size: int,
                rng: np.random.Generator, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[tuple]:
    """Tuples of ``batch_size`` rows of every array, in an order shuffled
    by ``rng``; the last partial batch is dropped unless
    ``drop_remainder`` is False."""
    n = len(arrays[0])
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        sel = idx[i:i + batch_size]
        yield tuple(a[sel] for a in arrays)
