"""Edge-list datasets for the walk embedders (numpy, on the host).

Port of the first half of ``graphneuralnetwork_tpu/data/edgelist.py``:
``EdgeListData``, ``read_edgelist`` (whitespace edge lists with string
node names mapped to contiguous ids, index 0 ``<UNK>``),
``synthetic_smallworld`` (the deterministic stand-in for the reference's
airport and Wiki edge lists) and ``load_edgelist``. The same file or seed
gives the same arrays. JAX parses numeric files with its C++ engine and
rebuilds the vocabulary vectorised; the port parses in Python and takes
the same vectorised rebuild (``_vocab_from_int_tokens``) when every token
is a plain integer, which gives the ids of the Python path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.hetero import Vocab


@dataclass(frozen=True)
class EdgeListData:
    n_nodes: int
    senders: np.ndarray
    receivers: np.ndarray
    weights: np.ndarray
    vocab: Optional[Vocab] = None


def _vocab_from_int_tokens(a: np.ndarray, b: np.ndarray) -> tuple:
    """The ``Vocab`` of the interleaved tokens ``a[0], b[0], a[1], ...``
    (frequency descending, ties by first occurrence), built vectorised from
    integer arrays; returns (vocab, ids of a, ids of b)."""
    toks = np.empty(2 * len(a), np.int64)
    toks[0::2], toks[1::2] = a, b
    uniq, first_idx, counts = np.unique(
        toks, return_index=True, return_counts=True)
    order = np.lexsort((first_idx, -counts))
    vocab = Vocab()
    vocab.token_freqs = [(str(int(uniq[o])), int(counts[o])) for o in order]
    for t, _ in vocab.token_freqs:
        vocab.token_to_idx[t] = len(vocab.idx_to_token)
        vocab.idx_to_token.append(t)
    rank_to_id = np.empty(len(uniq), np.int32)
    rank_to_id[order] = np.arange(1, len(uniq) + 1, dtype=np.int32)  # 0=<UNK>
    ids = rank_to_id[np.searchsorted(uniq, toks)]
    return vocab, ids[0::2], ids[1::2]


def _plain_int(token: str) -> bool:
    """Whether ``token`` is the decimal form of an integer (``str(int(t))
    == t``), so that the integer rebuild keeps its string."""
    body = token[1:] if token.startswith("-") else token
    return body.isdigit() and str(int(token)) == token


def read_edgelist(path: str, weighted: bool = False,
                  directed: bool = False) -> EdgeListData:
    """Whitespace edge list (``a b [w]`` a line; lines with fewer than two
    fields are skipped) -> contiguous ids; an undirected graph stores both
    directions, the reverse edges after the forward ones."""
    tokens: List[Tuple[str, str, float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            wv = float(parts[2]) if (weighted and len(parts) > 2) else 1.0
            tokens.append((parts[0], parts[1], wv))
    w = np.array([x for _, _, x in tokens], np.float32)
    if tokens and all(_plain_int(a) and _plain_int(b)
                      for a, b, _ in tokens):
        vocab, s, r = _vocab_from_int_tokens(
            np.array([int(a) for a, _, _ in tokens], np.int64),
            np.array([int(b) for _, b, _ in tokens], np.int64))
    else:
        vocab = Vocab([t for a, b, _ in tokens for t in (a, b)])
        s = np.array([vocab[a] for a, _, _ in tokens], np.int32)
        r = np.array([vocab[b] for _, b, _ in tokens], np.int32)
    if not directed:
        s, r, w = (np.concatenate([s, r]), np.concatenate([r, s]),
                   np.concatenate([w, w]))
    return EdgeListData(len(vocab), s, r, w, vocab)


def synthetic_smallworld(n_nodes: int = 500, k: int = 6,
                         rewire: float = 0.2,
                         seed: int = 0) -> EdgeListData:
    """Watts-Strogatz-style ring: each node links to its ``k // 2``
    successors, each link rewired to a random node with probability
    ``rewire``; both directions stored, unit weights."""
    rng = np.random.default_rng(seed)
    s, r = [], []
    for v in range(n_nodes):
        for j in range(1, k // 2 + 1):
            u = (v + j) % n_nodes
            if rng.random() < rewire:
                u = int(rng.integers(0, n_nodes))
                if u == v:
                    u = (v + 1) % n_nodes
            s.append(v)
            r.append(u)
    s = np.array(s, np.int32)
    r = np.array(r, np.int32)
    s2 = np.concatenate([s, r])
    r2 = np.concatenate([r, s])
    w = np.ones(len(s2), np.float32)
    return EdgeListData(n_nodes, s2, r2, w)


def load_edgelist(path: str | None = None, weighted: bool = False,
                  seed: int = 0) -> EdgeListData:
    """``read_edgelist(path)`` if the file exists, else the 500-node
    ``synthetic_smallworld(seed=seed)``."""
    if path is not None and os.path.exists(path):
        return read_edgelist(path, weighted=weighted)
    return synthetic_smallworld(seed=seed)
