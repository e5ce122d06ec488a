"""Edge-list datasets for the walk embedders (numpy, on the host).

Port of ``graphneuralnetwork_tpu/data/edgelist.py``:
``EdgeListData``, ``read_edgelist`` (whitespace edge lists with string
node names mapped to contiguous ids, index 0 ``<UNK>``),
``synthetic_smallworld`` (the deterministic stand-in for the reference's
airport and Wiki edge lists) and ``load_edgelist``. The same file or seed
gives the same arrays. Numeric files are parsed by the C++ engine
(``sampling/native.py``) and their vocabulary rebuilt vectorised
(``_vocab_from_int_tokens``), as in JAX, which gives the ids of the Python
path that reads any other file as strings. GATNE's
multiplex half: ``MultiplexData`` (training edges per edge type with
held-out true and false edges), ``synthetic_multiplex`` (a community
multiplex graph), ``read_multiplex_dir`` (``train.txt``, ``valid.txt``,
``test.txt``) and ``load_multiplex``, the same arrays as JAX's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.hetero import Vocab
from ..sampling import native


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


def _read_tokens(path: str, weighted: bool) -> tuple:
    """The Python path of ``read_edgelist``: (vocab, ids of the first
    column, ids of the second, weights)."""
    tokens: List[Tuple[str, str, float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            wv = float(parts[2]) if (weighted and len(parts) > 2) else 1.0
            tokens.append((parts[0], parts[1], wv))
    vocab = Vocab([t for a, b, _ in tokens for t in (a, b)])
    s = np.array([vocab[a] for a, _, _ in tokens], np.int32)
    r = np.array([vocab[b] for _, b, _ in tokens], np.int32)
    w = np.array([x for _, _, x in tokens], np.float32)
    return vocab, s, r, w


def read_edgelist(path: str, weighted: bool = False,
                  directed: bool = False) -> EdgeListData:
    """Whitespace edge list (``a b [w]`` a line; lines with fewer than two
    fields are skipped) -> contiguous ids; an undirected graph stores both
    directions, the reverse edges after the forward ones. Numeric files
    are parsed by the C++ engine."""
    parsed = native.parse_edgelist_native(path, weighted=weighted)
    if parsed is not None:
        pa, pb, w = parsed
        vocab, s, r = _vocab_from_int_tokens(pa, pb)
    else:
        vocab, s, r, w = _read_tokens(path, weighted)
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


@dataclass(frozen=True)
class MultiplexData:
    """Typed edges for GATNE (GATNE/utils/data_utils.py:11-51):
    training edges per type + val/test true/false edge lists."""
    n_nodes: int
    edge_types: List[str]
    train_edges: Dict[str, Tuple[np.ndarray, np.ndarray]]
    valid_true: Dict[str, Tuple[np.ndarray, np.ndarray]]
    valid_false: Dict[str, Tuple[np.ndarray, np.ndarray]]
    test_true: Dict[str, Tuple[np.ndarray, np.ndarray]]
    test_false: Dict[str, Tuple[np.ndarray, np.ndarray]]
    features: Optional[np.ndarray] = None
    vocab: Optional[Vocab] = None


def synthetic_multiplex(n_nodes: int = 400, n_types: int = 2,
                        avg_deg: int = 8, seed: int = 0) -> MultiplexData:
    """Community-structured multiplex graph (8 communities, 85 % of each
    node's edges inside its own) with a tenth of each type's edges held
    out for validation and a tenth for test, as many random false edges,
    and 32 normal features a node."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, 8, n_nodes)
    types = [str(t + 1) for t in range(n_types)]
    train, vt, vf, tt, tf = {}, {}, {}, {}, {}
    for t in range(n_types):
        s, r = [], []
        n_e = n_nodes * avg_deg // 2
        for _ in range(n_e):
            a = int(rng.integers(0, n_nodes))
            if rng.random() < 0.85:
                pool = np.flatnonzero(comm == comm[a])
                b = int(pool[rng.integers(0, len(pool))])
            else:
                b = int(rng.integers(0, n_nodes))
            if a != b:
                s.append(a)
                r.append(b)
        s = np.array(s, np.int32)
        r = np.array(r, np.int32)
        k = len(s)
        n_hold = max(k // 10, 10)
        perm = rng.permutation(k)
        hold_v = perm[:n_hold]
        hold_t = perm[n_hold:2 * n_hold]
        keep = perm[2 * n_hold:]
        train[types[t]] = (s[keep], r[keep])
        vt[types[t]] = (s[hold_v], r[hold_v])
        tt[types[t]] = (s[hold_t], r[hold_t])
        fv = rng.integers(0, n_nodes, (2, n_hold)).astype(np.int32)
        ft = rng.integers(0, n_nodes, (2, n_hold)).astype(np.int32)
        vf[types[t]] = (fv[0], fv[1])
        tf[types[t]] = (ft[0], ft[1])
    feats = rng.normal(size=(n_nodes, 32)).astype(np.float32)
    return MultiplexData(
        n_nodes=n_nodes, edge_types=types, train_edges=train,
        valid_true=vt, valid_false=vf, test_true=tt, test_false=tf,
        features=feats)


def read_multiplex_dir(root: str) -> MultiplexData:
    """GATNE data layout: train.txt/valid.txt/test.txt with lines
    '<type> <src> <dst>' (+ label column for valid/test false edges)."""
    def read_typed(path, with_label=False):
        true_e: Dict[str, list] = {}
        false_e: Dict[str, list] = {}
        with open(path) as f:
            for line in f:
                p = line.split()
                if len(p) < 3:
                    continue
                t, a, b = p[0], p[1], p[2]
                tgt = true_e
                if with_label and len(p) > 3 and p[3] == "0":
                    tgt = false_e
                tgt.setdefault(t, []).append((a, b))
        return true_e, false_e

    train_raw, _ = read_typed(os.path.join(root, "train.txt"))
    valid_t, valid_f = read_typed(os.path.join(root, "valid.txt"), True)
    test_t, test_f = read_typed(os.path.join(root, "test.txt"), True)

    names = [x for d in (train_raw, valid_t, test_t)
             for es in d.values() for e in es for x in e]
    vocab = Vocab(names)

    def conv(d):
        return {t: (np.array([vocab[a] for a, _ in es], np.int32),
                    np.array([vocab[b] for _, b in es], np.int32))
                for t, es in d.items()}

    types = sorted(train_raw.keys())
    return MultiplexData(
        n_nodes=len(vocab), edge_types=types,
        train_edges=conv(train_raw),
        valid_true=conv(valid_t), valid_false=conv(valid_f),
        test_true=conv(test_t), test_false=conv(test_f), vocab=vocab)


def load_multiplex(root: str | None = None, seed: int = 0) -> MultiplexData:
    """``read_multiplex_dir(root)`` if ``root`` holds a ``train.txt``, else
    the 400-node ``synthetic_multiplex(seed=seed)``."""
    if root is not None and os.path.exists(os.path.join(root, "train.txt")):
        return read_multiplex_dir(root)
    return synthetic_multiplex(seed=seed)
