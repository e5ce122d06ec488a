"""Heterogeneous graph containers and metapath composition.

Port of ``graphneuralnetwork_tpu/core/hetero.py``: relations keyed by
(src_type, rel_name, dst_type) hold numpy edge lists on the host; a
metapath is composed by chained sparse joins (numpy only) and built into
the port's padded ``Graph`` on ``device`` (the card unless the caller asks
for the CPU). ``BipartiteGraph`` is the user-item form with its 2-hop
projections.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .graph import (Graph, build_graph, row_normalize_weights,
                    sym_normalize_weights)


def _coalesce(s, d, w, n_dst: int):
    """Merge duplicate (s, d) pairs, summing weights (vectorised)."""
    if len(s) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    base = max(n_dst, int(d.max(initial=0)) + 1)
    key = s.astype(np.int64) * base + d
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], w[order]
    uniq_mask = np.empty(len(key_s), bool)
    uniq_mask[0] = True
    uniq_mask[1:] = key_s[1:] != key_s[:-1]
    starts = np.flatnonzero(uniq_mask)
    sums = np.add.reduceat(w_s, starts)
    uk = key_s[starts]
    return ((uk // base).astype(np.int32), (uk % base).astype(np.int32),
            sums.astype(np.float32))


def _sparse_join(s1, d1, w1, s2, d2, w2):
    """(A·B) as an edge join on the shared middle index (sort-join with
    searchsorted + repeat)."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.float32))
    if len(s1) == 0 or len(s2) == 0:
        return empty
    order = np.argsort(s2, kind="stable")
    s2s, d2s, w2s = s2[order], d2[order], w2[order]
    lo = np.searchsorted(s2s, d1, side="left")
    hi = np.searchsorted(s2s, d1, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return empty
    rep = np.repeat(np.arange(len(s1)), cnt)
    offsets = np.cumsum(cnt) - cnt
    within = np.arange(total) - np.repeat(offsets, cnt)
    idx = np.repeat(lo, cnt) + within
    return (s1[rep].astype(np.int32), d2s[idx].astype(np.int32),
            (w1[rep] * w2s[idx]).astype(np.float32))


class Vocab:
    """Token-index mapping with a ``min_freq`` cutoff; index 0 is
    ``<UNK>``."""

    def __init__(self, tokens=None, min_freq: int = 0,
                 reserved_tokens: Optional[List[str]] = None):
        counter = Counter()
        if tokens:
            if isinstance(tokens[0], (list, tuple)):
                for line in tokens:
                    counter.update(line)
            else:
                counter.update(tokens)
        self.token_freqs = sorted(counter.items(), key=lambda x: x[1],
                                  reverse=True)
        self.idx_to_token = ["<UNK>"] + (reserved_tokens or [])
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}
        for tok, freq in self.token_freqs:
            if freq < min_freq:
                break
            if tok not in self.token_to_idx:
                self.token_to_idx[tok] = len(self.idx_to_token)
                self.idx_to_token.append(tok)

    def __len__(self):
        return len(self.idx_to_token)

    @property
    def unk(self) -> int:
        return 0

    def __getitem__(self, tokens):
        if isinstance(tokens, (list, tuple)):
            return [self[t] for t in tokens]
        return self.token_to_idx.get(tokens, self.unk)

    def to_tokens(self, indices):
        if isinstance(indices, (list, tuple)):
            return [self.idx_to_token[i] for i in indices]
        return self.idx_to_token[indices]


class HeteroGraph:
    """Relations keyed by (src_type, rel_name, dst_type) -> edge arrays.

    ``node_counts`` maps node type -> count. Edges are stored src -> dst;
    all indices are per-type local ids.
    """

    def __init__(self, node_counts: Dict[str, int]):
        self.node_counts = dict(node_counts)
        self.relations: Dict[Tuple[str, str, str],
                             Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._adj_cache: Dict[Tuple[str, str, str],
                              Dict[int, np.ndarray]] = {}

    def add_relation(self, key: Tuple[str, str, str],
                     src: np.ndarray, dst: np.ndarray,
                     weight: Optional[np.ndarray] = None):
        src = np.asarray(src, np.int32).ravel()
        dst = np.asarray(dst, np.int32).ravel()
        if weight is None:
            weight = np.ones(len(src), np.float32)
        self.relations[key] = (src, dst, np.asarray(weight, np.float32))
        return self

    def reverse(self, key) -> Tuple[str, str, str]:
        s, r, d = key
        return (d, f"{r}_rev", s)

    def add_reverse_relations(self):
        for key in list(self.relations):
            rkey = self.reverse(key)
            if rkey not in self.relations:
                src, dst, w = self.relations[key]
                self.relations[rkey] = (dst, src, w)
        return self

    def neighbors(self, key) -> Dict[int, np.ndarray]:
        """Per-source neighbour lists of a relation (cached)."""
        cached = self._adj_cache.get(key)
        if cached is not None:
            return cached
        src, dst, _ = self.relations[key]
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        bounds = np.searchsorted(
            src_s, np.arange(self.node_counts[key[0]] + 1))
        adj = {i: dst_s[bounds[i]:bounds[i + 1]]
               for i in range(self.node_counts[key[0]])
               if bounds[i + 1] > bounds[i]}
        self._adj_cache[key] = adj
        return adj

    def compose(self, keys: Sequence[Tuple[str, str, str]],
                binarize: bool = True):
        """Chained sparse matrix product over a relation sequence: (src,
        dst, weight) edge arrays from the first relation's src type to the
        last relation's dst type, the weight counting paths; ``binarize``
        sets every weight to 1."""
        for a, b in zip(keys[:-1], keys[1:]):
            assert a[2] == b[0], f"metapath type mismatch: {a} -> {b}"
        s, d, w = self.relations[keys[0]]
        s, d, w = _coalesce(s, d, w, self.node_counts[keys[0][2]])
        for key in keys[1:]:
            s2, d2, w2 = self.relations[key]
            s, d, w = _sparse_join(s, d, w, s2, d2, w2)
            s, d, w = _coalesce(s, d, w, self.node_counts[key[2]])
        if binarize:
            w = np.ones_like(w)
        return s, d, w

    def metapath_graph(self, keys: Sequence[Tuple[str, str, str]],
                       normalize: str = "sym", self_loops: bool = True,
                       binarize: bool = True, *,
                       device: str | torch.device = "cuda") -> Graph:
        """Compose a metapath and build its padded ``Graph`` on ``device``
        with GCN-style (``sym``) or random-walk (``row``) weights."""
        s, d, w = self.compose(keys, binarize=binarize)
        n = self.node_counts[keys[0][0]]
        assert keys[-1][2] == keys[0][0], (
            "metapath must return to its start type for a square adjacency")
        if self_loops:
            loops = np.arange(n, dtype=np.int32)
            keep = s != d
            s = np.concatenate([s[keep], loops])
            d = np.concatenate([d[keep], loops])
            w = np.concatenate([w[keep], np.ones(n, np.float32)])
        if normalize == "sym":
            w = sym_normalize_weights(s, d, n, w)
        elif normalize == "row":
            w = row_normalize_weights(s, d, n, w)
        return build_graph(s, d, n, w, device=device)


class BipartiteGraph(HeteroGraph):
    """User-item bipartite graph: node types ``u`` and ``v``, weighted
    edges both ways."""

    def __init__(self, n_users: int, n_items: int,
                 u: np.ndarray, v: np.ndarray,
                 weight: Optional[np.ndarray] = None):
        super().__init__({"u": n_users, "v": n_items})
        self.add_relation(("u", "rate", "v"), u, v, weight)
        self.add_relation(("v", "rated_by", "u"), v, u, weight)

    def homogeneous_projection(self, node_type: str, *,
                               device: str | torch.device = "cuda"
                               ) -> Graph:
        """The 2-hop projection (u-v-u or v-u-v) without self pairs, path
        counts as weights, on ``device``."""
        if node_type == "u":
            keys = [("u", "rate", "v"), ("v", "rated_by", "u")]
        else:
            keys = [("v", "rated_by", "u"), ("u", "rate", "v")]
        s, d, w = self.compose(keys, binarize=False)
        keep = s != d
        return build_graph(s[keep], d[keep], self.node_counts[node_type],
                           w[keep], device=device)
