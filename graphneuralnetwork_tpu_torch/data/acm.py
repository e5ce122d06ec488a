"""ACM and IMDB heterogeneous datasets in HAN's and GTN's forms.

Port of ``graphneuralnetwork_tpu/data/acm.py``. HAN's form: the PAP
and PLP metapath graphs over papers (MAM and MDM over movies for IMDB),
row-normalised paper features and a float-mask split (<= 0.2 train,
<= 0.3 val, the rest test), drawn from the same
``np.random.default_rng(seed)`` streams as the reference, so every array
is equal. ``load_acm_han`` reads the reference's ``ACM.mat`` when a path
to one is given (scipy), and otherwise synthesises a class-structured ACM.

``layout="coo"`` builds each metapath as a sym-normalised ``Graph`` with
self loops; ``layout="hybrid"`` clusters the papers over the union of the
metapath edges and builds each metapath's binarised adjacency (self loops,
unit weights, float32 tiles in every compute dtype) as a ``HybridGraph``,
with features and labels permuted and the split indices mapped through the
inverse permutation; ``layout="auto"`` probes the clustered tile fill with
the attention objective and picks one of the two.

GTN's form (``load_acm_gtn``, ``load_imdb_gtn``): the dense stack
[T, N, N] of the edge-type adjacencies over all nodes (PA, AP, PL, LP and
the identity), features for every node, the papers' labels and per-class
splits (200 train and 100 validation papers a class, the rest test),
equal array for array to the reference's; it also reads the reference's
processed ``train.pkl``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.bcsr import HybridGraph, build_hybrid
from ..core.device import resolve_device
from ..core.graph import Graph, row_normalize_features
from ..core.hetero import HeteroGraph
from ..core.reorder import invert_permutation, locality_order, relabel_edges


@dataclass(frozen=True)
class HeteroNodeData:
    """Per-metapath graphs plus paper features, labels and splits."""

    graphs: List[Graph | HybridGraph]
    features: torch.Tensor     # float32[N, F] row-normalised
    labels: torch.Tensor       # int64[N]
    train_idx: torch.Tensor    # int64
    val_idx: torch.Tensor
    test_idx: torch.Tensor
    num_classes: int
    device: torch.device


@dataclass(frozen=True)
class StackedAdjData:
    """GTN's input: the dense edge-type stack and the target nodes' labels
    and splits."""

    adj: torch.Tensor          # float32[T, N, N], the identity slice last
    features: torch.Tensor     # float32[N, F] row-normalised
    labels: torch.Tensor       # int64[n_targets], of the target nodes
    target_idx: torch.Tensor   # int64: the target (paper) nodes' ids
    train_idx: torch.Tensor    # int64, into the target nodes
    val_idx: torch.Tensor
    test_idx: torch.Tensor
    num_classes: int
    device: torch.device


def synthetic_acm(n_papers: int = 600, n_authors: int = 300,
                  n_subjects: int = 20, n_feats: int = 128,
                  n_classes: int = 3, seed: int = 0):
    """Class-structured synthetic ACM: authors and subjects are
    class-biased, so PAP and PLP carry signal. Draws exactly the
    reference's random stream."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_papers).astype(np.int32)
    author_class = rng.integers(0, n_classes, n_authors).astype(np.int32)
    subject_class = (np.arange(n_subjects) % n_classes).astype(np.int32)

    # each paper has 2-3 authors, mostly of its class
    pa_p, pa_a = [], []
    for p in range(n_papers):
        k = rng.integers(2, 4)
        same = np.flatnonzero(author_class == labels[p])
        other = np.arange(n_authors)
        for _ in range(k):
            pool = same if (rng.random() < 0.8 and len(same)) else other
            pa_p.append(p)
            pa_a.append(int(pool[rng.integers(0, len(pool))]))
    # one subject per paper, 85 % class-aligned
    pl_p, pl_l = [], []
    for p in range(n_papers):
        same = np.flatnonzero(subject_class == labels[p])
        if rng.random() < 0.85 and len(same):
            subject = int(same[rng.integers(0, len(same))])
        else:
            subject = int(rng.integers(0, n_subjects))
        pl_p.append(p)
        pl_l.append(subject)

    feats = np.zeros((n_papers, n_feats), np.float32)
    wpc = n_feats // n_classes
    for p in range(n_papers):
        c = labels[p]
        idx = rng.integers(c * wpc, (c + 1) * wpc, size=8)
        feats[p, idx] = 1.0
        feats[p, rng.integers(0, n_feats, size=5)] = 1.0

    hg = HeteroGraph({"paper": n_papers, "author": n_authors,
                      "subject": n_subjects})
    hg.add_relation(("paper", "pa", "author"),
                    np.array(pa_p), np.array(pa_a))
    hg.add_relation(("author", "ap", "paper"),
                    np.array(pa_a), np.array(pa_p))
    hg.add_relation(("paper", "pl", "subject"),
                    np.array(pl_p), np.array(pl_l))
    hg.add_relation(("subject", "lp", "paper"),
                    np.array(pl_l), np.array(pl_p))
    return hg, feats, labels


def _load_acm_mat(path: str):
    """Read the reference's ACM.mat: PvsL, PvsA, PvsT (features) and PvsC,
    conferences 0, 1, 9, 10, 13 mapped to classes 0, 1, 2, 2, 1 and papers
    of other conferences dropped."""
    from scipy import io as sio

    data = sio.loadmat(path)
    p_vs_l = data["PvsL"]
    p_vs_a = data["PvsA"]
    p_vs_t = data["PvsT"]
    p_vs_c = data["PvsC"]
    conf_ids = [0, 1, 9, 10, 13]
    label_ids = [0, 1, 2, 2, 1]
    keep = np.asarray(p_vs_c[:, conf_ids].sum(1)).ravel() > 0
    p_vs_l = p_vs_l[keep]
    p_vs_a = p_vs_a[keep]
    p_vs_t = p_vs_t[keep]
    p_vs_c = p_vs_c[keep][:, conf_ids]
    labels = np.zeros(p_vs_c.shape[0], np.int32)
    for cid, lid in enumerate(label_ids):
        labels[np.asarray(p_vs_c[:, cid].todense()).ravel() > 0] = lid
    feats = np.asarray(p_vs_t.todense(), dtype=np.float32)

    pa = p_vs_a.tocoo()
    pl = p_vs_l.tocoo()
    hg = HeteroGraph({"paper": feats.shape[0], "author": p_vs_a.shape[1],
                      "subject": p_vs_l.shape[1]})
    hg.add_relation(("paper", "pa", "author"), pa.row, pa.col)
    hg.add_relation(("author", "ap", "paper"), pa.col, pa.row)
    hg.add_relation(("paper", "pl", "subject"), pl.row, pl.col)
    hg.add_relation(("subject", "lp", "paper"), pl.col, pl.row)
    return hg, feats, labels


_ACM_METAPATHS = (
    (("paper", "pa", "author"), ("author", "ap", "paper")),    # PAP
    (("paper", "pl", "subject"), ("subject", "lp", "paper")),  # PLP
)


def _hybrid_metapath_graphs(hg, n: int, metapaths, min_edges_per_tile: int,
                            perm=None, *,
                            device: str | torch.device = "cuda"):
    """Each metapath's binarised adjacency (self loops, unit weights) as a
    ``HybridGraph`` on ``device``, the nodes clustered over the union of
    the metapath edges (``perm``, e.g. from a ``choose_layout`` probe, or
    ``locality_order``). Metapath adjacencies (R·Rᵀ) are symmetric, so the
    forward tiles serve the backward. Returns ``(graphs, perm)``."""
    loops = np.arange(n, dtype=np.int64)
    edge_lists = []
    for keys in metapaths:
        s, d, _ = hg.compose(list(keys), binarize=True)
        keep = s != d
        edge_lists.append((np.concatenate([s[keep], loops]),
                           np.concatenate([d[keep], loops])))
    if perm is None:
        perm = locality_order(np.concatenate([e[0] for e in edge_lists]),
                              np.concatenate([e[1] for e in edge_lists]), n)
    graphs = []
    for s, d in edge_lists:
        s2, r2 = relabel_edges(perm, s, d)
        graphs.append(build_hybrid(s2, r2, n,
                                   min_edges_per_tile=min_edges_per_tile,
                                   symmetric=True, device=device))
    return graphs, perm


def _assemble_han_data(hg, feats, labels, seed: int, layout: str,
                       min_edges_per_tile: int,
                       device: torch.device) -> HeteroNodeData:
    """The HAN loaders' shared tail: the float-mask split, row-normalised
    features, and the layout branch."""
    n = feats.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    train = np.flatnonzero(u <= 0.2)
    val = np.flatnonzero((u > 0.2) & (u <= 0.3))
    test = np.flatnonzero(u > 0.3)
    feats = row_normalize_features(feats)

    probe_perm = None
    if layout == "auto":
        # probe the metapath edges with one self loop a node, in the
        # reference's order (the probe counts duplicate edges)
        from ..core.layout import choose_layout
        loops = np.arange(n, dtype=np.int64)
        parts_s, parts_r = [loops], [loops]
        for keys in _ACM_METAPATHS:
            s_m, d_m, _ = hg.compose(list(keys), binarize=True)
            keep = s_m != d_m
            parts_s.append(s_m[keep])
            parts_r.append(d_m[keep])
        layout, _, probe_perm = choose_layout(
            np.concatenate(parts_s), np.concatenate(parts_r), n,
            min_edges_per_tile=min_edges_per_tile,
            objective="attention",       # HAN's node attention is GAT
            verbose=True, tag="han-metapaths")

    if layout == "hybrid":
        graphs, perm = _hybrid_metapath_graphs(
            hg, n, _ACM_METAPATHS, min_edges_per_tile, perm=probe_perm,
            device=device)
        inv = invert_permutation(perm)
        feats, labels = feats[perm], labels[perm]
        train, val, test = inv[train], inv[val], inv[test]
    elif layout == "coo":
        graphs = [hg.metapath_graph(list(k), device=device)
                  for k in _ACM_METAPATHS]
    else:
        raise ValueError(f"unknown layout {layout!r}")

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return HeteroNodeData(
        graphs=graphs,
        features=torch.from_numpy(np.ascontiguousarray(feats)).to(device),
        labels=torch.from_numpy(labels.astype(np.int64)).to(device),
        train_idx=idx(train), val_idx=idx(val), test_idx=idx(test),
        num_classes=int(labels.max()) + 1, device=device)


def load_acm_han(path: str | None = None, seed: int = 0,
                 layout: str = "coo", n_papers: int = 600,
                 min_edges_per_tile: int = 64,
                 device: str | torch.device = "cuda") -> HeteroNodeData:
    """HAN's input: the PAP and PLP metapath graphs over papers, on
    ``device`` (the card by default). ``path`` names an ACM.mat (read when
    it exists); otherwise the synthetic ACM with ``n_papers`` papers,
    ``n_papers // 2`` authors and ``max(20, n_papers // 30)`` subjects."""
    device = resolve_device(device)
    if path is not None and os.path.exists(path):
        hg, feats, labels = _load_acm_mat(path)
    else:
        hg, feats, labels = synthetic_acm(
            seed=seed, n_papers=n_papers, n_authors=n_papers // 2,
            n_subjects=max(20, n_papers // 30))
    return _assemble_han_data(hg, feats, labels, seed, layout,
                              min_edges_per_tile, device)


def load_imdb_han(path: str | None = None, seed: int = 0,
                  layout: str = "coo", min_edges_per_tile: int = 64,
                  device: str | torch.device = "cuda") -> HeteroNodeData:
    """IMDB for HAN: MAM and MDM over movies, isomorphic to ACM (movie =
    paper, actor = author, director = subject). Without a ``.mat`` path,
    a synthetic IMDB of 900 movies, 500 actors, 60 directors and 3
    classes. ``layout`` and ``device`` as in ``load_acm_han``."""
    device = resolve_device(device)
    if path is not None and os.path.exists(path):
        hg, feats, labels = _load_acm_mat(path)
    else:
        hg, feats, labels = synthetic_acm(
            n_papers=900, n_authors=500, n_subjects=60, n_feats=128,
            n_classes=3, seed=seed)
    return _assemble_han_data(hg, feats, labels, seed, layout,
                              min_edges_per_tile, device)


def _per_class_split(labels: np.ndarray, seed: int, per_class_train: int,
                     per_class_val: int):
    """The reference's per-class split: each class's targets shuffled by
    one ``default_rng(seed)`` stream, the first ``per_class_train`` to
    train (leaving at least two), the next ``per_class_val`` to validation
    (leaving at least one), the rest to test; each split sorted."""
    rng = np.random.default_rng(seed)
    train, val, test = [], [], []
    for c in range(int(labels.max()) + 1):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        k1 = min(per_class_train, max(len(idx) - 2, 1))
        k2 = min(per_class_val, max(len(idx) - k1 - 1, 0))
        train.extend(idx[:k1])
        val.extend(idx[k1:k1 + k2])
        test.extend(idx[k1 + k2:])
    return tuple(np.array(sorted(s), np.int64) for s in (train, val, test))


def _stacked_data(adj, feats, labels, n_targets, seed, per_class_train,
                  per_class_val, device) -> StackedAdjData:
    train, val, test = _per_class_split(labels, seed, per_class_train,
                                        per_class_val)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return StackedAdjData(
        adj=dev(adj), features=dev(row_normalize_features(feats)),
        labels=dev(labels.astype(np.int64)),
        target_idx=torch.arange(n_targets, device=device),
        train_idx=dev(train), val_idx=dev(val), test_idx=dev(test),
        num_classes=int(labels.max()) + 1, device=device)


def _load_gtn_pickle(path: str, seed: int, per_class_train: int,
                     per_class_val: int,
                     device: torch.device) -> StackedAdjData:
    """Read the reference's processed ``train.pkl``, a tuple (paper ids,
    paper labels, one scipy sparse matrix an edge type over all nodes,
    node features), and stack the types and the identity. The file is
    unpickled: read only a file of a source you trust."""
    import pickle

    with open(path, "rb") as f:
        _, paper_target, edges, node_feature = pickle.load(f)
    n = edges[0].shape[0]
    slices = [np.asarray(e.todense(), np.float32) for e in edges]
    slices.append(np.eye(n, dtype=np.float32))
    labels = np.asarray(paper_target, np.int32)
    return _stacked_data(np.stack(slices), np.asarray(node_feature,
                                                      np.float32),
                         labels, len(labels), seed, per_class_train,
                         per_class_val, device)


def _assemble_gtn_data(hg, feats, labels, seed: int, per_class_train: int,
                       per_class_val: int,
                       device: torch.device) -> StackedAdjData:
    """GTN's input from a paper/author/subject ``HeteroGraph``: nodes
    numbered papers, then authors, then subjects; the stack PA, AP, PL, LP
    and the identity; an author's or subject's features the sum of its
    papers'; the per-class split of the papers."""
    n_p, n_a, n_l = (hg.node_counts["paper"], hg.node_counts["author"],
                     hg.node_counts["subject"])
    n = n_p + n_a + n_l
    off_a, off_l = n_p, n_p + n_a

    def dense(key, off_src, off_dst):
        s, d, _ = hg.relations[key]
        a = np.zeros((n, n), np.float32)
        a[s + off_src, d + off_dst] = 1.0
        return a

    adj = np.stack([
        dense(("paper", "pa", "author"), 0, off_a),
        dense(("author", "ap", "paper"), off_a, 0),
        dense(("paper", "pl", "subject"), 0, off_l),
        dense(("subject", "lp", "paper"), off_l, 0),
        np.eye(n, dtype=np.float32)])
    full_feats = np.zeros((n, feats.shape[1]), np.float32)
    full_feats[:n_p] = feats
    pa_s, pa_d, _ = hg.relations[("paper", "pa", "author")]
    np.add.at(full_feats, pa_d + off_a, feats[pa_s])
    pl_s, pl_d, _ = hg.relations[("paper", "pl", "subject")]
    np.add.at(full_feats, pl_d + off_l, feats[pl_s])
    return _stacked_data(adj, full_feats, labels, n_p, seed,
                         per_class_train, per_class_val, device)


def load_acm_gtn(path: str | None = None, seed: int = 0,
                 per_class_train: int = 200, per_class_val: int = 100,
                 device: str | torch.device = "cuda") -> StackedAdjData:
    """GTN's input on ``device`` (the card by default). ``path`` names the
    reference's ``train.pkl`` (``.pkl``) or an ACM.mat, read when it
    exists; otherwise the synthetic ACM of 600 papers, 300 authors and 20
    subjects (920 nodes)."""
    device = resolve_device(device)
    if path is not None and os.path.exists(path):
        if path.endswith(".pkl"):
            return _load_gtn_pickle(path, seed, per_class_train,
                                    per_class_val, device)
        hg, feats, labels = _load_acm_mat(path)
    else:
        hg, feats, labels = synthetic_acm(seed=seed)
    return _assemble_gtn_data(hg, feats, labels, seed, per_class_train,
                              per_class_val, device)


def load_imdb_gtn(path: str | None = None, seed: int = 0,
                  device: str | torch.device = "cuda") -> StackedAdjData:
    """IMDB for GTN: the reference's ``train.pkl`` when ``path`` names
    one, otherwise the synthetic ACM construction from seed ``seed +
    1000``; 300 train and 300 validation targets a class."""
    device = resolve_device(device)
    if path is not None and os.path.exists(path) and path.endswith(".pkl"):
        return _load_gtn_pickle(path, seed, 300, 300, device)
    hg, feats, labels = synthetic_acm(seed=seed + 1000)
    return _assemble_gtn_data(hg, feats, labels, seed + 1000, 300, 300,
                              device)
