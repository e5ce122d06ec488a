"""Cora-style citation dataset loading (``.content`` / ``.cites`` format).

Port of ``graphneuralnetwork_tpu/data/planetoid.py``. Features are
row-normalised, the adjacency symmetrised with self loops and
D^-1/2 (A+I) D^-1/2 weights; splits are train 0-140, val 200-500, test
500-1500. Without files, a deterministic synthetic citation graph with the
named dataset's exact shape is generated from the same
``np.random.default_rng(seed)`` stream as the reference, so the arrays are
byte-equal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.bcsr import HybridGraph
from ..core.device import resolve_device
from ..core.graph import (Graph, add_self_loops, gat_graph_hybrid,
                          gcn_graph, gcn_graph_hybrid,
                          row_normalize_features, symmetrize)
from ..core.reorder import invert_permutation, locality_order


@dataclass(frozen=True)
class NodeClassificationData:
    graph: Graph | HybridGraph
    features: torch.Tensor     # float32[N, F] row-normalised
    labels: torch.Tensor       # int64[N]
    train_idx: torch.Tensor    # int64
    val_idx: torch.Tensor
    test_idx: torch.Tensor
    num_classes: int
    device: torch.device
    #: the raw directed edges (relabelled under the hybrid layout), from
    #: which the hybrid layout builds GAT's unit-weight adjacency
    raw_senders: Optional[np.ndarray] = None
    raw_receivers: Optional[np.ndarray] = None


def synthetic_citation_graph(
    n_nodes: int = 2708, n_feats: int = 1433, n_classes: int = 7,
    avg_degree: float = 2.0, homophily: float = 0.9, seed: int = 0,
):
    """Planted-partition citation graph: class-pure features plus mostly
    intra-class edges. Draws exactly the reference's random stream."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    feats = np.zeros((n_nodes, n_feats), dtype=np.float32)
    words_per_class = n_feats // n_classes
    for i in range(n_nodes):
        c = labels[i]
        block = rng.integers(c * words_per_class, (c + 1) * words_per_class,
                             size=12)
        noise = rng.integers(0, n_feats, size=8)
        feats[i, block] = 1.0
        feats[i, noise] = 1.0
    n_edges = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.random(n_edges) < homophily
    dst = np.empty(n_edges, dtype=np.int64)
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for k in range(n_edges):
        if same[k]:
            pool = by_class[labels[src[k]]]
            dst[k] = pool[rng.integers(0, len(pool))]
        else:
            dst[k] = rng.integers(0, n_nodes)
    keep = src != dst
    return (feats, labels, src[keep].astype(np.int32),
            dst[keep].astype(np.int32))


def _read_content_cites(root: str, name: str):
    content = np.genfromtxt(os.path.join(root, f"{name}.content"),
                            dtype=np.dtype(str))
    ids = content[:, 0]
    feats = content[:, 1:-1].astype(np.float32)
    label_names = content[:, -1]
    classes = sorted(set(label_names))
    labels = np.array([classes.index(l) for l in label_names],
                      dtype=np.int32)
    id_map = {j: i for i, j in enumerate(ids)}
    cites = np.genfromtxt(os.path.join(root, f"{name}.cites"),
                          dtype=np.dtype(str))
    edges = np.array(
        [(id_map[a], id_map[b]) for a, b in cites
         if a in id_map and b in id_map], dtype=np.int32)
    return feats, labels, edges[:, 0], edges[:, 1]


#: Synthetic-fallback shapes per dataset name.
_SHAPES = {
    "cora": dict(n_nodes=2708, n_feats=1433, n_classes=7),
    "citeseer": dict(n_nodes=3327, n_feats=3703, n_classes=6),
}


def load_cora(root: str | None = None, name: str = "cora",
              seed: int = 0,
              layout: str = "coo",
              layout_objective: str = "spmm",
              device: str | torch.device = "cuda", *,
              model: str = "gcn",
              tile_dtype: torch.dtype = torch.float32
              ) -> NodeClassificationData:
    """Load Cora/Citeseer from ``root`` if present, else synthesise at the
    named dataset's shape; tensors go to ``device`` (the card by default).

    ``layout="hybrid"`` builds the locality-clustered tile layout
    (``core/bcsr.py``): nodes are relabelled by the clustering permutation,
    features and labels permuted to match, and the split indices mapped
    through its inverse. ``layout="auto"`` probes the post-clustering tile
    fill as the reference does and picks hybrid or COO; a hybrid decision
    reuses the probe's permutation.

    ``model`` picks the hybrid adjacency: ``"gcn"`` the sym-normalised
    one, ``"gat"`` unit weights over the relabelled raw edges with tiles
    in ``tile_dtype`` (the reference CLI's GAT rebuild; bfloat16 holds the
    edge counts exactly). The COO graph is the same for both.
    """
    device = resolve_device(device)
    if layout not in ("auto", "coo", "hybrid"):
        raise ValueError(f"unknown layout {layout!r}")
    if model not in ("gcn", "gat"):
        raise ValueError(f"unknown model {model!r}")
    if root is not None and os.path.exists(
            os.path.join(root, f"{name}.content")):
        feats, labels, s, r = _read_content_cites(root, name)
    else:
        feats, labels, s, r = synthetic_citation_graph(
            seed=seed, **_SHAPES.get(name, _SHAPES["cora"]))

    n = feats.shape[0]
    feats = row_normalize_features(feats)
    num_classes = int(labels.max()) + 1
    train_idx = np.arange(0, 140)
    val_idx = np.arange(200, 500)
    test_idx = np.arange(500, 1500)

    perm = None
    if layout in ("auto", "hybrid"):
        # the exact edge set the hybrid build tiles
        s_p, r_p = add_self_loops(*symmetrize(s, r), n)
    if layout == "auto":
        from ..core.layout import choose_layout
        layout, _, perm = choose_layout(
            s_p, r_p, n, objective=layout_objective, verbose=True, tag=name)

    if layout == "hybrid":
        if perm is None:
            perm = locality_order(s_p, r_p, n)
        inv = invert_permutation(perm)
        s_new, r_new = inv[s].astype(np.int32), inv[r].astype(np.int32)
        if model == "gat":
            graph = gat_graph_hybrid(s_new, r_new, n, dtype=tile_dtype,
                                     device=device)
        else:
            graph, _ = gcn_graph_hybrid(s, r, n, perm=perm, device=device)
        s, r = s_new, r_new
        feats, labels = feats[perm], labels[perm]
        train_idx, val_idx, test_idx = (inv[train_idx], inv[val_idx],
                                        inv[test_idx])
    else:
        graph = gcn_graph(s, r, n, device=device)

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return NodeClassificationData(
        graph=graph,
        features=torch.from_numpy(feats).to(device),
        labels=torch.from_numpy(labels.astype(np.int64)).to(device),
        train_idx=idx(train_idx),
        val_idx=idx(val_idx),
        test_idx=idx(test_idx),
        num_classes=num_classes,
        device=device,
        raw_senders=s,
        raw_receivers=r,
    )


def load_citeseer(root: str | None = None, seed: int = 0,
                  device: str | torch.device = "cuda"
                  ) -> NodeClassificationData:
    """Citeseer via the same .content/.cites pipeline."""
    return load_cora(root=root, name="citeseer", seed=seed, device=device)
