"""Pubmed citation dataset (GraphSAGE form).

Port of ``graphneuralnetwork_tpu/data/pubmed.py``. Real data: the NCBI tab
format (``Pubmed-Diabetes.NODE.paper.tab`` + ``.DIRECTED.cites.tab``).
Without files, a synthetic citation graph with Pubmed's feature and class
counts (F=500, C=3) on 2,000 nodes, drawn from the same random stream as
the JAX package's, so the arrays are equal. Ratio split 10/30/60.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.bcsr import build_hybrid
from ..core.device import resolve_device
from ..core.graph import build_graph, row_normalize_features, symmetrize
from ..core.reorder import invert_permutation, locality_order, relabel_edges
from .planetoid import NodeClassificationData, synthetic_citation_graph


@dataclass(frozen=True)
class SampledNodeData:
    """Host-side arrays for the sampled mini-batch pipeline."""
    features: np.ndarray     # [N, F] float32
    labels: np.ndarray       # [N] int32
    senders: np.ndarray
    receivers: np.ndarray
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int


def _parse_pubmed_tab(root: str):
    node_file = os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab")
    cite_file = os.path.join(root, "Pubmed-Diabetes.DIRECTED.cites.tab")
    with open(node_file) as f:
        lines = f.readlines()
    # header row 1 declares '<kind>:<name>:<default>' fields; only the
    # 'numeric:' ones are features
    feat_names = [w.split(":")[1] for w in lines[1].split()
                  if w.startswith("numeric:")]
    fmap = {w: i for i, w in enumerate(feat_names)}
    ids, labels, feats = [], [], []
    id_map = {}
    for line in lines[2:]:
        parts = line.strip().split("\t")
        pid = parts[0]
        id_map[pid] = len(ids)
        ids.append(pid)
        labels.append(int(parts[1].split("=")[1]) - 1)
        row = np.zeros(len(fmap), np.float32)
        for tok in parts[2:-1]:
            k, v = tok.split("=")
            if k in fmap:
                row[fmap[k]] = float(v)
        feats.append(row)
    s, r = [], []
    with open(cite_file) as f:
        for line in f.readlines()[2:]:
            parts = line.strip().split("\t")
            a = parts[1].split(":")[1]
            b = parts[-1].split(":")[1]
            if a in id_map and b in id_map:
                s.append(id_map[a])
                r.append(id_map[b])
    return (np.stack(feats), np.array(labels, np.int32),
            np.array(s, np.int32), np.array(r, np.int32))


def load_pubmed(root: str | None = None, seed: int = 0,
                n_nodes: int = 2000, n_feats: int = 500,
                ratios=(0.1, 0.3, 0.6)) -> SampledNodeData:
    """Host arrays with both edge directions and a 10/30/60 ratio split."""
    if root is not None and os.path.exists(
            os.path.join(root, "Pubmed-Diabetes.NODE.paper.tab")):
        feats, labels, s, r = _parse_pubmed_tab(root)
    else:
        feats, labels, s, r = synthetic_citation_graph(
            n_nodes=n_nodes, n_feats=n_feats, n_classes=3,
            avg_degree=4.0, seed=seed)
    s2 = np.concatenate([s, r])
    r2 = np.concatenate([r, s])
    n = feats.shape[0]
    k1 = int(n * ratios[0])
    k2 = int(n * (ratios[0] + ratios[1]))
    idx = np.arange(n)
    return SampledNodeData(
        features=feats.astype(np.float32), labels=labels,
        senders=s2, receivers=r2,
        train_idx=idx[:k1], val_idx=idx[k1:k2], test_idx=idx[k2:],
        num_classes=int(labels.max()) + 1)


def load_pubmed_fullbatch(root: str | None = None, seed: int = 0,
                          layout: str = "hybrid",
                          min_edges_per_tile: int = 64,
                          device: str | torch.device = "cuda"
                          ) -> NodeClassificationData:
    """Full-batch Pubmed for ``GraphSAGE``: the symmetrised graph in
    ``layout`` with row-normalised features, on ``device`` (the card
    unless the caller asks for the CPU).

    ``"hybrid"`` locality-clusters the nodes and builds a symmetric
    ``HybridGraph`` (unit weights, tiles dense from ``min_edges_per_tile``
    edges on) with features and labels permuted and the split indices
    mapped through the inverse permutation, as ``load_cora`` does.
    ``"auto"`` probes the clustered tile fill and picks hybrid or COO;
    ``"coo"`` builds a ``Graph``.
    """
    device = resolve_device(device)
    if layout not in ("auto", "coo", "hybrid"):
        raise ValueError(f"unknown layout {layout!r}")
    sd = load_pubmed(root=root, seed=seed)
    n = sd.features.shape[0]
    s, r = symmetrize(sd.senders, sd.receivers)
    feats, labels = sd.features, sd.labels
    train, val, test = sd.train_idx, sd.val_idx, sd.test_idx
    perm = None
    if layout == "auto":
        from ..core.layout import choose_layout
        layout, _, perm = choose_layout(
            s, r, n, min_edges_per_tile=min_edges_per_tile, verbose=True,
            tag="pubmed")
    if layout == "hybrid":
        if perm is None:
            perm = locality_order(s, r, n)
        inv = invert_permutation(perm)
        s, r = relabel_edges(perm, s, r)
        feats, labels = feats[perm], labels[perm]
        train, val, test = inv[train], inv[val], inv[test]
        graph = build_hybrid(s, r, n, min_edges_per_tile=min_edges_per_tile,
                             symmetric=True, device=device)
    else:
        graph = build_graph(s, r, n, device=device)

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return NodeClassificationData(
        graph=graph,
        features=torch.from_numpy(row_normalize_features(feats)).to(device),
        labels=torch.from_numpy(labels.astype(np.int64)).to(device),
        train_idx=idx(train), val_idx=idx(val), test_idx=idx(test),
        num_classes=sd.num_classes, device=device,
        raw_senders=s, raw_receivers=r)
