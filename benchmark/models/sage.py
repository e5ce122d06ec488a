"""GraphSAGE's program side: the port's ``nn/models.py:GraphSAGE`` as OGB's
full-batch ogbn-products model has it (the mean, PyG's bias on the
neighbour linear, dropout after each hidden ReLU), its graph on the hybrid
layout, and the dropout its forward draws, in the order drawn.

Loading it also gives the harness a faster ``reference/gnn.py:
canonical_edges`` (``canonical_edges`` below): the same sorted distinct
keys, by a sort where ``np.unique`` takes a hash table from numpy 2.3 on:
about 9 minutes over ogbn-products' 126M keys on an H100 machine's host,
against about 2 for the rest of a run. The harness loads this file (to
build the model) before it asks for the canonical edges."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gnn
from graphneuralnetwork_tpu_torch.core.graph import gat_graph_hybrid
from graphneuralnetwork_tpu_torch.core.reorder import invert_permutation
from graphneuralnetwork_tpu_torch.nn import GraphSAGE


def make_model(cfg: dict):
    return GraphSAGE(cfg["in_features"],
                     hidden_dims=(cfg["hidden"],) * (cfg["num_layers"] - 1),
                     num_classes=cfg["num_classes"],
                     aggregator=cfg["aggregator"], dropout=cfg["dropout"],
                     neighbor_bias=True)


def hybrid_graph(ds, perm, device):
    """Unit-weight tiles and remainder of the graph renumbered by
    ``perm``: the mean divides their sums by the summed counts."""
    inv = invert_permutation(perm)
    return gat_graph_hybrid(inv[ds.senders].astype(np.int32),
                            inv[ds.receivers].astype(np.int32), ds.n_nodes,
                            device=device)


def replay_masks(replay, gen, cfg: dict) -> dict:
    """``GraphSAGE.forward``'s draws: one after each hidden layer."""
    return {f"h{i}": replay.nodes(gen, cfg["hidden"], cfg["dropout"])
            for i in range(cfg["num_layers"] - 1)}


def canonical_edges(senders: np.ndarray, receivers: np.ndarray, n: int,
                    device) -> gnn.Edges:
    """``gnn.canonical_edges``' edges, its keys sorted and made distinct by
    ``torch.unique`` on ``device`` (a sort there)."""
    s = np.concatenate([senders, receivers, np.arange(n)]).astype(np.int64)
    r = np.concatenate([receivers, senders, np.arange(n)]).astype(np.int64)
    keys = torch.unique(torch.from_numpy(r * n + s).to(device), sorted=True)
    return gnn.Edges(keys // n, keys % n, n)


gnn.canonical_edges = canonical_edges
