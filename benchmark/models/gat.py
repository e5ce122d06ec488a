"""The GAT's program side: the port's ``nn/models.py:GAT``, its graph on the
hybrid layout, and the dropout its forward draws, in the order drawn."""

from __future__ import annotations

import numpy as np

from graphneuralnetwork_tpu_torch.core.graph import gat_graph_hybrid
from graphneuralnetwork_tpu_torch.core.reorder import invert_permutation
from graphneuralnetwork_tpu_torch.nn import GAT


def make_model(cfg: dict):
    return GAT(cfg["in_features"], hidden=cfg["hidden"],
               num_classes=cfg["num_classes"], num_heads=cfg["heads"],
               dropout=cfg["dropout"], negative_slope=cfg["negative_slope"])


def hybrid_graph(ds, perm, device):
    """Unit-weight tiles and remainder of the graph renumbered by
    ``perm``."""
    inv = invert_permutation(perm)
    return gat_graph_hybrid(inv[ds.senders].astype(np.int32),
                            inv[ds.receivers].astype(np.int32), ds.n_nodes,
                            device=device)


def replay_masks(replay, gen, cfg: dict) -> dict:
    """``GAT.forward``'s draws: the inputs, the first layer's attention,
    its output, the output layer's attention."""
    heads, rate = cfg["heads"], cfg["dropout"]
    return {"x": replay.nodes(gen, cfg["in_features"], rate),
            "att1": replay.edges(gen, heads, rate),
            "h": replay.nodes(gen, heads * cfg["hidden"], rate),
            "att2": replay.edges(gen, 1, rate)}
