"""The GCN's program side: the port's ``nn/models.py:GCN``, its graph on the
hybrid layout, and the dropout its forward draws, in the order drawn."""

from __future__ import annotations

from graphneuralnetwork_tpu_torch.core.graph import gcn_graph_hybrid
from graphneuralnetwork_tpu_torch.nn import GCN


def make_model(cfg: dict):
    return GCN(cfg["in_features"], hidden=cfg["hidden"],
               num_classes=cfg["num_classes"], dropout=cfg["dropout"])


def hybrid_graph(ds, perm, device):
    """Tiles and remainder of the normalised graph, renumbered by
    ``perm``."""
    graph, _ = gcn_graph_hybrid(ds.senders, ds.receivers, ds.n_nodes,
                                perm=perm, device=device)
    return graph


def replay_masks(replay, gen, cfg: dict) -> dict:
    """``GCN.forward``'s one draw: the hidden layer's dropout."""
    return {"h": replay.nodes(gen, cfg["hidden"], cfg["dropout"])}
