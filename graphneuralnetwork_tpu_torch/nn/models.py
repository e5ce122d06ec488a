"""Node-classification models assembled from the conv layers.

Port of ``GCN``, ``GAT``, ``DenseGAT`` and ``GraphSAGE`` of
``graphneuralnetwork_tpu/nn/models.py``, with the same layer names
(``conv1``/``conv2``, ``attn1``/``attn_out``, ``sage0``.../``sage_out``).
Dropout is active in ``train()`` mode and draws from the ``generator``
passed to ``forward``. ``dtype=torch.bfloat16`` runs the layers in mixed
precision; the logits come back in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..core.bcsr import HybridGraph
from ..core.graph import Graph
from .conv import DenseGATConv, GATConv, GCNConv, SAGEConv, dropout


class GCN(nn.Module):
    def __init__(self, in_features: int, hidden: int = 128,
                 num_classes: int = 7, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = GCNConv(in_features, hidden, dtype=dtype)
        self.conv2 = GCNConv(hidden, num_classes, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.conv1(graph, x))
        if self.training:
            h = dropout(h, self.dropout, generator)
        return self.conv2(graph, h).float()


class GAT(nn.Module):
    #: the layer type (``DenseGAT`` takes ``DenseGATConv``)
    conv = GATConv

    def __init__(self, in_features: int, hidden: int = 8,
                 num_classes: int = 7, num_heads: int = 8,
                 dropout: float = 0.6, negative_slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.attn1 = self.conv(in_features, hidden, num_heads=num_heads,
                               concat_heads=True,
                               negative_slope=negative_slope,
                               attn_dropout=dropout, dtype=dtype)
        self.attn_out = self.conv(hidden * num_heads, num_classes,
                                  num_heads=1, concat_heads=False,
                                  negative_slope=negative_slope,
                                  attn_dropout=dropout, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.attn1.reset_parameters(generator)
        self.attn_out.reset_parameters(generator)

    def forward(self, graph: Graph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            x = dropout(x, self.dropout, generator)
        h = F.elu(self.attn1(graph, x, generator))
        if self.training:
            h = dropout(h, self.dropout, generator)
        return self.attn_out(graph, h, generator).float()


class DenseGAT(GAT):
    """``GAT`` over a dense [N, N] adjacency (receiver rows) through
    ``DenseGATConv``; the layer names and parameters are ``GAT``'s, so
    weights move between the two."""

    conv = DenseGATConv


class GraphSAGE(nn.Module):
    """Full-graph GraphSAGE: ``SAGEConv`` layers of ``hidden_dims`` with
    ReLU (``sage0``, ``sage1``, ...), then ``sage_out`` without one. No
    dropout; ``generator`` is accepted for the training loop's call."""

    def __init__(self, in_features: int,
                 hidden_dims: Sequence[int] = (128,), num_classes: int = 3,
                 aggregator: str = "mean",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [in_features, *hidden_dims]
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"sage{i}", SAGEConv(
                d_in, d_out, aggregator=aggregator, dtype=dtype,
                activation=F.relu))
        self.sage_out = SAGEConv(dims[-1], num_classes,
                                 aggregator=aggregator, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.children():
            layer.reset_parameters(generator)

    def forward(self, graph: Graph | HybridGraph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for layer in self.children():
            h = layer(graph, h)
        return h.float()
