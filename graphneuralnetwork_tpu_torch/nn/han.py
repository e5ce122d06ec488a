"""HAN, the heterogeneous graph attention network (torch.nn).

Port of ``graphneuralnetwork_tpu/nn/han.py``: node-level attention is one
``GATConv`` per metapath graph (``DenseGATConv`` per dense [B, B]
sub-adjacency in the node-minibatch form), semantic-level attention
projects each metapath's embeddings, scores them with ``q`` and mixes them
by the softmax over metapaths. The attribute names are the flax scope
names (``layer0``, ``gat_mp0``, ``semantic.proj``, ``semantic.q``,
``classify``), so ``params.from_flax`` maps a flax parameter tree onto
``state_dict()`` unchanged.

``dtype`` is the compute dtype of the GAT layers and the classifier;
parameters stay float32, semantic attention runs in float32 whatever the
dtype, and the logits come back in float32. Dropout (attention weights and
between layers) is active in ``train()`` mode and draws from the
``generator`` passed to ``forward``.

On halo-partitioned metapath graphs (``parallel/halo.py``) each rank
computes its own rows, and the semantic attention's mean over the nodes is
global, as GSPMD makes JAX's: each rank masks its padding rows (global
row ``rank·nps + i`` past ``n_nodes``) and the masked sum and count are
summed over the ranks before the division.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .conv import (DenseGATConv, GATConv, dropout, glorot_uniform_,
                   lecun_normal_)


class SemanticAttention(nn.Module):
    """beta = softmax over metapaths of mean_n(tanh(proj(z)) · q); out =
    sum_p beta_p z_p. ``mask`` (bool [N]) leaves rows out of the mean;
    with ``mesh`` the mean runs over the rows of every rank."""

    def __init__(self, in_features: int, hidden: int = 128):
        super().__init__()
        self.proj = nn.Linear(in_features, hidden)
        self.q = nn.Parameter(torch.empty(hidden, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.proj.weight, self.proj.in_features, generator)
        nn.init.zeros_(self.proj.bias)
        glorot_uniform_(self.q, self.q.shape[0], 1, generator)

    def forward(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None,
                mesh=None) -> torch.Tensor:
        # z: [P, N, F]; float32 whatever the compute dtype (P x N x hidden
        # is small and the softmax is precision-sensitive)
        z = z.float()
        scores = torch.tanh(self.proj(z)) @ self.q            # [P, N, 1]
        if mask is None:
            mean = scores.mean(dim=1)
        else:
            m = mask.float()[None, :, None]
            total, count = (scores * m).sum(dim=1), m.sum(dim=1)
            if mesh is not None:
                from ..parallel.collectives import all_reduce_sum
                total = all_reduce_sum(total, mesh)
                count = all_reduce_sum(count, mesh)
            mean = total / torch.clamp_min(count, 1.0)
        beta = torch.softmax(mean, dim=0)                      # [P, 1]
        return (beta[:, None, :] * z).sum(dim=0)               # [N, F]


class HANLayer(nn.Module):
    """One GAT per metapath (``gat_mp0``, ``gat_mp1``, ...; heads
    concatenated, then ELU), then semantic attention (``semantic``)."""

    #: the node-level layer (``DenseHANLayer`` takes ``DenseGATConv``)
    conv = GATConv

    def __init__(self, in_features: int, num_metapaths: int, features: int,
                 num_heads: int = 4, dropout: float = 0.6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_metapaths = num_metapaths
        for p in range(num_metapaths):
            self.add_module(f"gat_mp{p}", self.conv(
                in_features, features, num_heads=num_heads,
                concat_heads=True, attn_dropout=dropout, dtype=dtype))
        self.semantic = SemanticAttention(features * num_heads)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.children():
            layer.reset_parameters(generator)

    def forward(self, graphs, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``graphs``: one graph a metapath (``HANLayer``), or the [P, B, B]
        stack of dense sub-adjacencies (``DenseHANLayer``)."""
        assert len(graphs) == self.num_metapaths
        z = torch.stack([
            F.elu(getattr(self, f"gat_mp{p}")(g, x, generator))
            for p, g in enumerate(graphs)])                    # [P, N, H*F]
        g0 = graphs[0]
        if hasattr(g0, "halo_size"):
            # this rank's rows of the padded node set
            return self.semantic(z, g0.local.row_mask, g0.mesh)
        return self.semantic(z)


class DenseHANLayer(HANLayer):
    """``HANLayer`` over dense metapath sub-adjacencies [P, B, B]."""

    conv = DenseGATConv


class HAN(nn.Module):
    """Stacked ``HANLayer``s (``layer0``, ...; hidden 8 and heads (4,) by
    default), dropout between them in training, then the linear
    ``classify``."""

    #: the layer type (``DenseHAN`` takes ``DenseHANLayer``)
    layer = HANLayer

    def __init__(self, in_features: int, num_metapaths: int,
                 num_classes: int, hidden: int = 8,
                 num_heads: Sequence[int] = (4,), dropout: float = 0.6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.num_layers = len(num_heads)
        d_in = in_features
        for i, heads in enumerate(num_heads):
            self.add_module(f"layer{i}", self.layer(
                d_in, num_metapaths, hidden, num_heads=heads,
                dropout=dropout, dtype=dtype))
            d_in = hidden * heads
        self.classify = nn.Linear(d_in, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            getattr(self, f"layer{i}").reset_parameters(generator)
        lecun_normal_(self.classify.weight, self.classify.in_features,
                      generator)
        nn.init.zeros_(self.classify.bias)

    def forward(self, graphs, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(graphs, h, generator)
            if self.training:
                h = dropout(h, self.dropout, generator)
        if self.dtype is not None:
            h = h.to(self.dtype)
        out = F.linear(h, self.classify.weight.to(h.dtype),
                       self.classify.bias.to(h.dtype))
        return out.float()


class DenseHAN(HAN):
    """``HAN`` over dense metapath sub-adjacencies [P, B, B] and their
    nodes' features [B, F]: the node-minibatch form."""

    layer = DenseHANLayer
