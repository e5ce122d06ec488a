"""Message-passing convolution layers (torch.nn).

Port of ``graphneuralnetwork_tpu/nn/conv.py``: ``GCNConv``, ``GATConv``
and ``SAGEConv``, each on the COO and the hybrid layout. Parameter names
and shapes follow the flax modules (``linear``, ``bias``,
``attn_src``/``attn_dst`` [H, F], SAGE's ``neighbor`` and ``self``); a flax
Dense kernel [in, out] is the transpose of a ``Linear.weight``
(``params.py``).

``dtype`` is the compute dtype (mixed precision): parameters stay float32,
the dense ``X·W`` and the aggregation run in ``dtype`` (the segment-sum
kernel accumulates in float32), and GAT's attention logits are float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.bcsr import HybridGraph
from ..core.graph import Graph
from ..ops import (aggregate_edges, edge_softmax, segment_max,
                   segment_mean)
from ..ops.bcsr_attention import gat_tiled_attend, hybrid_segment_max
from ..ops.spmm import spmm, spmm_weighted


def glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None):
    """flax's ``glorot_uniform``: U(-l, l), l = sqrt(6 / (fan_in+fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal`` (the ``nn.Dense`` default): a normal of
    variance ``1 / fan_in`` truncated at two standard deviations, its scale
    corrected for the truncation as ``jax.nn.initializers`` does."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep with probability
    ``1 - rate`` and scale kept values by ``1 / (1 - rate)``."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class GCNConv(nn.Module):
    """out = spmm(Â, X·W) + b with Â the pre-normalised adjacency."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        out_f, in_f = self.linear.weight.shape
        glorot_uniform_(self.linear.weight, in_f, out_f, generator)
        nn.init.zeros_(self.bias)

    def forward(self, graph: Graph | HybridGraph,
                x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        support = F.linear(x, self.linear.weight.to(x.dtype))
        return spmm(graph, support) + self.bias.to(support.dtype)


class GATConv(nn.Module):
    """Multi-head graph attention over the edge list (COO layout) or the
    dense tiles and remainder of a ``HybridGraph``.

    Per head: e_ij = LeakyReLU(a_src·Wh_j + a_dst·Wh_i) for edge j→i,
    α = softmax of e over the incoming edges of i, out_i = Σ α_ij Wh_j.
    ``concat_heads`` concatenates head outputs, else averages them.
    """

    def __init__(self, in_features: int, features: int, num_heads: int = 8,
                 concat_heads: bool = True, negative_slope: float = 0.2,
                 attn_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.num_heads = num_heads
        self.concat_heads = concat_heads
        self.negative_slope = negative_slope
        self.attn_dropout = attn_dropout
        self.dtype = dtype
        self.linear = nn.Linear(in_features, features * num_heads,
                                bias=False)
        self.attn_src = nn.Parameter(torch.empty(num_heads, features))
        self.attn_dst = nn.Parameter(torch.empty(num_heads, features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        out_f, in_f = self.linear.weight.shape
        glorot_uniform_(self.linear.weight, in_f, out_f, generator)
        for a in (self.attn_src, self.attn_dst):
            glorot_uniform_(a, self.num_heads, self.features, generator)

    def forward(self, graph: Graph | HybridGraph, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        n = x.shape[0]
        h = F.linear(x, self.linear.weight.to(x.dtype))
        h = h.reshape(n, self.num_heads, self.features)
        # per-node attention logits [N, H] in float32 whatever the compute
        # dtype: softmax logits are precision-sensitive
        hf = h.float()
        f_src = torch.einsum("nhf,hf->nh", hf, self.attn_src)
        f_dst = torch.einsum("nhf,hf->nh", hf, self.attn_dst)

        if hasattr(graph, "bcsr"):
            # hybrid layout: softmax attention over the dense tiles and the
            # COO remainder, no per-edge [E, H, F] tensor (K4-K6)
            dropping = self.training and self.attn_dropout > 0.0
            out = gat_tiled_attend(
                graph, h, f_src, f_dst,
                negative_slope=self.negative_slope,
                attn_dropout=self.attn_dropout if dropping else 0.0,
                generator=generator)
            if self.concat_heads:
                return out.reshape(n, self.num_heads * self.features)
            return out.mean(dim=1)

        scores = f_src[graph.senders] + f_dst[graph.receivers]
        scores = F.leaky_relu(scores, self.negative_slope)
        # alpha stays float32: the weighted products and their gradients
        # (the attention vectors' gradients cancel) are formed in float32
        alpha = edge_softmax(graph, scores)
        if self.training:
            alpha = dropout(alpha, self.attn_dropout, generator)
        out = spmm_weighted(graph, alpha, h)      # [N, H, F], one K1 call
        if self.concat_heads:
            return out.reshape(n, self.num_heads * self.features)
        return out.mean(dim=1)


class SAGEConv(nn.Module):
    """GraphSAGE convolution (full-graph form): aggregate the in-neighbours
    (``mean``, ``sum`` or ``max``), then ``neighbor(agg) + self(x)``
    (``combine="sum"``) or the two side by side, ``[self(x), neighbor(agg)]``
    (``combine="concat"``, twice ``features`` wide).

    On a ``HybridGraph`` ``sum`` and ``mean`` ride ``spmm`` (K3 and K1;
    ``mean`` divides by ``spmm(graph, ones)``, at least 1) and ``max``
    ``hybrid_segment_max`` (K7 and K2). On a ``Graph`` they are the
    unweighted segment mean and max over the real edges and the weighted
    sum of ``aggregate_edges``.
    """

    def __init__(self, in_features: int, features: int,
                 aggregator: str = "mean", combine: str = "sum",
                 use_bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 activation: Optional[Callable] = None):
        super().__init__()
        if aggregator not in ("mean", "sum", "max"):
            raise ValueError(f"unknown aggregator {aggregator!r}")
        if combine not in ("sum", "concat"):
            raise ValueError(f"unknown combine {combine!r}")
        self.aggregator = aggregator
        self.combine = combine
        self.dtype = dtype
        self.activation = activation
        # the flax scope names: ``sage0/neighbor/kernel`` maps to
        # ``sage0.neighbor.weight``
        self.neighbor = nn.Linear(in_features, features, bias=use_bias)
        self.self = nn.Linear(in_features, features, bias=use_bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in (self.neighbor, self.self):
            lecun_normal_(lin.weight, lin.in_features, generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)

    def _aggregate(self, graph: Graph | HybridGraph,
                   x: torch.Tensor) -> torch.Tensor:
        if hasattr(graph, "bcsr"):
            if self.aggregator == "sum":
                return spmm(graph, x)
            if self.aggregator == "mean":
                ones = torch.ones(x.shape[0], 1, dtype=x.dtype,
                                  device=x.device)
                counts = torch.clamp_min(spmm(graph, ones), 1.0)
                return spmm(graph, x) / counts
            return hybrid_segment_max(graph, x)
        msgs = x[graph.senders]
        if self.aggregator == "mean":
            return segment_mean(msgs, graph.receivers, graph.n_nodes,
                                mask=graph.edge_mask)
        if self.aggregator == "sum":
            w = graph.edge_weight[:, None].to(x.dtype)
            return aggregate_edges(graph, msgs * w)
        return segment_max(msgs, graph.receivers, graph.n_nodes,
                           mask=graph.edge_mask)

    @staticmethod
    def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        bias = None if lin.bias is None else lin.bias.to(x.dtype)
        return F.linear(x, lin.weight.to(x.dtype), bias)

    def forward(self, graph: Graph | HybridGraph,
                x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        neigh = self._dense(self.neighbor, self._aggregate(graph, x))
        self_h = self._dense(self.self, x)
        out = (neigh + self_h if self.combine == "sum"
               else torch.cat([self_h, neigh], dim=-1))
        if self.activation is not None:
            out = self.activation(out)
        return out
