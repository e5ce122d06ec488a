"""Message-passing convolution layers (torch.nn).

Port of ``graphneuralnetwork_tpu/nn/conv.py``: ``GCNConv`` (COO layout)
and ``GATConv`` (COO and hybrid layouts). Parameter names and shapes follow
the flax modules (``linear``, ``bias``, ``attn_src``/``attn_dst`` [H, F]);
a flax Dense kernel [in, out] is the transpose of ``linear.weight``
(``params.py``).

``dtype`` is the compute dtype (mixed precision): parameters stay float32,
the dense ``X·W`` and the aggregation run in ``dtype`` (the segment-sum
kernel accumulates in float32), and GAT's attention logits are float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.bcsr import HybridGraph
from ..core.graph import Graph
from ..ops import edge_softmax
from ..ops.bcsr_attention import gat_tiled_attend
from ..ops.spmm import spmm, spmm_weighted


def glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None):
    """flax's ``glorot_uniform``: U(-l, l), l = sqrt(6 / (fan_in+fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


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


def _hybrid_not_ported(graph) -> None:
    if not isinstance(graph, Graph):
        raise NotImplementedError(
            f"GCNConv on a {type(graph).__name__} needs the dense-tile SpMM "
            "kernel K3, which is not ported yet (ROADMAP.md queue 1 item 8); "
            "use --layout coo for GCN")


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

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        _hybrid_not_ported(graph)
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
