"""Sampled mini-batch GraphSAGE (fanout form), torch.nn.

Port of ``graphneuralnetwork_tpu/nn/sage.py``: the host sampler
(``sampling/neighbor.py``) or the device sampler emits per-hop node id
arrays ([B], [B·f1], [B·f1·f2], ...); the model takes their gathered
features and folds the hops inward. Each hop is a fixed [prev·fanout, F]
tensor, reshaped to [prev, fanout, F] and reduced over the fanout by the
aggregator (mean, sum or max), then combined with the self features by
``sum`` or ``concat``. No kernel: the aggregation is a dense reduction of
a reshaped tensor, as in JAX.

Parameter names follow the flax scopes (``layer{l}.neighbor.weight``,
``layer{l}.self.weight``, no bias), so ``params.from_flax`` carries the
JAX package's parameters across unchanged. Input widths are explicit:
a ``SageLayer`` takes ``in_features`` (and returns twice ``features``
with ``concat``); in ``SampledGraphSAGE``, whose layers combine by sum as
in JAX, layer 0 takes F and a later layer ``dims[l-1]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .conv import lecun_normal_


class SageLayer(nn.Module):
    """One SAGE combine: ``neighbor(agg(neighbours)) + self(x)``, or the two
    concatenated as ``[self, neighbor]``, then ReLU or nothing."""

    def __init__(self, in_features: int, features: int,
                 aggregator: str = "mean", combine: str = "sum",
                 activation: Optional[str] = "relu"):
        super().__init__()
        if aggregator not in ("mean", "sum", "max"):
            raise ValueError(f"unknown aggregator {aggregator!r}")
        if combine not in ("sum", "concat"):
            raise ValueError(f"unknown combine {combine!r}")
        self.aggregator = aggregator
        self.combine = combine
        self.activation = activation
        self.neighbor = nn.Linear(in_features, features, bias=False)
        self.self = nn.Linear(in_features, features, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's ``nn.Dense`` default: ``lecun_normal``."""
        for lin in (self.neighbor, self.self):
            lecun_normal_(lin.weight, lin.in_features, generator)

    def forward(self, self_feats: torch.Tensor, neigh_feats: torch.Tensor,
                fanout: int) -> torch.Tensor:
        nb = neigh_feats.reshape(self_feats.shape[0], fanout, -1)
        if self.aggregator == "mean":
            agg = nb.mean(dim=1)
        elif self.aggregator == "sum":
            agg = nb.sum(dim=1)
        else:
            agg = nb.amax(dim=1)
        neigh = self.neighbor(agg)
        self_h = self.self(self_feats)
        out = (neigh + self_h if self.combine == "sum"
               else torch.cat([self_h, neigh], dim=-1))
        if self.activation == "relu":
            out = F.relu(out)
        return out


class SampledGraphSAGE(nn.Module):
    """Hop-folding forward: with L layers and hops h_0 .. h_L, layer l maps
    (h_k, h_{k+1}) to h'_k for k < L - l; after L layers only h'_0 ([B,
    dims[-1]]) remains. The last layer has no activation."""

    def __init__(self, in_features: int, dims: Sequence[int],
                 fanouts: Sequence[int], aggregator: str = "mean"):
        super().__init__()
        if len(fanouts) != len(dims):
            raise ValueError(f"{len(dims)} layers need as many fanouts, "
                             f"got {tuple(fanouts)}")
        self.dims = tuple(dims)
        self.fanouts = tuple(fanouts)
        widths = (in_features,) + self.dims[:-1]
        for l, (w, d) in enumerate(zip(widths, self.dims)):
            act = "relu" if l < len(self.dims) - 1 else None
            self.add_module(f"layer{l}", SageLayer(
                w, d, aggregator=aggregator, activation=act))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.children():
            layer.reset_parameters(generator)

    def forward(self, hop_feats: Sequence[torch.Tensor]) -> torch.Tensor:
        n_layers = len(self.dims)
        if len(hop_feats) != n_layers + 1:
            raise ValueError(f"{n_layers} layers take {n_layers + 1} hops, "
                             f"got {len(hop_feats)}")
        hidden = list(hop_feats)
        for l, layer in enumerate(self.children()):
            hidden = [layer(hidden[k], hidden[k + 1], self.fanouts[k])
                      for k in range(n_layers - l)]
        return hidden[0]
