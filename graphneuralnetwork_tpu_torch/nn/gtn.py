"""GTN, the graph transformer network: learned metapath composition over a
dense edge-type stack (torch.nn).

Port of ``graphneuralnetwork_tpu/nn/gtn.py``:

  * ``GTConv`` mixes the stack [T, N, N] into one adjacency a channel,
    ``out[c] = sum_t softmax(w)[c, t] A[t]``;
  * ``GTLayer`` composes: the first ``Q1 @ Q2`` of two mixtures, a later
    one ``D^-1(H + I) @ Q`` of the previous layer's ``H``;
  * ``GTN`` stacks them, convolves the features with each channel's
    ``D^-1(H + I)`` through one shared ``gcn_w``, concatenates the channels
    and classifies with ``linear1`` and ``linear2``.

The attribute names are the flax scope names (``gt0.conv1.weight`` [C, T],
``gcn_w``, ``linear1``, ``linear2``), so ``params.from_flax`` maps a flax
tree onto ``state_dict()``. ``dtype`` is the compute dtype: the mixing
softmax and the row normalisation run in float32, the stack, the mixtures
and the compositions in ``dtype`` (a bfloat16 product accumulates in
float32, as the reference's ``preferred_element_type`` asks). The
channel-batched products are plain matrix products (``torch.matmul``), as
the reference computes them outside any Pallas kernel; float32 products
rely on PyTorch's default of no TF32, which this package never changes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .conv import lecun_normal_


def _row_normalize(h: torch.Tensor, add_eye: bool = True) -> torch.Tensor:
    """D^-1(H [+ I]) of each channel of ``h`` [C, N, N], the row sums in
    float32, the result in ``h``'s dtype."""
    if add_eye:
        h = h + torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    hf = h.float()
    deg = hf.sum(dim=-1, keepdim=True)
    return (hf / torch.clamp_min(deg, 1e-12)).to(h.dtype)


class GTConv(nn.Module):
    """``out[c] = sum_t softmax(weight)[c, t] a[t]``, weight [C, T]."""

    def __init__(self, channels: int, num_types: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, num_types))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, 0.1, generator=generator)

    def mix(self) -> torch.Tensor:
        """The float32 softmax mixing weights [C, T]."""
        return torch.softmax(self.weight, dim=-1)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        t, n, m = a.shape
        out = self.mix().to(a.dtype) @ a.reshape(t, n * m)
        return out.reshape(-1, n, m)


class GTLayer(nn.Module):
    """``first``: ``conv1(a) @ conv2(a)``; otherwise
    ``D^-1(h_prev + I) @ conv1(a)``, channel by channel."""

    def __init__(self, channels: int, num_types: int, first: bool = True):
        super().__init__()
        self.first = first
        self.conv1 = GTConv(channels, num_types)
        if first:
            self.conv2 = GTConv(channels, num_types)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for conv in self.children():
            conv.reset_parameters(generator)

    def forward(self, a: torch.Tensor,
                h_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.first:
            return torch.matmul(self.conv1(a), self.conv2(a))
        return torch.matmul(_row_normalize(h_prev), self.conv1(a))


class GTN(nn.Module):
    """``num_layers`` ``GTLayer``s (``gt0``, ...) compose a [C, N, N]
    metapath adjacency; ``gcn_w`` (no bias) convolves the features with
    each channel's ``D^-1(H + I)``; the channels' ReLUs concatenate into
    ``linear1`` (ReLU) and ``linear2``. Defaults of the reference: 2
    channels, 2 layers, hidden 64."""

    def __init__(self, in_features: int, num_types: int, num_classes: int,
                 channels: int = 2, num_layers: int = 2, hidden: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channels, self.num_layers = channels, num_layers
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"gt{i}", GTLayer(channels, num_types,
                                              first=i == 0))
        self.gcn_w = nn.Linear(in_features, hidden, bias=False)
        self.linear1 = nn.Linear(channels * hidden, hidden)
        self.linear2 = nn.Linear(hidden, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            getattr(self, f"gt{i}").reset_parameters(generator)
        for lin in (self.gcn_w, self.linear1, self.linear2):
            lecun_normal_(lin.weight, lin.in_features, generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ gcn_w`` in the compute dtype."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        return F.linear(x, self.gcn_w.weight.to(x.dtype))

    def _head(self, z: torch.Tensor) -> torch.Tensor:
        """The concatenated channels [N, C * hidden] to float32 logits."""
        out = F.relu(F.linear(z, self.linear1.weight.to(z.dtype),
                              self.linear1.bias.to(z.dtype)))
        return F.linear(out, self.linear2.weight.to(z.dtype),
                        self.linear2.bias.to(z.dtype)).float()

    def forward(self, a: torch.Tensor, x: torch.Tensor, *,
                return_weights: bool = False):
        """``a``: the stack [T, N, N] (the identity slice included);
        ``x``: [N, F]. Returns the logits, and with ``return_weights`` the
        last layer's composed adjacency [C, N, N] beside them."""
        if self.dtype is not None:
            a = a.to(self.dtype)
        h = self.gt0(a)
        for i in range(1, self.num_layers):
            h = getattr(self, f"gt{i}")(a, h)
        xw = self._features(x)
        z = F.relu(torch.matmul(_row_normalize(h), xw))       # [C, N, F]
        logits = self._head(z.transpose(0, 1).reshape(x.shape[0], -1))
        return (logits, h) if return_weights else logits
