"""Embedding models of the walk embedders: SkipGram, LINE, SDNE.

Port of ``graphneuralnetwork_tpu/nn/embed.py`` (GATNE is not ported yet):

  * ``SkipGram``: a center and a context table; the logits of a padded
    batch are center[c_b] . context[ctx_neg[b, j]]. DeepWalk, Node2vec,
    Struc2Vec and MetaPath2Vec train it and differ only in their walks.
  * ``LINE``: a vertex and a context table; first-order logits
    vertex . vertex, second-order vertex . context.
  * ``SDNE``: an autoencoder over dense adjacency rows (sigmoid layers of
    ``hidden_dims``, mirrored back to ``n_nodes``), returning the
    embedding and the reconstruction; ``sdne_loss_first`` (the batch
    Laplacian's trace penalty) and ``sdne_loss_second`` (the beta-weighted
    reconstruction).

Parameter names follow the flax trees (``center``/``context``,
``vertex``/``context``, ``enc{i}``/``dec{i}``/``dec_out``), so
``params.from_flax`` carries them over. The tables' gradients are the
backward of an index gather: PyTorch's sorted ``index_put_``
accumulation on the card, which sums each id's rows in order on one warp
(no atomics, so a run repeats bit for bit; see
``train/embed_loop.py:spread_padding`` for what that costs on long runs).
Initialisation draws from an explicit ``torch.Generator``
(``reset_parameters``): the tables normal(0.01), the layers flax's
``lecun_normal`` and zero biases.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .conv import lecun_normal_


def _table(vocab_size: int, embed_dim: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(vocab_size, embed_dim))


def _normal_tables(module: nn.Module,
                   generator: Optional[torch.Generator]) -> None:
    """Every parameter of ``module`` drawn from normal(0, 0.01), as flax's
    ``normal(0.01)`` initialiser."""
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.01, generator=generator)


class SkipGram(nn.Module):
    """logits[b, j] = center[centers[b]] . context[ctx_neg[b, j]]."""

    def __init__(self, vocab_size: int, embed_dim: int = 128):
        super().__init__()
        self.center = _table(vocab_size, embed_dim)
        self.context = _table(vocab_size, embed_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _normal_tables(self, generator)

    def forward(self, centers: torch.Tensor,
                ctx_neg: torch.Tensor) -> torch.Tensor:
        v = self.center[centers.long()]               # [B, D]
        u = self.context[ctx_neg.long()]              # [B, L, D]
        return torch.einsum("bd,bld->bl", v, u)       # [B, L]

    def embedding(self) -> torch.Tensor:
        """The node embedding: the center table."""
        return self.center


class LINE(nn.Module):
    """(first, second) logits of a padded batch: vertex[c] . vertex[x] and
    vertex[c] . context[x]."""

    def __init__(self, vocab_size: int, embed_dim: int = 128):
        super().__init__()
        self.vertex = _table(vocab_size, embed_dim)
        self.context = _table(vocab_size, embed_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _normal_tables(self, generator)

    def forward(self, centers: torch.Tensor, ctx_neg: torch.Tensor):
        ctx_neg = ctx_neg.long()
        v = self.vertex[centers.long()]
        first = torch.einsum("bd,bld->bl", v, self.vertex[ctx_neg])
        second = torch.einsum("bd,bld->bl", v, self.context[ctx_neg])
        return first, second

    def embedding(self) -> torch.Tensor:
        return self.vertex


class SDNE(nn.Module):
    """Encoder ``hidden_dims`` and decoder back to ``n_nodes`` over dense
    adjacency rows, sigmoid after every layer; returns (embedding Y,
    reconstruction X_hat)."""

    def __init__(self, n_nodes: int, hidden_dims: Sequence[int] = (256, 128)):
        super().__init__()
        dims = [n_nodes, *hidden_dims]
        self.layer_names = []
        for i in range(len(hidden_dims)):
            self.add_module(f"enc{i}", nn.Linear(dims[i], dims[i + 1]))
            self.layer_names.append(f"enc{i}")
        back = list(reversed(hidden_dims[:-1]))
        prev = hidden_dims[-1]
        for i, d in enumerate(back):
            self.add_module(f"dec{i}", nn.Linear(prev, d))
            self.layer_names.append(f"dec{i}")
            prev = d
        self.dec_out = nn.Linear(prev, n_nodes)
        self.layer_names.append("dec_out")
        self.n_encoder = len(hidden_dims)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for name in self.layer_names:
                lin = getattr(self, name)
                lecun_normal_(lin.weight, lin.in_features, generator)
                lin.bias.zero_()

    def forward(self, adj_rows: torch.Tensor):
        h = adj_rows
        y = None
        for i, name in enumerate(self.layer_names):
            h = torch.sigmoid(getattr(self, name)(h))
            if i == self.n_encoder - 1:
                y = h
        return y, h


def sdne_loss_first(y: torch.Tensor, batch_l: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """alpha * 2 tr(Y^T L Y) on the batch sub-Laplacian ``batch_l``. The
    trace is the diagonal's sum: ``torch.trace``'s backward reads its
    gradient on the host, which a CUDA graph cannot capture."""
    return alpha * 2.0 * torch.diagonal(y.T @ batch_l @ y).sum()


def sdne_loss_second(x_hat: torch.Tensor, adj_rows: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """The reconstruction error weighted ``beta`` where A > 0, else 1."""
    b = torch.where(adj_rows > 0, beta, 1.0)
    return torch.sum(((x_hat - adj_rows) * b) ** 2)
