"""Embedding models of the walk embedders (SkipGram, LINE, SDNE) and of
GATNE.

Port of ``graphneuralnetwork_tpu/nn/embed.py``:

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
  * ``GATNE``: GATNE-T (free ``base`` and ``edge`` tables) or GATNE-I
    (``feat_base`` and ``feat_edge`` maps of node features), its type
    attention over the per-type neighbour aggregates.

Parameter names follow the flax trees (``center``/``context``,
``vertex``/``context``, ``enc{i}``/``dec{i}``/``dec_out``, GATNE's
``base``/``edge``/``w_att``/``v_att``/``trans``/``feat_base``/
``feat_edge``), so
``params.from_flax`` carries them over. The tables' gradients are the
backward of an index gather: PyTorch's sorted ``index_put_``
accumulation on the card, which sums each id's rows in order on one warp
(no atomics, so a run repeats bit for bit; see
``train/embed_loop.py:spread_padding`` for what that costs on long runs).
Initialisation draws from an explicit ``torch.Generator``
(``reset_parameters``): the tables normal(0.01), the layers flax's
``lecun_normal`` and zero biases; GATNE's parameters flax's initialisers
of the JAX module (normal 0.5, 0.2 and 0.02, ``lecun_normal``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
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


def _by_type(pick: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[e_b]`` for each row b of the one-hot ``pick`` [B, T]: a
    product with the one-hot rows (exact: one term is 1 x the entry, the
    rest 0 x finite entries), whose backward is one more product. An
    index gather's backward would sum each type's B / T rows serially
    (``index_put_``'s sorted accumulation, one run an id): with two types
    that was half of a captured GATNE step on an H100
    (``tools/gatne_step.py``)."""
    return torch.einsum("be,e...->b...", pick, table)


class GATNE(nn.Module):
    """GATNE-T / GATNE-I (GATNE/models/GATNE.py:7-75): the L2-normalised
    embedding of each center under its edge type.

    Inputs per batch: center ids [B], edge-type ids [B] and per-type
    sampled neighbour ids [B, T, S]. Each type t aggregates (``mean`` or
    ``sum``) the type-t edge embeddings of its type-t neighbours into
    u_t [De]; attention softmax_t(v_e . tanh(W_e u_t)) over the types,
    with the center's edge type e selecting W_e and v_e, mixes them; the
    mix through trans_e [De, D] is added to the base embedding. GATNE-T's
    tables are free parameters, GATNE-I's linear maps of the node
    ``features`` (GATNE/models/GATNE.py:56).

    JAX gathers every type's embedding of every neighbour ([B, T, S, T,
    De]) and keeps the diagonal ``neigh[:, t, :, t, :]``; here each type's
    neighbours gather their own type only, a T-th of the gather, with the
    same values. The per-type attention and transform parameters are
    picked by a product with the center's one-hot type (``_by_type``)."""

    def __init__(self, vocab_size: int, num_edge_types: int,
                 embed_dim: int = 200, edge_embed_dim: int = 16,
                 attn_dim: int = 32, inductive: bool = False,
                 feature_dim: Optional[int] = None,
                 aggregator: str = "mean"):
        super().__init__()
        if aggregator not in ("mean", "sum"):
            raise ValueError(f"aggregator must be 'mean' or 'sum', got "
                             f"{aggregator!r}")
        T, De, Da, D = num_edge_types, edge_embed_dim, attn_dim, embed_dim
        self.num_edge_types, self.aggregator = T, aggregator
        self.inductive = inductive
        if inductive:
            if feature_dim is None:
                raise ValueError("GATNE-I needs feature_dim")
            self.feat_base = nn.Linear(feature_dim, D, bias=False)
            self.feat_edge = nn.Parameter(torch.empty(T, feature_dim, De))
        else:
            self.base = _table(vocab_size, D)
            self.edge = nn.Parameter(torch.empty(vocab_size, T, De))
        self.w_att = nn.Parameter(torch.empty(T, De, Da))
        self.v_att = nn.Parameter(torch.empty(T, Da, 1))
        self.trans = nn.Parameter(torch.empty(T, De, D))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            if self.inductive:
                lecun_normal_(self.feat_base.weight,
                              self.feat_base.in_features, generator)
                self.feat_edge.normal_(0.0, 0.02, generator=generator)
            else:
                self.base.normal_(0.0, 0.5, generator=generator)
                self.edge.normal_(0.0, 0.5, generator=generator)
            for p in (self.w_att, self.v_att, self.trans):
                p.normal_(0.0, 0.2, generator=generator)

    def _type_neighbors(self, neighbors: torch.Tensor,
                        features: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, T, S, De]: neighbour s of type t embedded under type t."""
        if self.inductive:
            return torch.einsum("btsf,tfd->btsd", features[neighbors],
                                self.feat_edge)
        types = torch.arange(self.num_edge_types, device=neighbors.device)
        return self.edge[neighbors, types[None, :, None]]

    def forward(self, centers: torch.Tensor, edge_type: torch.Tensor,
                neighbors: torch.Tensor,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        centers, edge_type = centers.long(), edge_type.long()
        neigh = self._type_neighbors(neighbors.long(), features)
        u = (neigh.sum(dim=2) if self.aggregator == "sum"
             else neigh.mean(dim=2))                        # [B, T, De]
        # the center's edge type picks W_e, v_e and trans_e
        pick = F.one_hot(edge_type, self.num_edge_types).to(u.dtype)
        att = torch.tanh(torch.einsum("btd,bda->bta", u,
                                      _by_type(pick, self.w_att)))
        att = torch.einsum("bta,bao->bto", att,
                           _by_type(pick, self.v_att))[..., 0]   # [B, T]
        att = torch.softmax(att, dim=-1)
        mixed = torch.einsum("bt,btd->bd", att, u)          # [B, De]
        delta = torch.einsum("bd,bdo->bo", mixed,
                             _by_type(pick, self.trans))
        base = (self.feat_base(features[centers]) if self.inductive
                else self.base[centers])
        emb = base + delta
        return emb / torch.clamp_min(
            torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)
