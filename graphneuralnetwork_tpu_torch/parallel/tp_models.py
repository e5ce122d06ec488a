"""The dp × tp forward of GCN, GAT, HAN and GTN on a "data" × "model" mesh.

The port's counterpart of what GSPMD derives from ``tp.py``'s rules in the
JAX package (its ``__graft_entry__.py`` phases 2, 2b and 4). Each model is
an ``nn.Module`` built from a single-device model and a mesh
(``make_tp_mesh``): it holds this rank's slices of the parameters
(``tp.apply_tp``) under the single-device names, and writes the
collectives out in the Megatron pattern (``collectives.copy_to`` into a
column-sharded layer, ``collectives.reduce_from`` out of a row-sharded
one). A column-sharded layer runs its own ``forward`` on its slices (a
``GATConv`` holding its local heads counts them in ``num_heads``); the
single-device layers in ``nn/`` are not changed.

The "data" axis: GCN, GAT and HAN take this rank's rows of a graph
partitioned over the data sub-mesh (``partition_graph_halo(...,
mesh=mesh.axis("data"))``; ``spmm``'s and the halo attention's K1, K2, and
K3/K7 on a tiled partition); GTN takes this rank's rows of the dense stack
(``gtn_rows``), each composition ``H_local @ all_gather_rows(A_mix)``.
On a 1-D data mesh every "model" collective is the identity: ``TPGTN``
there is the row-sharded dense GTN of JAX's phase 4.

The step (``tp_step``): the data-parallel loss share over the data
sub-mesh (``dp.dp_cross_entropy``), the gradients summed over the data
sub-mesh only (the convention in ``tp.py``'s docstring). The models run
without dropout, as JAX's tensor-parallel runs do; a model in training
mode with a dropout rate above 0 raises.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..nn.conv import GATConv
from ..nn.gtn import _row_normalize
from ..ops.segment import gat_edge_softmax
from ..ops.spmm import spmm, spmm_weighted
from .collectives import (all_gather_rows, all_reduce_sum, all_to_all_rows,
                          copy_to, reduce_from)
from .dp import dp_step
from .multihost import Mesh
from .tp import apply_tp, model_param_shardings, shard_rows


class _TPModel(nn.Module):
    """A single-device model's structure holding this rank's parameter
    slices under the same names (``specs``: each name's ``tp`` spec)."""

    family = ""

    def __init__(self, model: nn.Module, mesh: Mesh):
        super().__init__()
        if model.training and _dropout_rates(model):
            raise ValueError(f"tensor-parallel {self.family} runs without "
                             "dropout: call model.eval() or build it with "
                             "dropout 0")
        self.mesh = mesh
        self.data_mesh = mesh.axis("data")
        self.model_mesh = mesh.axis("model")
        state = model.state_dict()
        self.specs = model_param_shardings(mesh, state, self.family)
        local = apply_tp(state, self.specs, mesh)
        clone = copy.deepcopy(model)
        for name, t in local.items():
            owner, _, leaf = name.rpartition(".")
            setattr(clone.get_submodule(owner), leaf,
                    nn.Parameter(t.to(mesh.device)))
        for m in clone.modules():
            if isinstance(m, GATConv):
                m.num_heads = m.attn_src.shape[0]   # the heads it holds
        for name, child in clone.named_children():
            self.add_module(name, child)
        for k, v in vars(clone).items():
            if not k.startswith("_") and k != "training":
                setattr(self, k, v)
        super().train(model.training)

    def train(self, mode: bool = True):
        if mode and _dropout_rates(self):
            raise ValueError(f"tensor-parallel {self.family} runs without "
                             "dropout")
        return super().train(mode)


def _dropout_rates(model: nn.Module) -> list:
    rates = []
    for m in model.modules():
        for k in ("dropout", "attn_dropout"):
            v = getattr(m, k, 0.0)
            if isinstance(v, float) and v > 0.0:
                rates.append(v)
    return rates


def _reduce(partial: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``reduce_from`` in float32 (a bfloat16 sum of partial products
    would round each), returned in the partial's dtype."""
    return reduce_from(partial.float(), mesh).to(partial.dtype)


def _check_layout(graph) -> None:
    if hasattr(graph, "bcsr"):
        raise ValueError("tensor-parallel GAT and HAN take a COO Graph or a "
                         "halo partition, not the hybrid layout")


def _attend_out(conv, graph, proj: torch.Tensor) -> torch.Tensor:
    """GAT's output head after its row-sharded projection: ``conv``'s
    attention of ``proj`` [n, H, F], whole on every model rank, over a halo
    partition's rows (one exchange, K1 and K2) or a ``Graph``
    (``gat_edge_softmax``, as ``GATConv``'s COO path); the heads averaged,
    [n, F]."""
    pf = proj.float()
    f_src = torch.einsum("nhf,hf->nh", pf, conv.attn_src)
    f_dst = torch.einsum("nhf,hf->nh", pf, conv.attn_dst)
    if hasattr(graph, "halo_size"):
        from .halo_attention import gat_halo_attend
        out = gat_halo_attend(graph, proj, f_src, f_dst,
                              negative_slope=conv.negative_slope)
        return out.reshape(proj.shape).mean(1)
    alpha = gat_edge_softmax(graph, f_src, f_dst, conv.negative_slope)
    return spmm_weighted(graph, alpha, proj).mean(1)


class TPGCN(_TPModel):
    """GCN (``gcn_rules``): conv1 column-sharded with its bias, conv2
    row-sharded (``reduce_from``, then its replicated bias)."""

    family = "gcn"

    def forward(self, graph, x: torch.Tensor) -> torch.Tensor:
        mp = self.model_mesh
        c2 = self.conv2
        h = F.relu(self.conv1(graph, copy_to(x, mp)))
        if c2.dtype is not None:
            h = h.to(c2.dtype)
        support = _reduce(F.linear(h, c2.linear.weight.to(h.dtype)), mp)
        return (spmm(graph, support) + c2.bias.to(h.dtype)).float()


class TPGAT(_TPModel):
    """GAT (``gat_rules``): attn1's projection column-sharded by whole
    heads (its attention vectors on the head axis), attn_out's projection
    row-sharded (``reduce_from``); the output head's attention replicated
    on every model rank."""

    family = "gat"

    def forward(self, graph, x: torch.Tensor) -> torch.Tensor:
        _check_layout(graph)
        mp = self.model_mesh
        h = F.elu(self.attn1(graph, copy_to(x, mp)))
        out = self.attn_out
        if out.dtype is not None:
            h = h.to(out.dtype)
        proj = _reduce(F.linear(h, out.linear.weight.to(h.dtype)), mp)
        proj = proj.reshape(h.shape[0], out.num_heads, out.features)
        return _attend_out(out, graph, proj).float()


class TPHAN(_TPModel):
    """HAN (``han_rules``): each metapath GAT column-sharded by heads; the
    semantic projection row-sharded (``reduce_from``), then its bias,
    ``tanh`` and ``q``; the mean over rows global over the data sub-mesh;
    β replicated and ``Σ β_p z_p`` column-local; ``classify``
    row-sharded. A later layer's input is the previous layer's columns
    gathered over the model axis."""

    family = "han"

    def _semantic(self, sem, z: torch.Tensor, graphs) -> torch.Tensor:
        mp = self.model_mesh
        z = z.float()
        proj = reduce_from(F.linear(z, sem.proj.weight), mp) + sem.proj.bias
        scores = torch.tanh(proj) @ sem.q                      # [P, n, 1]
        g0 = graphs[0]
        if hasattr(g0, "halo_size"):
            m = g0.local.row_mask.float()[None, :, None]
            total = all_reduce_sum((scores * m).sum(dim=1), g0.mesh)
            count = all_reduce_sum(m.sum(dim=1), g0.mesh)
            mean = total / torch.clamp_min(count, 1.0)
        else:
            mean = scores.mean(dim=1)
        beta = copy_to(torch.softmax(mean, dim=0), mp)         # [P, 1]
        return (beta[:, None, :] * z).sum(dim=0)

    def forward(self, graphs, x: torch.Tensor) -> torch.Tensor:
        _check_layout(graphs[0])
        mp = self.model_mesh
        h = copy_to(x, mp)
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if i:
                h = all_gather_rows(h.t().contiguous(), mp).t()
            z = torch.stack([F.elu(getattr(layer, f"gat_mp{p}")(g, h))
                             for p, g in enumerate(graphs)])
            h = self._semantic(layer.semantic, z, graphs)
        if self.dtype is not None:
            h = h.to(self.dtype)
        cls = self.classify
        out = _reduce(F.linear(h, cls.weight.to(h.dtype)), mp)
        return (out + cls.bias.to(h.dtype)).float()


def _reshard_plan(channels: int, hidden: int, m: int) -> tuple:
    """How the channels' hidden slices [C, hid/M] that each model rank
    holds become the rule's contiguous blocks of the channel-major concat
    (C·hid/M columns a rank): (``send`` [M·P] columns of a rank's
    flattened slices, in destination order and padded with 0;
    ``recv`` [C·hid/M] columns of the received [M·P] slab, source-major).
    Rank ``r``'s column ``c·k + j`` (k = hid/M) is column ``c·hid + r·k +
    j`` of the concat."""
    k, block = hidden // m, channels * hidden // m
    col = [[c * hidden + r * k + j for c in range(channels)
            for j in range(k)] for r in range(m)]
    pairs = [[[i for i, g in enumerate(col[r]) if g // block == b]
              for b in range(m)] for r in range(m)]
    p = max(len(x) for row in pairs for x in row)
    send = np.zeros((m, m, p), np.int64)
    recv = np.zeros((m, block), np.int64)
    for r in range(m):
        for b in range(m):
            idx = pairs[r][b]
            send[r, b, :len(idx)] = idx
            for slot, i in enumerate(idx):
                recv[b, col[r][i] - b * block] = r * p + slot
    return send, recv, p


def gtn_rows(adj, x, mesh: Mesh) -> tuple:
    """This rank's rows over the mesh's "data" axis of the dense stack
    ``adj`` [T, N, N] (rows ``adj[:, rows, :]``) and of the features ``x``
    [N, F], zero-padded so that the axis divides N, on its device."""
    a = np.asarray(adj)
    rows = shard_rows(np.ascontiguousarray(a.transpose(1, 0, 2)), mesh)
    return rows.transpose(0, 1).contiguous(), shard_rows(x, mesh)


class TPGTN(_TPModel):
    """The dense GTN (``gtn_rules``) on this rank's rows of the stack
    (``gtn_rows``): each composition ``H_local @ all_gather_rows(A_mix)``
    over "data" (its backward each rank's slice of the summed gradient),
    the row normalisation row-local, one all-gather of the projected rows
    ``x @ gcn_w`` for the final convolution; ``gcn_w`` column-sharded over
    "model", the GT mixing weights and ``linear2`` replicated, ``linear1``
    row-sharded over channels·hidden after an all-to-all of the channels'
    hidden slices into the rule's row blocks. On a 1-D data mesh this is
    the row-sharded dense GTN."""

    family = "gtn"

    def __init__(self, model: nn.Module, mesh: Mesh):
        super().__init__(model, mesh)
        m = self.model_mesh.size
        hidden = self.linear2.weight.shape[1]
        self._send, self._recv, self._slab = _reshard_plan(
            self.channels, hidden, m)

    def _full(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """[C, n_local, N] rows -> every rank's rows, [C, N, N]."""
        g = all_gather_rows(t.transpose(0, 1).contiguous(), self.data_mesh)
        return g[:n].transpose(0, 1)

    def _normalize(self, h: torch.Tensor) -> torch.Tensor:
        """D^-1(H + I) of this rank's rows of each channel."""
        nl, n = h.shape[1], h.shape[2]
        lo = self.data_mesh.rank * nl
        rows = lo + torch.arange(nl, device=h.device)
        eye = (rows[:, None] == torch.arange(n, device=h.device)[None])
        return _row_normalize(h + eye.to(h.dtype), add_eye=False)

    def _reshard(self, z: torch.Tensor) -> torch.Tensor:
        """[n_local, C, hid/M] hidden slices -> this model rank's block of
        the channel-major concat [n_local, C·hid/M] (one all-to-all)."""
        mp = self.model_mesh
        nl = z.shape[0]
        flat = z.reshape(nl, -1)
        if mp.size == 1:
            return flat
        me = mp.rank
        send = torch.from_numpy(self._send[me].reshape(-1)).to(z.device)
        slab = flat[:, send].reshape(nl, mp.size, self._slab)
        got = all_to_all_rows(slab.transpose(0, 1).reshape(-1, self._slab),
                              mp)
        got = got.reshape(mp.size, nl, self._slab).transpose(0, 1)
        recv = torch.from_numpy(self._recv[me]).to(z.device)
        return got.reshape(nl, -1)[:, recv]

    def forward(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``a``: this rank's rows of the stack [T, n_local, N]; ``x`` its
        rows of the features [n_local, F]. Returns its rows' logits."""
        n = a.shape[2]
        if self.dtype is not None:
            a = a.to(self.dtype)
        h = torch.matmul(self.gt0.conv1(a), self._full(self.gt0.conv2(a), n))
        for i in range(1, self.num_layers):
            q = self._full(getattr(self, f"gt{i}").conv1(a), n)
            h = torch.matmul(self._normalize(h), q)
        xw = all_gather_rows(self._features(x), self.data_mesh)[:n]
        hn = copy_to(self._normalize(h), self.model_mesh)
        z = F.relu(torch.matmul(hn, xw))                  # [C, nl, hid/M]
        zb = self._reshard(z.transpose(0, 1))
        l1, l2 = self.linear1, self.linear2
        out = F.relu(_reduce(F.linear(zb, l1.weight.to(zb.dtype)),
                             self.model_mesh) + l1.bias.to(zb.dtype))
        return F.linear(out, l2.weight.to(zb.dtype),
                        l2.bias.to(zb.dtype)).float()

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        return F.linear(x, self.gcn_w.weight.to(x.dtype))


TP_MODELS = {"gcn": TPGCN, "gat": TPGAT, "han": TPHAN, "gtn": TPGTN}


def tensor_parallel(model: nn.Module, mesh: Mesh, family: str) -> _TPModel:
    """``model`` (a single-device GCN, GAT, HAN or GTN) as this rank's
    tensor-parallel module on ``mesh``."""
    return TP_MODELS[family](model, mesh)


def tp_step(model: _TPModel, optimizer: torch.optim.Optimizer,
            local_loss: Callable[[], torch.Tensor]) -> torch.Tensor:
    """One optimizer step: ``local_loss()`` (this rank's data-parallel
    share, the same on every model rank), backward, the gradients summed
    over the data sub-mesh only, the step. Returns the global loss."""
    return dp_step(model.parameters(), optimizer, local_loss,
                   model.data_mesh)
