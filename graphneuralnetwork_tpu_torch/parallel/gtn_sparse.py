"""The wedge-plan GTN with its compositions split over a mesh.

Port of ``graphneuralnetwork_tpu/parallel/gtn_sparse.py``. The sparse GTN
(``nn/gtn_sparse.py``) composes ``H' = H @ (sum_u mix_u A_u)`` as a gather,
a multiply and a segment sum over the wedges of a host-built plan. This
module partitions each step's wedges **by output slot** (receiver-owned,
like the halo partition): each rank owns a contiguous range of the output
pattern's slots and every wedge landing there, so its segment sum is
local, and the only collective a step is one all-gather of the composed
values (O(nnz)), since every rank needs the whole ``H'`` for its next
gathers.

Wedge ranges are balanced by wedge count: slot boundaries are the
``searchsorted`` of the cumulative per-slot wedge histogram, made
monotone (``np.maximum.accumulate``), so a hub row does not serialise one
rank, and a small plan may leave a rank no slot and no wedge. The host
arrays (``shard_gtn_plan``: per step ``[K, W_k]`` wedge arrays padded
with inert ``a_val = 0`` wedges, the slot counts and the padded width) are
byte-equal to JAX's. From them each rank builds only its own two
``WedgeOrder``s: ``fwd``, its real wedges sorted by (local slot, type),
and ``bwd``, the same wedges sorted by input slot.

``compose_sharded``: K1's gathered form over the rank's ``fwd`` order
(blocked by ``wedge_block`` like the single-device compose), the mix,
``[slot_cnt_r, C]`` padded to ``l_pad``, one all-gather, and the cut of
each rank's real span by the host's ``slot_cnt`` (no host sync in the
step). The channels stay ``[rows, C]`` columns, as in the single-device
compose, where JAX folds them into 1-D ids.

**The gradient.** Every rank computes the same replicated loss (the rest
of the model runs whole on every rank, as in JAX, whose ``shard_map``
transpose psums the replicated operands' gradients). So the gather's
backward keeps the rank's own slice, without a sum
(``collectives.all_gather_rows_own``), and the composition's ``dh`` (K1
over the ``bwd`` order) and ``d mix`` (from the local ``q``), each partial,
are summed over the ranks inside the backward. After ``backward`` every
rank holds the single-device gradients: no step-level all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..nn.gtn_sparse import GTNPlan, WedgeOrder, _order
from .collectives import _psum, all_gather_rows_own
from .multihost import Mesh


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGTNPlan:
    """``GTNPlan`` plus per-rank wedge partitions (leading axis = rank,
    host numpy, JAX's leaves; ``wedge_cnt`` is the port's own: each rank's
    real wedges); ``fwd``/``bwd``: the live rank's device
    orders per step (empty on a ``Mesh.layout``, where a caller builds any
    rank's with ``orders(rank, device)``). Every other attribute
    (``nnz``, ``n_nodes``, ``n_types``, ``step_row``, ``final_graph``,
    ...) is the base plan's."""

    base: GTNPlan
    sh_h_idx: Tuple[np.ndarray, ...]     # per step: int32[K, W_k]
    sh_type: Tuple[np.ndarray, ...]      # int32[K, W_k]
    sh_a_val: Tuple[np.ndarray, ...]     # float32[K, W_k] (0 on padding)
    sh_out_loc: Tuple[np.ndarray, ...]   # int32[K, W_k] local slot ids
    slot_cnt: Tuple[Tuple[int, ...], ...]  # real slots per rank per step
    l_pad: Tuple[int, ...]               # max slots per rank per step
    wedge_cnt: Tuple[Tuple[int, ...], ...]  # real wedges per rank per step
    mesh: Mesh                           # 1-D, along ``axis``
    axis: str
    fwd: Tuple[WedgeOrder, ...] = ()
    bwd: Tuple[WedgeOrder, ...] = ()

    def __getattr__(self, name):
        # delegates so that SparseGTN treats both plan types alike
        if name.startswith("__") or name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)

    def orders(self, rank: int, device: str | torch.device
               ) -> Tuple[Tuple[WedgeOrder, ...], Tuple[WedgeOrder, ...]]:
        """Rank ``rank``'s ``fwd`` and ``bwd`` orders of every step, on
        ``device``."""
        device = torch.device(device)
        fwd, bwd = [], []
        for s in range(len(self.l_pad)):
            m = self.wedge_cnt[s][rank]
            h = self.sh_h_idx[s][rank, :m]
            a = self.sh_a_val[s][rank, :m]
            rows = (self.sh_out_loc[s][rank, :m].astype(np.int64)
                    * self.n_types + self.sh_type[s][rank, :m])
            fwd.append(_order(h, rows, a, self.l_pad[s] * self.n_types,
                              device))
            bwd.append(_order(rows, h, a, self.nnz[s], device))
        return tuple(fwd), tuple(bwd)

    def warm(self) -> "ShardedGTNPlan":
        """The base plan's first-use caches and the rank's orders' long
        rows (host syncs), before a CUDA graph's capture."""
        self.base.warm()
        for order in (*self.fwd, *self.bwd):
            order.graph.long_rows
        return self


def shard_gtn_plan(plan: GTNPlan, mesh: Mesh,
                   axis: str = "data") -> ShardedGTNPlan:
    """Host-side wedge partitioning by output slot over the mesh's axis
    ``axis``, balanced by wedge count; per-rank arrays padded to a common
    width with inert (``a_val = 0``) wedges. The plan runs on the 1-D mesh
    along ``axis`` (``Mesh.axis``): on a live mesh this process's position
    there picks its orders, which go to its device, and the collectives
    span that axis alone."""
    k = int(mesh.shape[axis])
    mesh = mesh.axis(axis) if mesh.live else Mesh.layout(k, axis)
    sh_h, sh_t, sh_a, sh_o = [], [], [], []
    slot_cnt, l_pad, counts = [], [], []
    for s in range(len(plan.wedge_counts)):
        h_idx = np.asarray(plan.step_h_idx[s])
        t_idx = np.asarray(plan.step_type[s])
        a_val = np.asarray(plan.step_a_val[s])
        out = np.asarray(plan.step_out[s], np.int64)
        nnz_out = plan.nnz[s + 1]

        order = np.argsort(out, kind="stable")
        h_idx, t_idx, a_val, out = (h_idx[order], t_idx[order],
                                    a_val[order], out[order])
        # slot boundaries balancing wedge count: rank j owns slots
        # [bounds[j], bounds[j+1]) and the (contiguous) wedges there
        w = len(out)
        per_slot = np.bincount(out, minlength=nnz_out)
        cum = np.concatenate([[0], np.cumsum(per_slot)])
        targets = (np.arange(1, k) * w) // k
        bounds = np.concatenate(
            [[0], np.searchsorted(cum[1:], targets, side="left") + 1,
             [nnz_out]])
        bounds = np.maximum.accumulate(bounds)   # monotone slot ranges
        wlo = cum[bounds]                        # wedge range per rank

        wk = int(max((wlo[1:] - wlo[:-1]).max(initial=1), 1))
        cnts = (bounds[1:] - bounds[:-1]).astype(np.int64)
        lp = int(max(cnts.max(initial=1), 1))
        H = np.zeros((k, wk), np.int32)
        T = np.zeros((k, wk), np.int32)
        A = np.zeros((k, wk), np.float32)        # 0 = inert padding
        O = np.zeros((k, wk), np.int32)
        for j in range(k):
            lo, hi = int(wlo[j]), int(wlo[j + 1])
            m = hi - lo
            H[j, :m] = h_idx[lo:hi]
            T[j, :m] = t_idx[lo:hi]
            A[j, :m] = a_val[lo:hi]
            O[j, :m] = out[lo:hi] - bounds[j]    # rebase to local slots
        sh_h.append(H)
        sh_t.append(T)
        sh_a.append(A)
        sh_o.append(O)
        slot_cnt.append(tuple(int(c) for c in cnts))
        l_pad.append(lp)
        counts.append(tuple(int(c) for c in wlo[1:] - wlo[:-1]))

    splan = ShardedGTNPlan(
        base=plan, sh_h_idx=tuple(sh_h), sh_type=tuple(sh_t),
        sh_a_val=tuple(sh_a), sh_out_loc=tuple(sh_o),
        slot_cnt=tuple(slot_cnt), l_pad=tuple(l_pad),
        wedge_cnt=tuple(counts), mesh=mesh, axis=axis)
    if mesh.live:
        fwd, bwd = splan.orders(mesh.rank, mesh.device)
        object.__setattr__(splan, "fwd", fwd)
        object.__setattr__(splan, "bwd", bwd)
    return splan


class _LocalCompose(torch.autograd.Function):
    """This rank's slots of ``H @ (sum_u mix_u A_u)``, [l_pad, C]: ``q``
    over its ``fwd`` order (K1), then the mix. The backward sums its
    partial ``dh`` (K1 over ``bwd``) and ``d mix`` over the ranks."""

    @staticmethod
    def forward(ctx, h, mix, fwd: WedgeOrder, bwd: WedgeOrder, limit: int,
                l_pad: int, mesh: Mesh):
        n_t, c = mix.shape[1], mix.shape[0]
        q = fwd.sum(h, limit).view(l_pad, n_t, c)
        ctx.save_for_backward(q, mix)
        ctx.bwd, ctx.limit, ctx.mesh = bwd, limit, mesh
        return (q * mix.t()).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        q, mix = ctx.saved_tensors
        g = g.contiguous()
        dmix = _psum(torch.einsum("otc,oc->ct", q, g), ctx.mesh)
        dq = (g[:, None, :] * mix.t()[None]).reshape(-1, g.shape[1])
        dh = _psum(ctx.bwd.sum(dq.contiguous(), ctx.limit), ctx.mesh)
        return dh, dmix, None, None, None, None, None


def compose_sharded(plan: ShardedGTNPlan, h: torch.Tensor, mix: torch.Tensor,
                    s: int, limit: int) -> torch.Tensor:
    """``H' = H @ (sum_u mix_u A_u)`` over the sharded wedge partition of
    step ``s``: ``h`` float32 [nnz_s, C] whole on every rank, ``mix``
    [C, T]; returns [nnz_{s+1}, C] whole on every rank. ``limit`` caps the
    channel-wedges of one K1 call, per rank."""
    mesh = plan.mesh
    lp = plan.l_pad[s]
    local = _LocalCompose.apply(h, mix, plan.fwd[s], plan.bwd[s], limit, lp,
                                mesh)
    full = all_gather_rows_own(local, mesh)
    cnt = plan.slot_cnt[s]
    return torch.cat([full[j * lp:j * lp + cnt[j]] for j in range(len(cnt))])
