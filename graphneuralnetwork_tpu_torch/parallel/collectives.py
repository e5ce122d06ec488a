"""The collectives that ``jax.shard_map`` and GSPMD give the JAX package
implicitly, each differentiable, over ``torch.distributed``.

  * ``all_gather_rows``: the tiled row all-gather of ``sharded.py``
    (``jax.lax.all_gather(..., tiled=True)``); its backward sums the
    gradient over the ranks and keeps each rank's slice, as one
    ``all_to_all`` and a local sum (gloo has no reduce-scatter);
  * ``all_to_all_rows``: the tiled all-to-all of ``[D·H, F]`` slabs of the
    halo exchange (``jax.lax.all_to_all``); its backward is the same
    exchange of the gradient;
  * ``all_gather_rows_own``: the same all-gather where every rank goes on
    to compute the same replicated result (the sharded wedge plan's
    compositions, ``gtn_sparse.py``): every rank then holds the whole
    gradient, and the backward keeps the rank's own slice, no sum;
  * ``all_reduce_sum``: a psum whose result every rank consumes; its
    backward is the psum of the gradient. The data-parallel loss share
    (``dp.py``) takes it: every rank's share adds to the loss, so each
    rank's gradient of the sum is the psum of theirs;
  * ``copy_to`` and ``reduce_from``: Megatron's two region functions for
    tensor parallelism over the "model" axis (``tp_models.py``).
    ``copy_to`` marks a tensor that every model rank holds whole entering
    a column-sharded layer: the identity forward, the psum of the partial
    gradients backward. ``reduce_from`` ends a row-sharded layer: the psum
    of the partial products forward, the identity backward (every model
    rank goes on with the same sum and gets the same gradient). Unlike
    ``all_reduce_sum`` neither sums twice;
  * ``all_reduce_gradients`` and ``broadcast_parameters``: the psum GSPMD
    inserts for replicated parameters, and identical initial parameters.

Each takes the ``Mesh`` (``multihost.py``). On a mesh outside a process
group (one process) they are the identity.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from .multihost import Mesh


def _all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank r's block p of ``x`` goes to rank p, where it is block r."""
    if mesh.group is None:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh), None


def all_to_all_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` [D·H, ...] in D blocks of H rows: block p goes to rank p; the
    result holds block r of every rank p at block p."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"all_to_all_rows: {x.shape[0]} rows do not split "
                         f"over {mesh.size} ranks")
    return _AllToAll.apply(x, mesh)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.group is None:
        return x.clone()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        # every rank's gradient of the whole table, summed on the rank that
        # owns each slice
        parts = _all_to_all(g, ctx.mesh)
        return parts.view(ctx.mesh.size, ctx.rows, *g.shape[1:]).sum(0), None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` [R, ...] stacked in rank order: [D·R, ...]."""
    return _AllGather.apply(x, mesh)


class _AllGatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows].contiguous(), None


def all_gather_rows_own(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_gather_rows`` whose result feeds a computation that every rank
    repeats: the backward takes this rank's slice of its own gradient,
    which every rank holds whole."""
    return _AllGatherOwn.apply(x, mesh)


def _psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.clone()
    if mesh.group is not None:
        dist.all_reduce(x, group=mesh.group)
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank."""
    return _AllReduce.apply(x, mesh)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, held whole by every rank of ``mesh`` (the "model" axis),
    entering a column-sharded layer: the identity; the backward sums the
    ranks' partial gradients."""
    return _CopyTo.apply(x, mesh)


def reduce_from(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks of ``mesh`` (the "model" axis) of a
    row-sharded layer's partial products, on every rank; the backward is
    the identity."""
    return _ReduceFrom.apply(x, mesh)


def all_reduce_gradients(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks, in place, in one
    collective (a parameter without a gradient contributes zeros)."""
    params = [p for p in params if p.requires_grad]
    if mesh.group is None or not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    dist.all_reduce(flat, group=mesh.group)
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p).to(p.dtype)
        at += n


def broadcast_parameters(module: torch.nn.Module, mesh: Mesh,
                         src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers to every rank."""
    if mesh.group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=mesh.group)
