"""K5 and K6: the gradient of the hybrid GAT attend
(``csrc/attend_bwd_kernel.cu``).

Given the forward's shift ``m`` (0 where ``den == 0``), the caller's
``gn = g / den`` ([N, H*F] in x's type, 0 on empty rows) and
``fdm3 = [f_dst | m | dden]`` (float32 [N, 3H], ``dden = -sum_f g*out /
den``), every edge s -> r recomputes ``p = w * exp(min(LeakyReLU(f_dst[r]
+ f_src[s]) - m[r], 0))`` and

  * ``attend_bwd_a`` (K5, pass A, receiver rows of the forward layout)
    returns ``dfd[r,h] = sum_s p * (keep * gn[r,h,:].x[s,h,:] + dden[r,h])
    * leaky'`` (float32 [N, H]);
  * ``attend_bwd_b`` (K6, pass B, sender rows of the transpose layout)
    returns ``dx[s,h,:] = sum_r p * keep * gn[r,h,:]`` (x's type) and
    ``dfs[s,h] = sum_r`` of the same per-edge term as ``dfd``.

``keep`` is the forward's dropout multiplier, from the same ``bits`` and
``keep_mul``: pass B reads them through ``hg.bits_tmap`` (transposed) and
``hg.rem_t_eperm``. They replace the TPU kernels ``_bwd_a_kernel`` and
``_bwd_b_kernel`` of ``graphneuralnetwork_tpu/ops/pallas/attend_bwd_kernel.py``
(``attend_bwd_a_pallas``, ``attend_bwd_b_pallas``); the design notes are in
the CUDA source. Both passes walk each row as K4 walks a receiver row
(``csrc/attend_walk.cuh``, ``attend_common.attend_layout``,
``HybridGraph.row_edges`` and ``long_rows``: pass A the forward side, pass
B the transpose side), a slab of whole heads at a time. Pass A sums
``p * keep * leaky' * x[s]`` over each row's edges and dots it with the
row's own ``gn`` once, since ``dfd`` is linear in ``x[s]``. A head wider
than one warp holds (512 features of 16-byte vectors; 256 scalars in
pass A, 128 in pass B) splits into parts: pass A walks each batch of a row
part by part, pass B the row part by part. ``bwd_a_args`` builds
pass A's launch arguments. A CUDA tensor launches the kernel; a CPU tensor
takes ``attend_bwd_a_plain`` / ``attend_bwd_b_plain``, which compute the
same passes from the same operands without autograd.
``attend_bwd_a.launches`` and ``attend_bwd_b.launches`` count launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.bcsr import HybridGraph
from .attend_common import (LONG_ROW_EDGES, SCALAR_ARGTYPES,
                            WIDE_SCALARS_PER_LANE, check_operands,
                            cuda_stream, edge_chunks, keep_factors, leaky,
                            leaky_grad, ptr, scalar_args, tile_slots,
                            walk_layout)
from .attend_online_kernel import forward_edges
from .build import check, load


def _transpose_edges(hg: HybridGraph, bits: Optional[torch.Tensor],
                     keep_mul: Optional[torch.Tensor], heads: int,
                     keep_prob: float):
    """The transpose layout as one edge list: (senders, receivers, weights,
    numerator multiplier or None), with the forward's masks viewed through
    the alignment maps."""
    rem_t = hg.rem_t
    t, i, j, t_send, t_recv, t_w = tile_slots(hg.bcsr_t)
    e = rem_t.n_edges
    send = torch.cat([t_send, rem_t.receivers[:e].long()])
    recv = torch.cat([t_recv, rem_t.senders[:e].long()])
    w = torch.cat([t_w, rem_t.edge_weight[:e]])
    keep = None
    if keep_prob < 1.0:
        words = bits[hg.bits_tmap[t].long(), j, i]   # transposed lattice
        keep = torch.cat([keep_factors(words, heads, keep_prob),
                          keep_mul[hg.rem_t_eperm[:e].long()]])
    return send, recv, w, keep


def _edge_terms(recv, send, w, keep, x, gn, f_src, fdm3, slope):
    """Per edge: p, the masked p and ds = p * (keep * q + dden) * leaky'."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    fd, m, dden = fdm3[:, :heads], fdm3[:, heads:2 * heads], fdm3[:, 2 * heads:]
    pre = fd[recv] + f_src[send]
    p = w[:, None] * torch.exp(torch.clamp_max(leaky(pre, slope) - m[recv],
                                               0.0))
    q = torch.empty_like(p)
    for sl in edge_chunks(recv.shape[0], hf):
        q[sl] = (gn[recv[sl]].float().view(-1, heads, feat)
                 * x[send[sl]].float().view(-1, heads, feat)).sum(-1)
    if keep is not None:
        q = q * keep
    ds = p * (q + dden[recv]) * leaky_grad(pre, slope)
    return p, (p if keep is None else p * keep), ds


def attend_bwd_a_plain(hg: HybridGraph, x: torch.Tensor, gn: torch.Tensor,
                       f_src: torch.Tensor, fdm3: torch.Tensor,
                       bits: Optional[torch.Tensor],
                       keep_mul: Optional[torch.Tensor], slope: float,
                       keep_prob: float) -> torch.Tensor:
    """Pass A in plain PyTorch, over the forward layout: dfd [N, H]."""
    heads = f_src.shape[1]
    recv, send, w, _, keep = forward_edges(hg, bits, keep_mul, heads,
                                           keep_prob)
    _, _, ds = _edge_terms(recv, send, w, keep, x, gn, f_src, fdm3, slope)
    return torch.zeros(x.shape[0], heads, dtype=torch.float32,
                       device=x.device).index_add_(0, recv, ds)


def attend_bwd_b_plain(hg: HybridGraph, x: torch.Tensor, gn: torch.Tensor,
                       f_src: torch.Tensor, fdm3: torch.Tensor,
                       bits: Optional[torch.Tensor],
                       keep_mul: Optional[torch.Tensor], slope: float,
                       keep_prob: float):
    """Pass B in plain PyTorch, over the transpose layout: (dx, dfs)."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    send, recv, w, keep = _transpose_edges(hg, bits, keep_mul, heads,
                                           keep_prob)
    _, pn, ds = _edge_terms(recv, send, w, keep, x, gn, f_src, fdm3, slope)
    dx = torch.zeros(n, heads, feat, dtype=torch.float32, device=x.device)
    for sl in edge_chunks(recv.shape[0], hf):
        dx.index_add_(0, send[sl], pn[sl, :, None]
                      * gn[recv[sl]].float().view(-1, heads, feat))
    dfs = torch.zeros(n, heads, dtype=torch.float32,
                      device=x.device).index_add_(0, send, ds)
    return dx.reshape(n, hf).to(x.dtype), dfs


#: both entries of the one library, declared at its first load: pointers,
#: then n, heads, feat, x_bf16, tile_bf16, the column layout (vec, nv,
#: lpe, slab_heads, parts), n_long and long_edges, then the trailing
#: slope, inv_keep, thresh, dropping, stream
_ENTRIES = {"gnn_attend_bwd_a": [ctypes.c_void_p] * 17 + [ctypes.c_int] * 12
            + SCALAR_ARGTYPES[-5:],
            "gnn_attend_bwd_b": [ctypes.c_void_p] * 20 + [ctypes.c_int] * 12
            + SCALAR_ARGTYPES[-5:]}


def _prepare(name, hg, x, gn, f_src, fdm3, bits, keep_mul, keep_prob):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    heads = f_src.shape[1]
    dropping = keep_prob < 1.0
    check_operands(name, hg, x, heads, bits, keep_mul, dropping, gn=gn,
                   f_src=f_src, fdm3=fdm3)
    if fdm3.shape[1] != 3 * heads:
        raise ValueError(f"{name}: fdm3 must be [N, {3 * heads}]")
    return heads, dropping


def bwd_a_args(hg: HybridGraph, x: torch.Tensor, gn: torch.Tensor,
               f_src: torch.Tensor, fdm3: torch.Tensor,
               bits: Optional[torch.Tensor],
               keep_mul: Optional[torch.Tensor], dfd: torch.Tensor,
               slope: float, keep_prob: float, stream: int) -> list:
    """``gnn_attend_bwd_a``'s arguments (``_ENTRIES``): the forward layout,
    its row lengths and long rows, and the column layout of ``x`` and
    ``gn`` (``walk_layout``, a wide head of scalars in parts of up to
    ``WIDE_SCALARS_PER_LANE`` a lane)."""
    heads = f_src.shape[1]
    bg, rem = hg.bcsr, hg.rem
    lay = walk_layout(heads, x, gn, wide_scalars=WIDE_SCALARS_PER_LANE)
    long_rows = hg.long_rows[0]
    scalars = scalar_args(x, bg.tiles, heads, slope, keep_prob,
                          keep_prob < 1.0, stream)
    return [x.data_ptr(), gn.data_ptr(), f_src.data_ptr(), fdm3.data_ptr(),
            bg.tiles.data_ptr(), ptr(bits), bg.col_ids.data_ptr(),
            bg.tile_off.data_ptr(), bg.tile_cnt.data_ptr(),
            bg.row_masks.data_ptr(), rem.senders.data_ptr(),
            rem.row_ptr.data_ptr(), rem.edge_weight.data_ptr(),
            ptr(keep_mul), hg.row_edges[0].data_ptr(), long_rows.data_ptr(),
            dfd.data_ptr(), *scalars[:5], *lay.args(), lay.parts,
            long_rows.numel(), LONG_ROW_EDGES, *scalars[-5:]]


def attend_bwd_a(hg: HybridGraph, x: torch.Tensor, gn: torch.Tensor,
                 f_src: torch.Tensor, fdm3: torch.Tensor,
                 bits: Optional[torch.Tensor],
                 keep_mul: Optional[torch.Tensor], slope: float,
                 keep_prob: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return attend_bwd_a_plain(hg, x, gn, f_src, fdm3, bits, keep_mul,
                                  slope, keep_prob)
    heads, _ = _prepare("attend_bwd_a", hg, x, gn, f_src, fdm3, bits,
                        keep_mul, keep_prob)
    dfd = torch.empty(x.shape[0], heads, dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return dfd
    args = bwd_a_args(hg, x, gn, f_src, fdm3, bits, keep_mul, dfd, slope,
                      keep_prob, cuda_stream(x))
    lib = load("attend_bwd_kernel", _ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_attend_bwd_a(*args)
    check(lib, err, "attend_bwd_a kernel launch")
    attend_bwd_a.launches += 1
    return dfd


def attend_bwd_b(hg: HybridGraph, x: torch.Tensor, gn: torch.Tensor,
                 f_src: torch.Tensor, fdm3: torch.Tensor,
                 bits: Optional[torch.Tensor],
                 keep_mul: Optional[torch.Tensor], slope: float,
                 keep_prob: float):
    if x.device.type == "cpu":
        return attend_bwd_b_plain(hg, x, gn, f_src, fdm3, bits, keep_mul,
                                  slope, keep_prob)
    heads, dropping = _prepare("attend_bwd_b", hg, x, gn, f_src, fdm3, bits,
                               keep_mul, keep_prob)
    n = x.shape[0]
    dx = torch.empty_like(x)
    dfs = torch.empty(n, heads, dtype=torch.float32, device=x.device)
    if n == 0:
        return dx, dfs
    bg_t, rem_t = hg.bcsr_t, hg.rem_t
    lay = walk_layout(heads, x, gn, dx)
    long_rows = hg.long_rows[1]
    scalars = scalar_args(x, bg_t.tiles, heads, slope, keep_prob, dropping,
                          cuda_stream(x))
    lib = load("attend_bwd_kernel", _ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_attend_bwd_b(
            x.data_ptr(), gn.data_ptr(), f_src.data_ptr(), fdm3.data_ptr(),
            bg_t.tiles.data_ptr(), ptr(bits),
            hg.bits_tmap.data_ptr(), bg_t.col_ids.data_ptr(),
            bg_t.tile_off.data_ptr(), bg_t.tile_cnt.data_ptr(),
            bg_t.row_masks.data_ptr(), rem_t.senders.data_ptr(),
            rem_t.row_ptr.data_ptr(), rem_t.edge_weight.data_ptr(),
            hg.rem_t_eperm.data_ptr(), ptr(keep_mul),
            hg.row_edges[1].data_ptr(), long_rows.data_ptr(), dx.data_ptr(),
            dfs.data_ptr(), *scalars[:5], *lay.args(), lay.parts,
            long_rows.numel(), LONG_ROW_EDGES, *scalars[-5:])
    check(lib, err, "attend_bwd_b kernel launch")
    attend_bwd_b.launches += 1
    return dx, dfs


attend_bwd_a.launches = 0
attend_bwd_b.launches = 0
