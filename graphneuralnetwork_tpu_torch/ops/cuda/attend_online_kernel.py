"""K4: hybrid GAT softmax attention, forward
(``csrc/attend_online_kernel.cu``).

``attend_online(hg, x, f_src, f_dst, bits, keep_mul, slope, keep_prob)``
computes, for every receiver r and head h over the in-edges s -> r of the
hybrid graph ``hg`` (nonzero slots of the forward tiles, then the
remainder's real edges):

    score = LeakyReLU(f_dst[r,h] + f_src[s,h]);   m = max over live edges
    p     = w * exp(min(score - m, 0));            den = sum p
    out   = (sum p * keep * x[s,h,:]) / max(den, 1e-16)

with ``x`` [N, H*F] (float32 or bfloat16; ``out`` in its type), ``f_src``
and ``f_dst`` float32 [N, H], tile weights ``w`` the tile counts and
remainder weights ``edge_weight``. With ``keep_prob < 1`` dropout masks the
numerator: ``bits`` (int32 [T, 128, 128], the uint32 lattice) for tile
slots through ``head_keep``, ``keep_mul`` (float32 [E_pad, H]) for the
remainder. Returns ``(out, den, m)``; ``den`` and ``m`` are float32
[N, H], and rows without edges get ``den = 0`` and ``m = NEG``.

It replaces the TPU kernels ``_attend_unrolled_kernel`` /
``_attend_2d_kernel`` of
``graphneuralnetwork_tpu/ops/pallas/attend_online_kernel.py``
(``attend_online_pallas``); the design note is in the CUDA source. The
kernel walks each receiver row's edges in batches of 32 with an online
softmax (``csrc/attend_walk.cuh``); its column layout comes from
``attend_common.attend_layout``, each row's length from
``HybridGraph.row_edges`` and the rows it splits over a CTA from
``HybridGraph.long_rows``. A CUDA tensor launches the kernel; a CPU tensor
takes ``attend_online_plain``. ``attend_online.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.bcsr import HybridGraph
from .attend_common import (LONG_ROW_EDGES, NEG, SCALAR_ARGTYPES,
                            check_operands, cuda_stream, leaky, ptr,
                            rem_edges, scalar_args, softmax_parts,
                            tile_edges, walk_layout)
from .build import check, load


def forward_edges(hg: HybridGraph, bits: Optional[torch.Tensor],
                  keep_mul: Optional[torch.Tensor], heads: int,
                  keep_prob: float):
    """The forward layout as one edge list: (receivers, senders, weights,
    live mask, numerator multiplier [E, H] or None), tile slots first."""
    dropping = keep_prob < 1.0
    t_recv, t_send, t_w, t_keep = tile_edges(hg, bits, heads, keep_prob)
    r_recv, r_send, r_w, r_keep = rem_edges(hg,
                                            keep_mul if dropping else None)
    recv = torch.cat([t_recv, r_recv])
    send = torch.cat([t_send, r_send])
    w = torch.cat([t_w, r_w])
    live = torch.cat([t_w != 0, r_w > 0])
    keep = torch.cat([t_keep, r_keep]) if dropping else None
    return recv, send, w, live, keep


def attend_online_plain(hg: HybridGraph, x: torch.Tensor,
                        f_src: torch.Tensor, f_dst: torch.Tensor,
                        bits: Optional[torch.Tensor],
                        keep_mul: Optional[torch.Tensor], slope: float,
                        keep_prob: float):
    """The plain PyTorch version: the exact shift first (LeakyReLU is
    monotone, so m = LeakyReLU(f_dst + neighbour max of f_src)), then the
    numerator and denominator of all tile slots and remainder edges in one
    pass (``softmax_parts``), in float32, the per-edge rows in chunks."""
    n, hf = x.shape
    heads = f_src.shape[1]
    recv, send, w, live, keep = forward_edges(hg, bits, keep_mul, heads,
                                              keep_prob)
    idx = recv[:, None].expand(-1, heads)
    maxfs = torch.full((n, heads), NEG, dtype=torch.float32,
                       device=x.device).scatter_reduce_(
        0, idx, torch.where(live[:, None], f_src[send], NEG), "amax",
        include_self=True)
    m = torch.where(maxfs > NEG / 2, leaky(f_dst + maxfs, slope), NEG)
    num, den = softmax_parts(recv, send, w, keep, x, f_src, f_dst, m, slope)
    out = num / torch.clamp_min(den, 1e-16)[:, :, None]
    return out.reshape(n, hf).to(x.dtype), den, m


#: pointers, then n, heads, feat, x_bf16, tile_bf16, the column layout
#: (vec, nv, lpe, slab_heads, parts), n_long, long_edges, and the trailing
#: slope, inv_keep, thresh, dropping, stream
_ENTRIES = {"gnn_attend_online": [ctypes.c_void_p] * 18
            + [ctypes.c_int] * 12 + SCALAR_ARGTYPES[-5:]}


def attend_online(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                  f_dst: torch.Tensor, bits: Optional[torch.Tensor],
                  keep_mul: Optional[torch.Tensor], slope: float,
                  keep_prob: float):
    if x.device.type == "cpu":
        return attend_online_plain(hg, x, f_src, f_dst, bits, keep_mul,
                                   slope, keep_prob)
    if x.device.type != "cuda":
        raise ValueError(f"attend_online: unsupported device {x.device}")
    heads = f_src.shape[1]
    dropping = keep_prob < 1.0
    check_operands("attend_online", hg, x, heads, bits, keep_mul, dropping,
                   f_src=f_src, f_dst=f_dst)
    n = x.shape[0]
    out = torch.empty_like(x)
    den = torch.empty(n, heads, dtype=torch.float32, device=x.device)
    m = torch.empty(n, heads, dtype=torch.float32, device=x.device)
    if n == 0:
        return out, den, m
    bg, rem = hg.bcsr, hg.rem
    lay = walk_layout(heads, x, out)
    long_rows = hg.long_rows[0]
    scalars = scalar_args(x, bg.tiles, heads, slope, keep_prob, dropping,
                          cuda_stream(x))
    lib = load("attend_online_kernel", _ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_attend_online(
            x.data_ptr(), f_src.data_ptr(), f_dst.data_ptr(),
            bg.tiles.data_ptr(), ptr(bits),
            bg.col_ids.data_ptr(), bg.tile_off.data_ptr(),
            bg.tile_cnt.data_ptr(), bg.row_masks.data_ptr(),
            rem.senders.data_ptr(), rem.row_ptr.data_ptr(),
            rem.edge_weight.data_ptr(), ptr(keep_mul),
            hg.row_edges[0].data_ptr(), long_rows.data_ptr(), out.data_ptr(),
            den.data_ptr(), m.data_ptr(), *scalars[:5], *lay.args(),
            lay.parts, long_rows.numel(), LONG_ROW_EDGES, *scalars[-5:])
    check(lib, err, "attend_online kernel launch")
    attend_online.launches += 1
    return out, den, m


attend_online.launches = 0
