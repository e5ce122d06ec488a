"""K9 and K10: the dense tiles' softmax partials, given the shift
(``csrc/attend_fused_kernel.cu``, entries ``gnn_tile_parts`` and
``gnn_attend_fused``).

For every receiver r and head h over the nonzero slots s -> r of the
forward tiles of the hybrid graph ``hg``, with the shift ``m`` given:

    p   = w * exp(min(LeakyReLU(f_dst[r,h] + f_src[s,h]) - m[r,h], 0))
    den = sum p;   num = sum p * keep * x[s,h,:]

(``w`` the tile count; ``keep`` is 1, or under attention dropout
``head_keep(bits[t,i,j], h) / keep_prob`` from the tiles' uint32 lattice
``bits``, int32 [T, 128, 128]).

  * ``tile_parts(hg, x, f_src, f_dst, m, bits, slope, keep_prob)`` (K9)
    returns ``(num, den)``, float32 [N, H*F] and [N, H], zero on rows
    without tile slots;
  * ``attend_fused(hg, x, f_src, f_dst, m, num_init, den_init, bits, slope,
    keep_prob)`` (K10) starts the sums from ``num_init`` [N, H*F] and
    ``den_init`` [N, H] (float32: the remainder's partials) and returns
    ``(out, den)``: ``out = num / max(den, 1e-16)`` in float32 and the raw
    ``den``. Every row is written, also rows whose row block has no tile.

They replace the TPU kernels ``_attend_kernel`` (``_parts_pallas``) and
``_attend_fused_kernel`` (``_fused_pallas``) of
``graphneuralnetwork_tpu/ops/bcsr_attention.py``; the design note is in
the CUDA source. Both are modes of one kernel with K8
(``rem_attend_kernel``): K4's row walk (``csrc/attend_walk.cuh``) over
each row's tile slots only, a slab of its columns at a time
(``attend_common.walk_layout``; a head wider than a warp holds in parts
on the grid), the shift given, K10's sums seeded with the remainder's
partials; rows above the threshold of ``HybridGraph.long_rows`` split
over a CTA.
``tile_parts_args`` and ``attend_fused_args`` build the launch arguments.
A CUDA tensor launches the kernel; a CPU tensor takes ``tile_parts_plain``
/ ``attend_fused_plain``. ``tile_parts.launches`` and
``attend_fused.launches`` count launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.bcsr import HybridGraph
from .attend_common import (LONG_ROW_EDGES, SCALAR_ARGTYPES,
                            check_operands, cuda_stream, ptr, scalar_args,
                            softmax_parts, tile_edges, walk_layout)
from .build import check, load

#: K8's and K9's entries: pointers, then n, heads, feat, x_bf16,
#: tile_bf16 (K9), the column layout (vec, nv, lpe, slab_heads, parts),
#: n_long, long_edges, and the trailing slope, inv_keep and thresh (K9),
#: dropping, stream
PARTS_ENTRIES = {
    "gnn_rem_attend": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "gnn_tile_parts": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 12
    + SCALAR_ARGTYPES[-5:],
}
#: K10's entry, the same way
FUSED_ENTRIES = {
    "gnn_attend_fused": [ctypes.c_void_p] * 17 + [ctypes.c_int] * 12
    + SCALAR_ARGTYPES[-5:],
}
#: the three entries of the one library, declared at its first load
WALK_ENTRIES = {**PARTS_ENTRIES, **FUSED_ENTRIES}


def tile_parts_plain(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                     f_dst: torch.Tensor, m: torch.Tensor,
                     bits: Optional[torch.Tensor], slope: float,
                     keep_prob: float,
                     num_init: Optional[torch.Tensor] = None,
                     den_init: Optional[torch.Tensor] = None):
    """The plain PyTorch version: ``softmax_parts`` over the tiles'
    nonzero slots, the tile half of ``attend_online_plain``'s second pass,
    started from ``num_init``/``den_init`` where given."""
    n, hf = x.shape
    heads = f_src.shape[1]
    recv, send, w, keep = tile_edges(hg, bits, heads, keep_prob)
    num = den = None
    if num_init is not None:
        num = num_init.float().reshape(n, heads, hf // heads).clone()
        den = den_init.float().clone()
    num, den = softmax_parts(recv, send, w, keep, x, f_src, f_dst, m, slope,
                             num, den)
    return num.reshape(n, hf), den


def attend_fused_plain(hg: HybridGraph, x: torch.Tensor,
                       f_src: torch.Tensor, f_dst: torch.Tensor,
                       m: torch.Tensor, num_init: torch.Tensor,
                       den_init: torch.Tensor, bits: Optional[torch.Tensor],
                       slope: float, keep_prob: float):
    """The plain PyTorch version: the tile partials started from the
    remainder's, then the division; ``den`` is returned unclamped."""
    heads = f_src.shape[1]
    num, den = tile_parts_plain(hg, x, f_src, f_dst, m, bits, slope,
                                keep_prob, num_init, den_init)
    out = num.view(x.shape[0], heads, -1) / torch.clamp_min(
        den, 1e-16)[:, :, None]
    return out.reshape(num.shape), den


def _prepare(name, hg, x, f_src, bits, keep_prob, **node_arrays):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    heads = f_src.shape[1]
    dropping = keep_prob < 1.0
    check_operands(name, hg, x, heads, bits, None, dropping,
                   masks=("bits",), f_src=f_src, **node_arrays)
    for key in ("num_init", "den_init"):
        arr = node_arrays.get(key)
        width = heads if key == "den_init" else x.shape[1]
        if arr is not None and arr.shape != (x.shape[0], width):
            raise ValueError(f"{name}: {key} must be [{x.shape[0]}, "
                             f"{width}], got {tuple(arr.shape)}")
    return heads, dropping


def tile_parts_args(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                    f_dst: torch.Tensor, m: torch.Tensor,
                    bits: Optional[torch.Tensor], num: torch.Tensor,
                    den: torch.Tensor, slope: float, keep_prob: float,
                    stream: int) -> list:
    """``gnn_tile_parts``'s arguments (``PARTS_ENTRIES``): K10's without
    the seeds (the forward tiles, their row masks, the remainder's spans,
    the forward row lengths and long rows), and the column layout of ``x``
    and ``num`` (``walk_layout``)."""
    heads = f_src.shape[1]
    bg = hg.bcsr
    lay = walk_layout(heads, x, num)
    long_rows = hg.long_rows[0]
    scalars = scalar_args(x, bg.tiles, heads, slope, keep_prob,
                          keep_prob < 1.0, stream)
    return [x.data_ptr(), f_src.data_ptr(), f_dst.data_ptr(), m.data_ptr(),
            bg.tiles.data_ptr(), ptr(bits), bg.col_ids.data_ptr(),
            bg.tile_off.data_ptr(), bg.tile_cnt.data_ptr(),
            bg.row_masks.data_ptr(), hg.rem.row_ptr.data_ptr(),
            hg.row_edges[0].data_ptr(), long_rows.data_ptr(), num.data_ptr(),
            den.data_ptr(), *scalars[:5], *lay.args(), lay.parts,
            long_rows.numel(), LONG_ROW_EDGES, *scalars[-5:]]


def attend_fused_args(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                      f_dst: torch.Tensor, m: torch.Tensor,
                      num_init: torch.Tensor, den_init: torch.Tensor,
                      bits: Optional[torch.Tensor], out: torch.Tensor,
                      den: torch.Tensor, slope: float, keep_prob: float,
                      stream: int) -> list:
    """``gnn_attend_fused``'s arguments (``FUSED_ENTRIES``): the forward
    tiles, their row masks, the remainder's spans (where each row's tile
    slots start in its stream), the forward row lengths and long rows, and
    the column layout of ``x``, ``num_init`` and ``out`` (``walk_layout``,
    K4's)."""
    heads = f_src.shape[1]
    bg = hg.bcsr
    lay = walk_layout(heads, x, num_init, out)
    long_rows = hg.long_rows[0]
    scalars = scalar_args(x, bg.tiles, heads, slope, keep_prob,
                          keep_prob < 1.0, stream)
    return [x.data_ptr(), f_src.data_ptr(), f_dst.data_ptr(), m.data_ptr(),
            bg.tiles.data_ptr(), ptr(bits), bg.col_ids.data_ptr(),
            bg.tile_off.data_ptr(), bg.tile_cnt.data_ptr(),
            bg.row_masks.data_ptr(), hg.rem.row_ptr.data_ptr(),
            num_init.data_ptr(), den_init.data_ptr(),
            hg.row_edges[0].data_ptr(), long_rows.data_ptr(), out.data_ptr(),
            den.data_ptr(), *scalars[:5], *lay.args(), lay.parts,
            long_rows.numel(), LONG_ROW_EDGES, *scalars[-5:]]


def tile_parts(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
               f_dst: torch.Tensor, m: torch.Tensor,
               bits: Optional[torch.Tensor], slope: float, keep_prob: float):
    if x.device.type == "cpu":
        return tile_parts_plain(hg, x, f_src, f_dst, m, bits, slope,
                                keep_prob)
    heads, _ = _prepare("tile_parts", hg, x, f_src, bits, keep_prob,
                        f_dst=f_dst, m=m)
    n, hf = x.shape
    num = torch.empty(n, hf, dtype=torch.float32, device=x.device)
    den = torch.empty(n, heads, dtype=torch.float32, device=x.device)
    if n == 0:
        return num, den
    args = tile_parts_args(hg, x, f_src, f_dst, m, bits, num, den, slope,
                           keep_prob, cuda_stream(x))
    lib = load("attend_fused_kernel", WALK_ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_tile_parts(*args)
    check(lib, err, "tile_parts kernel launch")
    tile_parts.launches += 1
    return num, den


def attend_fused(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                 f_dst: torch.Tensor, m: torch.Tensor,
                 num_init: torch.Tensor, den_init: torch.Tensor,
                 bits: Optional[torch.Tensor], slope: float,
                 keep_prob: float):
    if x.device.type == "cpu":
        return attend_fused_plain(hg, x, f_src, f_dst, m, num_init,
                                  den_init, bits, slope, keep_prob)
    heads, _ = _prepare("attend_fused", hg, x, f_src, bits, keep_prob,
                        f_dst=f_dst, m=m, num_init=num_init,
                        den_init=den_init)
    n, hf = x.shape
    out = torch.empty(n, hf, dtype=torch.float32, device=x.device)
    den = torch.empty(n, heads, dtype=torch.float32, device=x.device)
    if n == 0:
        return out, den
    args = attend_fused_args(hg, x, f_src, f_dst, m, num_init, den_init,
                             bits, out, den, slope, keep_prob,
                             cuda_stream(x))
    lib = load("attend_fused_kernel", WALK_ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_attend_fused(*args)
    check(lib, err, "attend_fused kernel launch")
    attend_fused.launches += 1
    return out, den


tile_parts.launches = 0
attend_fused.launches = 0
