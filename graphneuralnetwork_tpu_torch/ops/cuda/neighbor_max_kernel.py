"""K7: neighbour max over the dense tiles of the BCSR layout
(``csrc/neighbor_max_kernel.cu``).

``neighbor_max(bg, v)`` computes ``out[r, c] = max(NEG, max_{s: W[r, s] ≠ 0}
v[s, c])`` over the nonzero slots ``W`` of a ``BCSRGraph``'s tiles, for
float32 ``v`` [N, C]; a row without a tiled in-edge gets ``NEG = -1e30``.
Forward only: the caller (``ops/bcsr_attention.py:hybrid_segment_max``)
carries the gradient. It replaces the TPU kernel ``_nmax_kernel`` of
``graphneuralnetwork_tpu/ops/bcsr_attention.py`` (``_nmax_pallas``); the
design note is in the CUDA source.

A CUDA tensor launches the kernel; a CPU tensor takes
``neighbor_max_plain``. ``neighbor_max.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.bcsr import ROW_BLOCK, BCSRGraph
from .attend_common import NEG
from .build import check, load
from .tile_walk import launch_shape


def neighbor_max_plain(bg: BCSRGraph, v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``scatter_reduce_("amax")`` of the
    gathered ``v`` rows over the tiles' edge list (``bg.slot_edges``) into
    a ``NEG``-filled output."""
    rows, cols = bg.slot_edges
    c = v.shape[1]
    out = torch.full((v.shape[0], c), NEG, dtype=torch.float32,
                     device=v.device)
    return out.scatter_reduce_(0, rows[:, None].expand(-1, c),
                               v.float()[cols], "amax", include_self=True)


_ENTRIES = {"gnn_neighbor_max": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]}


def neighbor_max(bg: BCSRGraph, v: torch.Tensor) -> torch.Tensor:
    if v.device.type == "cpu":
        return neighbor_max_plain(bg, v)
    if v.device.type != "cuda":
        raise ValueError(f"neighbor_max: unsupported device {v.device}")
    if (v.dtype != torch.float32 or v.ndim != 2
            or v.shape[0] != bg.n_nodes or not v.is_contiguous()):
        raise ValueError("neighbor_max: v must be a contiguous float32 "
                         f"[{bg.n_nodes}, C] tensor, got {v.dtype} "
                         f"{tuple(v.shape)}")
    if bg.tiles.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"neighbor_max: tile dtype {bg.tiles.dtype}")
    if bg.device != v.device:
        raise ValueError(f"neighbor_max: graph on {bg.device}, v on "
                         f"{v.device}")
    if v.numel() >= 2 ** 31:
        raise ValueError("neighbor_max: v too large for int32 offsets")
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    lib = load("neighbor_max_kernel", _ENTRIES)
    n_rb = bg.n_node_pad // ROW_BLOCK
    # the walk stages the masks alone: no tile values
    rows, slab, chunk = launch_shape(n_rb, v, 0, mma=False)
    with torch.cuda.device(v.device):
        err = lib.gnn_neighbor_max(
            bg.tiles.data_ptr(), v.data_ptr(), bg.col_ids.data_ptr(),
            bg.tile_off.data_ptr(), bg.tile_cnt.data_ptr(),
            bg.row_masks.data_ptr(), bg.col_masks.data_ptr(), out.data_ptr(),
            n_rb, v.shape[0], v.shape[1],
            int(bg.tiles.dtype == torch.bfloat16), rows, slab, chunk, NEG,
            torch.cuda.current_stream(v.device).cuda_stream)
    check(lib, err, "neighbor_max kernel launch")
    neighbor_max.launches += 1
    return out


neighbor_max.launches = 0
