"""K3: dense-tile SpMM over the BCSR layout (``csrc/bcsr_spmm_kernel.cu``).

``bcsr_spmm(bg, x)`` computes ``out[rb] = Σ_{t ∈ span(rb)} tiles[t] @
x[col_ids[t]·128 : +128]`` for the 128-row blocks ``rb`` of a
``BCSRGraph``, with ``x`` [N, F] in float32 or bfloat16: the tiles are
rounded to ``x``'s type, every product and sum is float32, and the result
[N, F] comes back in ``x``'s type. Rows of ``x`` past N count as zero. It
replaces the TPU kernels ``_bcsr_kernel`` / ``_bcsr_unrolled_kernel`` of
``graphneuralnetwork_tpu/ops/bcsr_spmm.py`` (``_bcsr_pallas``); the design
note is in the CUDA source.

A CUDA tensor launches the kernel; a CPU tensor takes ``bcsr_spmm_plain``.
``bcsr_spmm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.bcsr import COL_BLOCK, ROW_BLOCK, BCSRGraph
from .build import check, load
from .tile_walk import launch_shape

_DTYPES = (torch.float32, torch.bfloat16)


def bcsr_spmm_plain(bg: BCSRGraph, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, the JAX package's XLA formulation
    (``_bcsr_xla``): a block gather of ``x``, a batched float32 tile
    product, an ``index_add_`` over the tiles' row blocks. On the card it
    is full float32 as long as ``torch.backends.cuda.matmul.allow_tf32``
    stays False."""
    n, f = x.shape
    n_rb = bg.n_node_pad // ROW_BLOCK
    xp = torch.zeros(bg.n_node_pad, f, dtype=torch.float32, device=x.device)
    xp[:n] = x.float()
    gathered = xp.view(-1, COL_BLOCK, f)[bg.col_ids.long()]
    prod = torch.bmm(bg.tiles.to(x.dtype).float(), gathered)
    out = torch.zeros(n_rb, ROW_BLOCK, f, dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, bg.row_ids.long(), prod)
    return out.view(-1, f)[:n].to(x.dtype)


_ENTRIES = {"gnn_bcsr_spmm": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_void_p]}


def bcsr_spmm(bg: BCSRGraph, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return bcsr_spmm_plain(bg, x)
    if x.device.type != "cuda":
        raise ValueError(f"bcsr_spmm: unsupported device {x.device}")
    if x.dtype not in _DTYPES or bg.tiles.dtype not in _DTYPES:
        raise TypeError(f"bcsr_spmm: x {x.dtype} and tiles "
                        f"{bg.tiles.dtype} must be float32 or bfloat16")
    if x.ndim != 2 or x.shape[0] != bg.n_nodes or not x.is_contiguous():
        raise ValueError(f"bcsr_spmm: x must be a contiguous [{bg.n_nodes}, "
                         f"F] tensor, got {tuple(x.shape)}")
    if bg.device != x.device:
        raise ValueError(f"bcsr_spmm: graph on {bg.device}, x on {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError("bcsr_spmm: x too large for int32 offsets")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = load("bcsr_spmm_kernel", _ENTRIES)
    x_bf16 = x.dtype == torch.bfloat16
    n_rb = bg.n_node_pad // ROW_BLOCK
    rows, slab, chunk = launch_shape(n_rb, x, bg.tiles.element_size(),
                                     mma=x_bf16)
    # the tensor-core product reads no masks: they are built only for the
    # walk
    row_masks, col_masks = ((None, None) if x_bf16 else
                            (bg.row_masks.data_ptr(), bg.col_masks.data_ptr()))
    with torch.cuda.device(x.device):
        err = lib.gnn_bcsr_spmm(
            bg.tiles.data_ptr(), x.data_ptr(), bg.col_ids.data_ptr(),
            bg.tile_off.data_ptr(), bg.tile_cnt.data_ptr(), row_masks,
            col_masks, out.data_ptr(),
            n_rb, x.shape[0], x.shape[1], int(x_bf16),
            int(bg.tiles.dtype == torch.bfloat16), rows, slab, chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "bcsr_spmm kernel launch")
    bcsr_spmm.launches += 1
    return out


bcsr_spmm.launches = 0
