"""K1: receiver-sorted segment sum (``csrc/spmm_kernel.cu``).

``segment_sum(values, receivers, row_ptr, n_out)`` computes
``out[r] = Σ_{e: receivers[e] = r} values[e]`` for ``values`` of shape
[E_pad, F] in float32 or bfloat16, accumulated in float32 and returned in
the input type. It replaces the TPU kernels ``_spmm_kernel_hilo`` /
``_spmm_kernel_bf16`` of ``graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py``
(``_spmm_pallas_call``); the design note is in the CUDA source.

Only the edges that ``row_ptr`` spans count: edges ``e >= row_ptr[-1]``
(a graph's padding) are ignored whatever their values. A CUDA tensor
launches the kernel, which sums each row's span; a CPU tensor takes
``segment_sum_plain`` on the spanned edges.
``segment_sum.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, load

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def segment_sum_plain(values: torch.Tensor, receivers: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """The plain PyTorch version: float32 ``index_add_``, cast back."""
    out = torch.zeros(n_out, values.shape[1], dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, receivers, values.float())
    return out.to(values.dtype)


_ENTRIES = {"gnn_segment_sum": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]}


def _vector_width(values: torch.Tensor, out: torch.Tensor) -> int:
    """Columns per thread: the widest 16-byte-or-less vector that divides F
    and keeps both base pointers aligned."""
    elt = values.element_size()
    vec = 16 // elt
    while vec > 1 and (values.shape[1] % vec
                       or values.data_ptr() % (vec * elt)
                       or out.data_ptr() % (vec * elt)):
        vec //= 2
    return vec


def segment_sum(values: torch.Tensor, receivers: torch.Tensor,
                row_ptr: torch.Tensor, n_out: int) -> torch.Tensor:
    if values.device.type == "cpu":
        n_edges = int(row_ptr[-1])
        return segment_sum_plain(values[:n_edges], receivers[:n_edges], n_out)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    if values.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_sum: values dtype {values.dtype} is not "
                        "float32 or bfloat16")
    if values.ndim != 2 or not values.is_contiguous():
        raise ValueError("segment_sum: values must be a contiguous [E, F] "
                         f"tensor, got shape {tuple(values.shape)}")
    if (row_ptr.dtype != torch.int32 or row_ptr.device != values.device
            or not row_ptr.is_contiguous()
            or row_ptr.shape != (n_out + 1,)):
        raise ValueError("segment_sum: row_ptr must be a contiguous int32 "
                         f"[{n_out + 1}] tensor on {values.device}")
    if values.numel() >= 2 ** 31:
        raise ValueError("segment_sum: values too large for int32 offsets")
    out = torch.empty(n_out, values.shape[1], dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    lib = load("spmm_kernel", _ENTRIES)
    with torch.cuda.device(values.device):
        err = lib.gnn_segment_sum(
            values.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
            n_out, values.shape[1], _DTYPE_CODES[values.dtype],
            _vector_width(values, out),
            torch.cuda.current_stream(values.device).cuda_stream)
    check(lib, err, "segment_sum kernel launch")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
