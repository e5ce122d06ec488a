"""K2: receiver-sorted segment max of edge scores
(``csrc/segment_max_kernel.cu``).

``segment_max(scores, receivers, row_ptr, n_out)`` computes
``out[r, h] = max(EMPTY, max_{e: receivers[e] = r} scores[e, h])`` for
float32 ``scores`` of shape [E_pad, H]; a row without edges gets the
``EMPTY = -3e38`` sentinel, which callers map to 0. It replaces the TPU
kernel ``_segmax_kernel`` of
``graphneuralnetwork_tpu/ops/pallas/segment_max_kernel.py``
(``segment_max_pallas``). Forward only: callers detach the scores.

Only the edges that ``row_ptr`` spans count: edges ``e >= row_ptr[-1]``
(a graph's padding) are ignored. A CUDA tensor launches the kernel, which
reads each row's span; a CPU tensor takes ``segment_max_plain`` on the
spanned edges.
``segment_max.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check, load

EMPTY = -3.0e38  # sentinel below any score the callers produce


def segment_max_plain(scores: torch.Tensor, receivers: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """The plain PyTorch version: ``scatter_reduce_("amax")`` into a
    sentinel-filled output. The sentinel takes part in the max
    (``include_self=True``), as it does in the kernel, so a row whose
    scores are all below it (masked edges) also reads ``EMPTY``."""
    h = scores.shape[1]
    out = torch.full((n_out, h), EMPTY, dtype=torch.float32,
                     device=scores.device)
    idx = receivers.long()[:, None].expand(-1, h)
    return out.scatter_reduce_(0, idx, scores.float(), "amax",
                               include_self=True)


_ENTRIES = {"gnn_segment_max": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]}


def segment_max(scores: torch.Tensor, receivers: torch.Tensor,
                row_ptr: torch.Tensor, n_out: int) -> torch.Tensor:
    if scores.device.type == "cpu":
        n_edges = int(row_ptr[-1])
        return segment_max_plain(scores[:n_edges], receivers[:n_edges], n_out)
    if scores.device.type != "cuda":
        raise ValueError(f"segment_max: unsupported device {scores.device}")
    if (scores.dtype != torch.float32 or scores.ndim != 2
            or not scores.is_contiguous()):
        raise ValueError("segment_max: scores must be a contiguous float32 "
                         f"[E, H] tensor, got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    if (row_ptr.dtype != torch.int32 or row_ptr.device != scores.device
            or not row_ptr.is_contiguous()
            or row_ptr.shape != (n_out + 1,)):
        raise ValueError("segment_max: row_ptr must be a contiguous int32 "
                         f"[{n_out + 1}] tensor on {scores.device}")
    if scores.numel() >= 2 ** 31:
        raise ValueError("segment_max: scores too large for int32 offsets")
    out = torch.empty(n_out, scores.shape[1], dtype=torch.float32,
                      device=scores.device)
    if out.numel() == 0:
        return out
    lib = load("segment_max_kernel", _ENTRIES)
    with torch.cuda.device(scores.device):
        err = lib.gnn_segment_max(
            scores.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
            n_out, scores.shape[1], EMPTY,
            torch.cuda.current_stream(scores.device).cuda_stream)
    check(lib, err, "segment_max kernel launch")
    segment_max.launches += 1
    return out


segment_max.launches = 0
