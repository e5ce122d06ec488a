"""Column sums of a float32 [M, F] array (``csrc/row_sum_kernel.cu``), the
port's device-memory read-bandwidth probe.

``row_sum_stream(x)`` and ``row_sum_ring(x, n_slots)`` return the [8, F]
float32 array whose every row is ``Σ_r x[r, :]``, as the TPU kernels
``reduce_auto`` and ``reduce_manual(x, n_buffers)`` of ``tools/bench_dma.py``
write it; ``row_sum_plain`` is the plain PyTorch version (``x.sum(0)``
broadcast). A CUDA tensor launches the kernel (then a second, ordered pass
over the per-CTA partial sums), a CPU tensor takes ``row_sum_plain``. The
launch arithmetic is chosen here and passed to the kernels, which check it:

  * ``block_shape(f)``: F/4 lanes (one 16-byte vector each) times R rows a
    step, R = 256 // (F/4); F a multiple of 4 up to 1,024;
  * ``stream_grid(m, f, sms)``: ``STREAM_CTAS_PER_SM`` CTAs an SM over
    contiguous row ranges, each a multiple of R x ``UNROLL`` rows;
  * ``ring_layout(m, f, n_slots, sms)``: slots of ``SLOT_BYTES`` (whole
    rows), one or two persistent CTAs an SM as the ring's shared memory
    allows, each taking a contiguous run of chunks.

``chain_length`` counts the additions any one value passes through on its
way to the result, from which ``sum_tolerance`` states the float32
summation bound that the tests and ``chip_smoke.py`` hold the kernels to.
``row_sum_stream.launches`` and ``row_sum_ring.launches`` count calls that
launched their kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import check, load
from .tile_walk import sm_count

OUT_ROWS = 8          # the TPU kernels' [8, F] output
THREADS = 256         # a CTA of either kernel (``kThreads``)
UNROLL = 4            # the stream kernel's loads in flight (``kUnroll``)
STREAM_CTAS_PER_SM = 8
SLOT_BYTES = 16384    # a ring slot's bytes at most, whole rows
SLOTS = (2, 4, 8)
BAR_BYTES = 128       # the ring's mbarriers (``tile_walk.cuh``'s kBarBytes)
STATIC_SMEM = THREADS * 16   # the CTA fold's float4 per thread
MAX_SMEM = 232448     # a CTA's shared memory at most (``kMaxSmem``)
SM_SMEM = 233472      # an SM's shared memory
CTA_RESERVED = 1024   # shared memory the card reserves per resident CTA
MAX_WIDTH = 4 * THREADS
#: float32's unit roundoff
UNIT_ROUNDOFF = 2.0 ** -24

_ENTRIES = {
    "gnn_row_sum_stream": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "gnn_row_sum_ring": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def row_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x.sum(0)`` in every one of 8 rows."""
    return x.sum(0, keepdim=True).expand(OUT_ROWS, -1).contiguous()


def block_shape(f: int) -> tuple[int, int]:
    """(lanes, rows a step) of a CTA; raises for a width the kernels do not
    take."""
    if f < 4 or f % 4 or f > MAX_WIDTH:
        raise ValueError(f"row_sum: width {f} is not a multiple of 4 in "
                         f"4 ... {MAX_WIDTH}")
    lanes = f // 4
    return lanes, THREADS // lanes


def check_shape(m: int, f: int) -> None:
    """Raise for an [m, f] shape the kernels do not take: a width that is
    not a multiple of 4 in 4 ... 1,024, no rows, or 2**31 values or more."""
    block_shape(f)
    if m < 1 or m * f >= 2 ** 31:
        raise ValueError(f"row_sum: {m} rows of {f} are outside 1 ... "
                         "2**31 values")


def stream_grid(m: int, f: int, sms: int) -> tuple[int, int]:
    """(CTAs, rows a CTA) of ``row_sum_stream``: about
    ``STREAM_CTAS_PER_SM`` CTAs an SM, each over a contiguous range of a
    multiple of R x ``UNROLL`` rows, none empty."""
    check_shape(m, f)
    _, rows_step = block_shape(f)
    unit = rows_step * UNROLL
    per_cta = math.ceil(m / (STREAM_CTAS_PER_SM * sms))
    per_cta = math.ceil(per_cta / unit) * unit
    return math.ceil(m / per_cta), per_cta


def ring_layout(m: int, f: int, n_slots: int, sms: int) -> dict:
    """The launch of ``row_sum_ring``: rows a slot (as many whole rows as
    ``SLOT_BYTES`` holds), its dynamic shared memory, CTAs an SM (two where
    two rings fit on an SM, else one), CTAs and chunks a CTA (contiguous,
    none empty; the last chunk of ``x`` may be short)."""
    if n_slots not in SLOTS:
        raise ValueError(f"row_sum_ring: n_slots {n_slots} not in {SLOTS}")
    check_shape(m, f)
    slot_rows = SLOT_BYTES // (4 * f)
    smem = BAR_BYTES + n_slots * slot_rows * f * 4
    if smem + STATIC_SMEM > MAX_SMEM:
        raise ValueError(f"row_sum_ring: {smem} bytes of slots do not fit")
    per_sm = 2 if 2 * (smem + STATIC_SMEM + CTA_RESERVED) <= SM_SMEM else 1
    n_chunks = math.ceil(m / slot_rows)
    per_cta = math.ceil(n_chunks / min(n_chunks, per_sm * sms))
    return {"slot_rows": slot_rows, "smem_bytes": smem, "ctas_per_sm": per_sm,
            "n_ctas": math.ceil(n_chunks / per_cta),
            "chunks_per_cta": per_cta}


def chain_length(kind: str, m: int, f: int, sms: int,
                 n_slots: int = 2) -> int:
    """The most additions any one value of ``x`` passes through in the
    kernel ``kind`` ("stream" or "ring"): its thread's running sum, the
    fold of its accumulators and of the CTA's rows, and the ordered pass
    over the CTAs' partial rows."""
    _, rows_step = block_shape(f)
    if kind == "stream":
        n_ctas, per_cta = stream_grid(m, f, sms)
        own = math.ceil(per_cta / rows_step) + UNROLL - 1
    elif kind == "ring":
        lay = ring_layout(m, f, n_slots, sms)
        n_ctas = lay["n_ctas"]
        own = lay["chunks_per_cta"] * math.ceil(lay["slot_rows"] / rows_step) + 1
    else:
        raise ValueError(f"unknown row_sum kernel {kind!r}")
    return own + rows_step - 1 + n_ctas - 1


def sum_tolerance(chain: int, abs_sum: torch.Tensor) -> torch.Tensor:
    """The float32 summation bound: a sum whose every term passes through
    at most ``chain`` additions lies within γ(chain)·Σ|x| of the exact sum,
    γ(k) = k·u / (1 − k·u), u = 2^-24 (Higham, Accuracy and Stability of
    Numerical Algorithms, §4.2). ``abs_sum`` is Σ|x| per column."""
    ku = chain * UNIT_ROUNDOFF
    return abs_sum * (ku / (1.0 - ku))


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x dtype {x.dtype} is not float32")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be a contiguous, 16-byte aligned "
                         f"[M, F] tensor, got shape {tuple(x.shape)}")


def _outputs(x: torch.Tensor, n_ctas: int):
    partials = torch.empty(n_ctas, x.shape[1], dtype=torch.float32,
                           device=x.device)
    out = torch.empty(OUT_ROWS, x.shape[1], dtype=torch.float32,
                      device=x.device)
    return partials, out


def row_sum_stream(x: torch.Tensor) -> torch.Tensor:
    """[8, F]: the column sums of ``x`` [M, F] float32 in every row."""
    if x.device.type == "cpu":
        return row_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_sum_stream: unsupported device {x.device}")
    _check_input(x, "row_sum_stream")
    m, f = x.shape
    n_ctas, per_cta = stream_grid(m, f, sm_count(x.device.index or 0))
    partials, out = _outputs(x, n_ctas)
    lib = load("row_sum_kernel", _ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_row_sum_stream(
            x.data_ptr(), partials.data_ptr(), out.data_ptr(), m, f,
            per_cta, n_ctas, torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "row_sum_stream kernel launch")
    row_sum_stream.launches += 1
    return out


def row_sum_ring(x: torch.Tensor, n_slots: int = 2) -> torch.Tensor:
    """[8, F]: the column sums of ``x`` [M, F] float32 in every row, staged
    through a ring of ``n_slots`` (2, 4 or 8) shared-memory slots."""
    if n_slots not in SLOTS:
        raise ValueError(f"row_sum_ring: n_slots {n_slots} not in {SLOTS}")
    if x.device.type == "cpu":
        return row_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_sum_ring: unsupported device {x.device}")
    _check_input(x, "row_sum_ring")
    m, f = x.shape
    lay = ring_layout(m, f, n_slots, sm_count(x.device.index or 0))
    partials, out = _outputs(x, lay["n_ctas"])
    lib = load("row_sum_kernel", _ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_row_sum_ring(
            x.data_ptr(), partials.data_ptr(), out.data_ptr(), m, f, n_slots,
            lay["slot_rows"], lay["chunks_per_cta"], lay["n_ctas"],
            lay["smem_bytes"],
            torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "row_sum_ring kernel launch")
    row_sum_ring.launches += 1
    return out


row_sum_stream.launches = 0
row_sum_ring.launches = 0
