"""Device-memory read bandwidth on the card: the port of the JAX package's
``tools/bench_dma.py``. Run from the repository root:

    python -m graphneuralnetwork_tpu_torch.tools.bench_dma
        [--rows 2097152] [--width 128] [--seed 0] [--device cuda|cpu]

It draws ``x`` [rows, width] float32 (1 GiB at the defaults, the JAX
tool's shape) from a seeded normal on the device and sums its columns with

  plain      ``row_sum_plain``: ``x.sum(0)`` broadcast to [8, width]
  stream     ``row_sum_stream``, the counterpart of ``reduce_auto``
  ring_x2    ``row_sum_ring`` with 2, 4 and 8 shared-memory slots, the
  ring_x4    counterparts of ``reduce_manual`` with 2, 4 and 8 buffers
  ring_x8

each held once against the float64 sum of the same tensor within the
float32 summation bound (``ops/cuda/row_sum_kernel.py:sum_tolerance``; the
plain version's order is PyTorch's, so its chain is taken as ``rows``),
then timed with CUDA events (warmed, median of batches:
``tools/timing.py``). It prints ms, GB/s and the share of
``PEAK_BYTES_PER_S`` for each, one JSON line, and returns that dict. With
``--device cpu`` (tests) the wrappers take the plain version and only the
check runs. Shapes the kernels do not take raise.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..core.device import resolve_device
from ..ops.cuda import row_sum_kernel as rs
from ..ops.cuda.tile_walk import sm_count
from .timing import time_ms

#: H100 SXM device-memory bandwidth (NVIDIA data sheet), the yardstick of
#: every bound in the port's measurements.
PEAK_BYTES_PER_S = 3.35e12
ROWS, WIDTH = 2_097_152, 128


def variants() -> dict:
    """name -> (function of x, kernel kind for ``chain_length`` or None,
    slots)."""
    out = {"plain": (rs.row_sum_plain, None, 0),
           "stream": (rs.row_sum_stream, "stream", 0)}
    for n in rs.SLOTS:
        out[f"ring_x{n}"] = (lambda x, n=n: rs.row_sum_ring(x, n), "ring", n)
    return out


def bytes_moved(rows: int, width: int) -> int:
    """Each input byte read once, each output byte written once."""
    return (rows + rs.OUT_ROWS) * width * 4


def check(name: str, out: torch.Tensor, ref: torch.Tensor,
          tol: torch.Tensor) -> float:
    """Raise unless ``out`` is [8, F], its rows all equal, and within
    ``tol`` of the float64 column sums ``ref``; return the largest error."""
    if out.shape != (rs.OUT_ROWS, ref.shape[0]) or out.dtype != torch.float32:
        raise AssertionError(f"{name}: output {tuple(out.shape)} "
                             f"{out.dtype}, expected [8, {ref.shape[0]}]")
    if not bool((out == out[:1]).all()):
        raise AssertionError(f"{name}: the 8 output rows differ")
    err = (out[0].double() - ref).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: off the float64 sum by {float(err.max())}"
                             f" where the float32 bound allows "
                             f"{float(tol.min())} ... {float(tol.max())}")
    return float(err.max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    rows, width = args.rows, args.width
    rs.check_shape(rows, width)
    sms = sm_count(device.index or 0) if on_card else 0
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn(rows, width, generator=gen, device=device)
    ref = x.sum(0, dtype=torch.float64)
    abs_sum = x.abs().sum(0, dtype=torch.float64)
    moved = bytes_moved(rows, width)
    results = {}
    for name, (fn, kind, slots) in variants().items():
        # the CPU (and the plain version) sums in PyTorch's order
        chain = (rs.chain_length(kind, rows, width, sms, slots or 2)
                 if on_card and kind is not None else rows)
        err = check(name, fn(x), ref, rs.sum_tolerance(chain, abs_sum))
        entry = {"max_abs_err": err, "chain": chain}
        if on_card:
            ms = time_ms(lambda: fn(x))
            entry.update(ms=ms, gb_per_s=moved / ms / 1e6,
                         peak_share=moved / (ms * 1e-3) / PEAK_BYTES_PER_S)
            print(f"{name:10s} {ms:9.4f} ms {entry['gb_per_s']:8.1f} GB/s "
                  f"{entry['peak_share']:6.3f} of peak", flush=True)
        results[name] = entry
    res = {"rows": rows, "width": width, "device": str(device),
           "bytes": moved,
           "bound_ms": moved / PEAK_BYTES_PER_S * 1e3,
           "peak_bytes_per_s": PEAK_BYTES_PER_S, "variants": results}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
