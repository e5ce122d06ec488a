"""The yardstick: the card's peaks, the least time of a piece of work, and
the work of each kind of operation counted from its shapes. Each model's
epoch is composed of these in ``reference/<model>.py`` (``epoch_ops``).

Every count is of what the mathematics needs, whatever kernel does it:
each input read once and each output written once, float32 values and
int32 ids at 4 bytes, and the operations the formula takes. Elementwise
steps that a kernel could fold into its neighbour (ReLU, ELU, dropout,
bias, the loss) are not counted, so each least time below is a floor.
"""

from __future__ import annotations

import dataclasses
import math

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth. Copied from
#: ``chip_smoke.py`` (``PEAK_BYTES_PER_S``) and frozen here.
PEAK_BYTES_PER_S = 3.35e12
#: Data sheet: float32 outside the tensor cores (a float32 configuration
#: with TF32 off runs here). From ``chip_smoke.py``.
PEAK_F32_OPS_PER_S = 67e12
#: Data sheet: dense bfloat16 on the tensor cores. From ``chip_smoke.py``.
PEAK_BF16_OPS_PER_S = 989e12
#: Special-function unit (exp): 16 results per clock per SM (CUDA
#: programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz, the
#: boost clock at which 132 SMs reach the float32 peak. From
#: ``chip_smoke.py``.
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
# The best read rate measured on the card, ``tools/bench_dma.py``'s
# ``row_sum_ring``, is 0.924 of PEAK_BYTES_PER_S (PERF.md): the least times
# below use the data sheet's peaks, and that share is recorded beside them.

F32 = 4
ID = 4
OPS_PEAK = {"float32": PEAK_F32_OPS_PER_S, "bfloat16": PEAK_BF16_OPS_PER_S}


def bound(bytes_moved: float, ops: float,
          ops_peak: float = PEAK_F32_OPS_PER_S,
          exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work, in ms: the largest of the bytes over
    the memory rate, the arithmetic over its unit's peak rate and the
    exponentials over the special-function rate (``chip_smoke.py``'s
    ``bound``, frozen here)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_peak, exps / PEAK_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str        # gemm, segment_sum, segment_max, attend, adam
    flops: float
    bytes: float
    exps: float = 0.0

    def least_ms(self, ops_peak: float) -> float:
        return bound(self.bytes, self.flops, ops_peak, self.exps)[0]


def gemm(m: int, k: int, n: int) -> Op:
    """[m, k] @ [k, n]."""
    return Op("gemm", 2.0 * m * k * n, F32 * (m * k + k * n + m * n))


def segment_sum(n_out: int, e: int, f: int, table: int = 0,
                weights: int = 0) -> Op:
    """Sums of ``f``-wide values over ``e`` edges into ``n_out`` rows: the
    values gathered from a ``[table, f]`` table by sender id (``table``
    rows), else read per edge ``[e, f]``; ``weights`` values per edge
    multiply them. Reads the row offsets, writes ``[n_out, f]``."""
    values = F32 * table * f + ID * e if table else F32 * e * f
    return Op("segment_sum", (2.0 if weights else 1.0) * e * f,
              values + F32 * e * weights + ID * (n_out + 1)
              + F32 * n_out * f)


def segment_max(n_out: int, e: int, f: int) -> Op:
    """Row maxima of per-edge values ``[e, f]``."""
    return Op("segment_max", 1.0 * e * f,
              F32 * e * f + ID * (n_out + 1) + F32 * n_out * f)


def attend_forward(n: int, e: int, heads: int, feat: int) -> Op:
    """Softmax attention over ``e`` edges: from ``x`` [n, heads*feat] and
    the logits ``f_src``, ``f_dst`` [n, heads], each edge's score (add,
    LeakyReLU, shift: 3 operations), its exponential, the denominator
    (1) and the weighted sum (2 a value); writes ``out``."""
    hf = heads * feat
    return Op("attend", e * heads * (2.0 * feat + 4.0),
              F32 * (2 * n * hf + 2 * n * heads) + ID * (e + n + 1),
              e * heads)


def attend_backward(n: int, e: int, heads: int, feat: int) -> Op:
    """The attention's gradient: reads ``x``, the cotangent and ``out``
    [n, heads*feat] and the logits, recomputes each edge's weight (4 and
    an exponential), forms ``g·x`` (2 a value) and scatters ``dx`` (2 a
    value); writes ``dx`` and the logits' gradients."""
    hf = heads * feat
    return Op("attend", e * heads * (4.0 * feat + 8.0),
              F32 * (4 * n * hf + 4 * n * heads) + ID * (e + n + 1),
              e * heads)


def adam(params: int) -> Op:
    """AdamW: reads the parameter, its gradient and both moments, writes
    the parameter and the moments."""
    return Op("adam", 12.0 * params, F32 * 7 * params)


def count(params: dict) -> int:
    """The values of a model's parameters (``reference/<model>.py``'s
    ``params``: name -> (shape, fan))."""
    return sum(math.prod(shape) for shape, _ in params.values())


def least_ms(ops: list[Op], dtype: str, kinds=None) -> float:
    """The summed least time of ``ops`` (of ``kinds`` only, if given)."""
    peak = OPS_PEAK[dtype]
    return sum(op.least_ms(peak) for op in ops
               if kinds is None or op.kind in kinds)
