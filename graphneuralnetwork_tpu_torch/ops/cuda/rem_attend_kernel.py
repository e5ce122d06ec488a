"""K8: the COO remainder's softmax partials, given the shift
(``csrc/attend_fused_kernel.cu``, entry ``gnn_rem_attend``).

``rem_attend(hg, x, f_src, f_dst, m, keep_mul, slope)`` computes, for every
receiver r and head h over the real remainder edges s -> r of the hybrid
graph ``hg``:

    p   = w * exp(min(LeakyReLU(f_dst[r,h] + f_src[s,h]) - m[r,h], 0))
    den = sum p;   num = sum p * keep_mul[e,h] * x[s,h,:]

with ``x`` [N, H*F] (float32 or bfloat16), ``f_src``, ``f_dst`` and ``m``
float32 [N, H], ``w`` the remainder's edge weights and ``keep_mul``
(float32 [E_pad, H], attention dropout's numerator multiplier) or None.
Returns ``(num, den)``: float32 [N, H*F] and [N, H], zero on rows without
remainder edges. The exponent is clamped at 0 whatever ``m`` is: with the
exact shift the clamp never bites, with a stand-in (``m = 0``) it caps
every term at ``w``.

It replaces the TPU kernel ``_rem_attend_kernel`` of
``graphneuralnetwork_tpu/ops/pallas/rem_attend_kernel.py``
(``rem_attend_pallas``); the design note is in the CUDA source: a mode of
the row walk that runs K9 and K10 (``attend_parts_kernel``), over each
receiver row's remainder edges only, a slab of its columns at a time
(``attend_common.walk_layout``); rows whose remainder alone holds more
than ``LONG_ROW_EDGES`` edges (``HybridGraph.rem_long_rows``) split over
a CTA. ``rem_attend_args`` builds the launch arguments. A CUDA tensor launches
the kernel; a CPU tensor takes ``rem_attend_plain``.
``rem_attend.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.bcsr import HybridGraph
from .attend_common import (LONG_ROW_EDGES, check_operands, cuda_stream,
                            ptr, rem_edges, softmax_parts, walk_layout)
from .attend_parts_kernel import WALK_ENTRIES
from .build import check, load


def rem_attend_plain(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                     f_dst: torch.Tensor, m: torch.Tensor,
                     keep_mul: Optional[torch.Tensor], slope: float):
    """The plain PyTorch version: ``softmax_parts`` over the remainder's
    real edges, the remainder half of ``attend_online_plain``'s second
    pass."""
    n, hf = x.shape
    recv, send, w, keep = rem_edges(hg, keep_mul)
    num, den = softmax_parts(recv, send, w, keep, x, f_src, f_dst, m, slope)
    return num.reshape(n, hf), den


def rem_attend_args(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
                    f_dst: torch.Tensor, m: torch.Tensor,
                    keep_mul: Optional[torch.Tensor], num: torch.Tensor,
                    den: torch.Tensor, slope: float, stream: int) -> list:
    """``gnn_rem_attend``'s arguments (``PARTS_ENTRIES``): the remainder
    (senders, weights, spans), ``keep_mul``, the rows long by their
    remainder alone (``HybridGraph.rem_long_rows``) and the column layout
    of ``x`` and ``num`` (``walk_layout``); no tile operand."""
    heads = f_src.shape[1]
    rem = hg.rem
    lay = walk_layout(heads, x, num)
    long_rows = hg.rem_long_rows
    n, hf = x.shape
    return [x.data_ptr(), f_src.data_ptr(), f_dst.data_ptr(), m.data_ptr(),
            rem.senders.data_ptr(), rem.edge_weight.data_ptr(),
            rem.row_ptr.data_ptr(), ptr(keep_mul), long_rows.data_ptr(),
            num.data_ptr(), den.data_ptr(), n, heads, hf // heads,
            int(x.dtype == torch.bfloat16), *lay.args(), lay.parts,
            long_rows.numel(), LONG_ROW_EDGES, float(slope),
            int(keep_mul is not None), stream]


def rem_attend(hg: HybridGraph, x: torch.Tensor, f_src: torch.Tensor,
               f_dst: torch.Tensor, m: torch.Tensor,
               keep_mul: Optional[torch.Tensor], slope: float):
    if x.device.type == "cpu":
        return rem_attend_plain(hg, x, f_src, f_dst, m, keep_mul, slope)
    if x.device.type != "cuda":
        raise ValueError(f"rem_attend: unsupported device {x.device}")
    heads = f_src.shape[1]
    dropping = keep_mul is not None
    check_operands("rem_attend", hg, x, heads, None, keep_mul, dropping,
                   masks=("keep_mul",), f_src=f_src, f_dst=f_dst, m=m)
    n, hf = x.shape
    num = torch.empty(n, hf, dtype=torch.float32, device=x.device)
    den = torch.empty(n, heads, dtype=torch.float32, device=x.device)
    if n == 0:
        return num, den
    args = rem_attend_args(hg, x, f_src, f_dst, m, keep_mul, num, den, slope,
                           cuda_stream(x))
    lib = load("attend_fused_kernel", WALK_ENTRIES)
    with torch.cuda.device(x.device):
        err = lib.gnn_rem_attend(*args)
    check(lib, err, "rem_attend kernel launch")
    rem_attend.launches += 1
    return num, den


rem_attend.launches = 0
