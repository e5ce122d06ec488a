"""BCSR SpMM: aggregation over the dense tiles of the hybrid layout.

Port of ``graphneuralnetwork_tpu/ops/bcsr_spmm.py``. ``bcsr_spmm(bg, x,
bg_t)`` computes the same ``out[r] = Σ w_sr · x[s]`` as ``ops.spmm`` over
the tiles of a ``BCSRGraph``: K3 (``ops/cuda/bcsr_spmm_kernel.py``) on the
card, its plain version on the CPU. The gradient with respect to ``x`` is
the transpose operator, K3 on the transpose tiles ``bg_t``; the tiles are
static adjacency weights and get no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.bcsr import BCSRGraph
from .cuda.bcsr_spmm_kernel import bcsr_spmm as _bcsr_spmm_kernel


class _BCSRSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bg, bg_t):
        ctx.bg_t = bg_t
        return _bcsr_spmm_kernel(bg, x)

    @staticmethod
    def backward(ctx, g):
        return _bcsr_spmm_kernel(ctx.bg_t, g.contiguous()), None, None


def bcsr_spmm(bg: BCSRGraph, x: torch.Tensor,
              bg_t: Optional[BCSRGraph] = None) -> torch.Tensor:
    """out[r] = Σ w_sr · x[s] over the dense-tile layout, in ``x``'s type.

    ``bg_t`` (the Aᵀ tiles) drives the backward pass; omit it for a
    symmetric adjacency (GCN's D^-1/2 (A+I) D^-1/2), where A == Aᵀ. A 1-D
    ``x`` gives a 1-D result.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    out = _BCSRSpMM.apply(x.contiguous(), bg, bg if bg_t is None else bg_t)
    return out[:, 0] if squeeze else out
