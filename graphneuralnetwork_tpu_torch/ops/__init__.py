"""Compute ops: segment reductions, SpMM/SDDMM and edge softmax.

Dispatch depends only on the tensor's device: a CUDA tensor runs the
hand-written kernels of ``ops/cuda`` (or raises), a CPU tensor their plain
PyTorch versions. There is no switch.
"""

from .aggregate import aggregate_edges  # noqa: F401
from .segment import (  # noqa: F401
    edge_softmax,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from .spmm import (  # noqa: F401
    sddmm_additive,
    sddmm_dot,
    spmm,
    spmm_coo,
    spmm_weighted,
)
