"""The launch counter of every kernel wrapper, by the TPU kernel it replaces
(K1-K10; ``row_sum_stream`` and ``row_sum_ring`` for ``reduce_auto`` and
``reduce_manual`` of ``tools/bench_dma.py``). A wrapper adds one to its
``launches`` where it launches its kernel and nowhere else; the plain
versions count nothing.

A CUDA graph turns that around: its capture calls the wrappers (they count)
but launches nothing, and its replays launch the kernels without calling a
wrapper. ``count_capture`` takes a capture's counts off the totals and
returns them, the launches of one replay, which ``add_launches`` adds to
the totals at each replay.
"""

from __future__ import annotations

from typing import Callable

from .attend_bwd_kernel import attend_bwd_a, attend_bwd_b
from .attend_online_kernel import attend_online
from .attend_parts_kernel import attend_fused, tile_parts
from .bcsr_spmm_kernel import bcsr_spmm
from .neighbor_max_kernel import neighbor_max
from .rem_attend_kernel import rem_attend
from .row_sum_kernel import row_sum_ring, row_sum_stream
from .segment_max_kernel import segment_max
from .spmm_kernel import segment_sum

COUNTERS = {"K1": segment_sum, "K2": segment_max, "K3": bcsr_spmm,
            "K4": attend_online, "K5": attend_bwd_a, "K6": attend_bwd_b,
            "K7": neighbor_max, "K8": rem_attend, "K9": tile_parts,
            "K10": attend_fused, "row_sum_stream": row_sum_stream,
            "row_sum_ring": row_sum_ring}


def reset_launches() -> None:
    for wrapper in COUNTERS.values():
        wrapper.launches = 0


def read_launches() -> dict[str, int]:
    return {k: w.launches for k, w in COUNTERS.items()}


def add_launches(counts: dict[str, int]) -> None:
    for k, n in counts.items():
        COUNTERS[k].launches += n


def count_capture(capture: Callable[[], None]) -> dict[str, int]:
    """Call ``capture()`` and return the launches its wrapper calls counted,
    taken off the totals again: a capture records kernels without
    launching them."""
    before = read_launches()
    capture()
    counted = {k: n - before[k] for k, n in read_launches().items()}
    add_launches({k: -n for k, n in counted.items()})
    return counted
