"""K2: receiver-sorted segment max, with an optional sender gather
(``csrc/segment_max_kernel.cu``).

``segment_max(graph, src, senders=None)`` computes, over the real edges of
the receiver-sorted ``graph`` (a ``Graph``: ``row_ptr`` spans them),

    out[r, c] = max(EMPTY, max_{e: receivers[e] = r} src[idx(e), c])

for float32 ``src`` of shape [*, C], with ``idx(e) = e`` (per-edge scores
[E_pad, C], as ``edge_softmax`` passes them) or, given ``senders``,
``idx(e) = senders[e]`` (a node table [N, C]: the remainder's neighbour max
of the three-pass shift and of SAGE's max-pool, with no gathered copy). A
row without edges gets the ``EMPTY = -3e38`` sentinel, which callers map
to 0; a NaN propagates. It replaces the TPU kernel ``_segmax_kernel`` of
``graphneuralnetwork_tpu/ops/pallas/segment_max_kernel.py``
(``segment_max_pallas``). Forward only: callers detach ``src``.

Only the edges that ``row_ptr`` spans count: edges ``e >= row_ptr[-1]``
(a graph's padding) are ignored. A CUDA tensor launches the kernel; a CPU
tensor takes ``segment_max_plain`` on the spanned edges. The host picks
the kernel's layout (``segmax_layout``: lanes an edge from ``C``, lanes a
row from the graph's mean row length and how many rows fill the card) and
reads the rows that a CTA of their own takes from ``Graph.long_rows``;
``segmax_args`` builds the launch arguments. ``segment_max.launches``
counts kernel launches. ``launch_floor(device)`` launches the library's
empty kernel, whose time is the floor of a launch through this path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from ...core.graph import Graph
from .build import check, load
from .tile_walk import sm_count

EMPTY = -3.0e38  # sentinel below any score the callers produce
#: Vectors a slab of the grid's second dimension holds (one a lane), and
#: edges in flight a lane on a row's group (``csrc``'s ``kSlabVecs`` and
#: ``kUnroll``).
SLAB_VECS = 32
UNROLL = 4
#: Edges a row's group covers in one step at least: on a graph whose rows
#: fill less than the card, most rows then take one step.
MIN_STEP_EDGES = 16
#: CTAs (of 8 warps) an SM keeps resident at K2's register use
#: (``kMinBlocks``): where a graph's rows take more warps than one such
#: wave of the card, groups shrink (more rows a warp) down to covering half
#: the mean row length in one step, and the rows take one wave of CTAs
#: whose warps loop over the rest.
ROW_CTAS_PER_SM = 4
WAVE_WARPS_PER_SM = 8 * ROW_CTAS_PER_SM


def segment_max_plain(scores: torch.Tensor, receivers: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """The plain PyTorch version: ``scatter_reduce_("amax")`` into a
    sentinel-filled output. The sentinel takes part in the max
    (``include_self=True``), as it does in the kernel, so a row whose
    scores are all below it (masked edges) also reads ``EMPTY``. For the
    gathered form the caller passes ``table[senders]``."""
    h = scores.shape[1]
    out = torch.full((n_out, h), EMPTY, dtype=torch.float32,
                     device=scores.device)
    idx = receivers.long()[:, None].expand(-1, h)
    return out.scatter_reduce_(0, idx, scores.float(), "amax",
                               include_self=True)


def _pow2_at_least(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class SegmaxLayout:
    """K2's layout for ``C`` columns: vectors of ``vec`` floats, ``lpe``
    lanes an edge (one vector each), ``group`` lanes a row (32 / ``group``
    rows a warp), slabs of ``per`` vectors on the grid's second dimension,
    ``n_slabs`` of them; at most ``row_ctas`` CTAs for the rows (0: a warp
    for each set of 32 / ``group`` rows), whose warps loop over the
    rest."""

    vec: int
    lpe: int
    group: int
    per: int
    n_slabs: int
    row_ctas: int

    def args(self) -> list:
        return [self.vec, self.lpe, self.group, self.per, self.n_slabs,
                self.row_ctas]


def segmax_layout(c: int, mean_row_edges: float, n_rows: int,
                  sm_count: int, aligned: bool = True) -> SegmaxLayout:
    """Vectors of 4 floats where ``C`` and the addresses allow, else
    scalars; an edge's vectors in equal slabs of at most ``SLAB_VECS``,
    one a lane over the fewest lanes (a power of two); a row's group
    covers twice the mean row length, and at least ``MIN_STEP_EDGES``, in
    one step (``UNROLL`` edges a lane), at most a warp; where the rows'
    warps exceed one wave of ``WAVE_WARPS_PER_SM`` warps an SM, it shrinks
    down to covering half the mean row length in one step; the rows take
    at most one wave of CTAs (``ROW_CTAS_PER_SM`` an SM), whose warps loop
    over the rest (measured on an H100: PERF.md §6)."""
    vec = 4 if c % 4 == 0 and aligned else 1
    vpe = c // vec
    n_slabs = -(-vpe // SLAB_VECS)
    per = -(-vpe // n_slabs)
    lpe = _pow2_at_least(per)
    step = max(2 * mean_row_edges, MIN_STEP_EDGES)
    epg = min(32 // lpe, _pow2_at_least(math.ceil(step / UNROLL)))
    wave = sm_count * WAVE_WARPS_PER_SM
    while (epg > 1 and n_rows * n_slabs * lpe * epg > 32 * wave
           and epg // 2 * UNROLL * 2 >= mean_row_edges):
        epg //= 2
    return SegmaxLayout(vec, lpe, lpe * epg, per, n_slabs,
                        sm_count * ROW_CTAS_PER_SM)


#: pointers (src, senders, row_ptr, long_rows, out), n_rows, c, the layout
#: (vec, lpe, group, per, n_slabs, row_ctas), n_long, long_edges, empty,
#: stream
_ENTRIES = {
    "gnn_segment_max": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p],
    "gnn_noop": [ctypes.c_void_p],
}


def segmax_args(graph: Graph, src: torch.Tensor,
                senders: Optional[torch.Tensor], out: torch.Tensor,
                stream: int, sm_count: int) -> list:
    """``gnn_segment_max``'s arguments (``_ENTRIES``) on a card of
    ``sm_count`` SMs."""
    c = src.shape[1]
    aligned = src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lay = segmax_layout(c, graph.mean_row_edges, graph.n_nodes, sm_count,
                        aligned)
    long_rows = graph.long_rows
    return [src.data_ptr(), None if senders is None else senders.data_ptr(),
            graph.row_ptr.data_ptr(), long_rows.data_ptr(), out.data_ptr(),
            graph.n_nodes, c, *lay.args(), long_rows.numel(),
            graph.long_edges, EMPTY, stream]


def segment_max(graph: Graph, src: torch.Tensor,
                senders: Optional[torch.Tensor] = None) -> torch.Tensor:
    n, e = graph.n_nodes, graph.n_edges
    if src.device.type == "cpu":
        rows = src[:e] if senders is None else src[senders[:e].long()]
        return segment_max_plain(rows, graph.receivers[:e], n)
    if src.device.type != "cuda":
        raise ValueError(f"segment_max: unsupported device {src.device}")
    if (src.dtype != torch.float32 or src.ndim != 2
            or not src.is_contiguous()):
        raise ValueError("segment_max: src must be a contiguous float32 "
                         f"[*, C] tensor, got {src.dtype} "
                         f"{tuple(src.shape)}")
    row_ptr = graph.row_ptr
    if (row_ptr.dtype != torch.int32 or row_ptr.device != src.device
            or row_ptr.shape != (n + 1,)):
        raise ValueError("segment_max: the graph's row_ptr must be an int32 "
                         f"[{n + 1}] tensor on {src.device}")
    if senders is None:
        if src.shape[0] < e:
            raise ValueError(f"segment_max: {src.shape[0]} rows of scores "
                             f"for {e} edges")
    elif (senders.dtype != torch.int32 or senders.device != src.device
          or not senders.is_contiguous() or senders.shape[0] < e):
        raise ValueError("segment_max: senders must be a contiguous int32 "
                         f"tensor of at least {e} entries on {src.device}")
    if src.numel() >= 2 ** 31:
        raise ValueError("segment_max: src too large for int32 offsets")
    out = torch.empty(n, src.shape[1], dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out
    args = segmax_args(graph, src, senders, out,
                       torch.cuda.current_stream(src.device).cuda_stream,
                       sm_count(src.device.index or 0))
    lib = load("segment_max_kernel", _ENTRIES)
    with torch.cuda.device(src.device):
        err = lib.gnn_segment_max(*args)
    check(lib, err, "segment_max kernel launch")
    segment_max.launches += 1
    return out


segment_max.launches = 0


def launch_floor(device: torch.device) -> None:
    """Launch the library's empty kernel on ``device``'s current stream,
    through the same ``ctypes`` path as ``segment_max``; counts nothing."""
    lib = load("segment_max_kernel", _ENTRIES)
    with torch.cuda.device(device):
        err = lib.gnn_noop(torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, "noop kernel launch")
