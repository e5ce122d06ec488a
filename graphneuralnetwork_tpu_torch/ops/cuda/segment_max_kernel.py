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

``gat_softmax(graph, f_src, f_dst, slope)`` is GAT's edge softmax in two
further modes of the same kernel, on the same layout (``H`` columns, one a
head), always with the sender gather: from the per-node logits ``f_src``
[sender rows, H] and ``f_dst`` [N, H], per receiver row ``r`` and head,

    s_e = LeakyReLU(f_src[senders_e] + f_dst[r]),
    α_e = exp(s_e - m_r) / max(Σ_e exp(s_e - m_r), 1e-16),  m_r = max_e s_e

over the row's real edges, [E_pad, H] float32 with 0 on the padding
edges, in one launch; ``gat_softmax_backward(graph, α, dα, f_src, f_dst,
slope)`` its gradient in one more: ``ds_e = α_e (dα_e - Σ_e α_e dα_e) ·
(z_e > 0 ? 1 : slope)`` with ``z_e = f_src[senders_e] + f_dst[r]``
recomputed ([E_pad, H], 0 on the padding) and ``d f_dst[r] = Σ_e ds_e``
([N, H]), no [E, H] intermediate of the scores kept between the two. The
CPU takes the plain versions (``gat_softmax_plain``: the PyTorch chain
the modes replace, in the tables' dtype; ``gat_softmax_backward_plain``).
Their launches count in ``segment_max.launches`` and in
``segment_max_softmax.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import types
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
#: stream; the softmax modes' entry: pointers (f_src, f_dst, senders,
#: row_ptr, long_rows, alpha, grad, edge_out, out), n_rows, c, the layout,
#: n_long, long_edges, empty, slope, backward, stream
_ENTRIES = {
    "gnn_segment_max": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p],
    "gnn_gat_softmax": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "gnn_noop": [ctypes.c_void_p],
}


def _row_args(graph: Graph, c: int, operands: list, sm_count: int) -> list:
    """The arguments both entries take after their pointers: n_rows, c,
    ``segmax_layout``'s layout (in 16-byte vectors where every float
    operand is aligned to them), n_long, long_edges, empty."""
    aligned = all(t.data_ptr() % 16 == 0 for t in operands if t is not None)
    lay = segmax_layout(c, graph.mean_row_edges, graph.n_nodes, sm_count,
                        aligned)
    return [graph.n_nodes, c, *lay.args(), graph.long_rows.numel(),
            graph.long_edges, EMPTY]


def _check_graph(op: str, graph: Graph, device: torch.device,
                 senders: Optional[torch.Tensor]) -> None:
    """The int32 arrays a K2 launch reads, contiguous on ``device``: the
    graph's ``row_ptr`` [N + 1] and, where given, ``senders`` of at least
    E entries."""
    n, e = graph.n_nodes, graph.n_edges
    row_ptr = graph.row_ptr
    if (row_ptr.dtype != torch.int32 or row_ptr.device != device
            or not row_ptr.is_contiguous() or row_ptr.shape != (n + 1,)):
        raise ValueError(f"{op}: the graph's row_ptr must be a contiguous "
                         f"int32 [{n + 1}] tensor on {device}")
    if senders is not None and (
            senders.dtype != torch.int32 or senders.device != device
            or not senders.is_contiguous() or senders.shape[0] < e):
        raise ValueError(f"{op}: senders must be a contiguous int32 tensor "
                         f"of at least {e} entries on {device}")


def segmax_args(graph: Graph, src: torch.Tensor,
                senders: Optional[torch.Tensor], out: torch.Tensor,
                stream: int, sm_count: int) -> list:
    """``gnn_segment_max``'s arguments (``_ENTRIES``) on a card of
    ``sm_count`` SMs."""
    return [src.data_ptr(), None if senders is None else senders.data_ptr(),
            graph.row_ptr.data_ptr(), graph.long_rows.data_ptr(),
            out.data_ptr(), *_row_args(graph, src.shape[1], [src, out],
                                       sm_count), stream]


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
    _check_graph("segment_max", graph, src.device, senders)
    if senders is None and src.shape[0] < e:
        raise ValueError(f"segment_max: {src.shape[0]} rows of scores "
                         f"for {e} edges")
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
#: K2's launches that carry GAT's edge softmax or its backward
#: (``gat_softmax``, ``gat_softmax_backward``), counted beside
#: ``segment_max.launches``.
segment_max_softmax = types.SimpleNamespace(launches=0)


def gat_softmax_plain(graph: Graph, f_src: torch.Tensor, f_dst: torch.Tensor,
                      slope: float) -> torch.Tensor:
    """The softmax mode in plain PyTorch, in the tables' dtype: the chain it
    replaces (the sender and receiver gathers, LeakyReLU, the rows' maxima
    from the ``EMPTY`` sentinel with a row at it shifted by 0, ``exp``,
    the rows' float sums by ``index_add_``, the divide), on the real
    edges; the padding rows of the [E_pad, H] result are 0."""
    e, n = graph.n_edges, graph.n_nodes
    recv = graph.receivers[:e].long()
    s = torch.nn.functional.leaky_relu(
        f_src[graph.senders[:e].long()] + f_dst[recv], slope)
    h = s.shape[1]
    m = torch.full((n, h), EMPTY, dtype=s.dtype, device=s.device)
    m = m.scatter_reduce_(0, recv[:, None].expand(-1, h), s, "amax",
                          include_self=True)
    m = torch.where(m > EMPTY / 2, m, 0.0)
    p = torch.exp(s - m[recv])
    den = torch.zeros_like(m).index_add_(0, recv, p).clamp_min(1e-16)
    alpha = s.new_zeros(graph.n_edge_pad, h)
    alpha[:e] = p / den[recv]
    return alpha


def gat_softmax_backward_plain(graph: Graph, alpha: torch.Tensor,
                               d_alpha: torch.Tensor, f_src: torch.Tensor,
                               f_dst: torch.Tensor, slope: float
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward mode in plain PyTorch: ``(ds, d f_dst)`` (module
    docstring) on the real edges, ``ds``'s padding rows 0."""
    e, n = graph.n_edges, graph.n_nodes
    recv = graph.receivers[:e].long()
    a, g = alpha[:e], d_alpha[:e]
    h = a.shape[1]
    c = a.new_zeros(n, h).index_add_(0, recv, a * g)
    z = f_src[graph.senders[:e].long()] + f_dst[recv]
    v = a * (g - c[recv])
    ds = torch.zeros_like(alpha)
    ds[:e] = torch.where(z > 0, v, v * slope)
    return ds, a.new_zeros(n, h).index_add_(0, recv, ds[:e])


def _check_softmax(graph: Graph, **tensors: torch.Tensor) -> None:
    """The softmax modes take contiguous float32 operands of H columns on
    one card: ``f_src`` [sender rows, H], ``f_dst`` [N, H], the rest
    [E_pad, H]; the graph's int32 arrays on the same card."""
    device, h = tensors["f_dst"].device, tensors["f_dst"].shape[-1]
    rows = {"f_src": graph.sender_rows, "f_dst": graph.n_nodes}
    for name, t in tensors.items():
        want = (rows.get(name, graph.n_edge_pad), h)
        if (t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous() or t.shape != want):
            raise ValueError(f"gat_softmax: {name} must be a contiguous "
                             f"float32 {list(want)} tensor on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check_graph("gat_softmax", graph, device, graph.senders)


def softmax_args(graph: Graph, f_src: torch.Tensor, f_dst: torch.Tensor,
                 alpha: Optional[torch.Tensor],
                 d_alpha: Optional[torch.Tensor], edge_out: torch.Tensor,
                 out: Optional[torch.Tensor], slope: float, stream: int,
                 sm_count: int) -> list:
    """``gnn_gat_softmax``'s arguments (``_ENTRIES``) on a card of
    ``sm_count`` SMs: the forward where ``alpha`` is None, else the
    backward; the layout is ``segmax_layout``'s at H columns."""
    ops = [f_src, f_dst, alpha, d_alpha, edge_out, out]
    ptr = [None if t is None else t.data_ptr() for t in ops]
    return [ptr[0], ptr[1], graph.senders.data_ptr(),
            graph.row_ptr.data_ptr(), graph.long_rows.data_ptr(), *ptr[2:],
            *_row_args(graph, f_dst.shape[1], ops, sm_count), float(slope),
            int(alpha is not None), stream]


def _softmax_kernel(graph: Graph, f_src: torch.Tensor, f_dst: torch.Tensor,
                    slope: float, alpha: Optional[torch.Tensor] = None,
                    d_alpha: Optional[torch.Tensor] = None):
    """One launch in the softmax mode (``alpha`` None: returns α) or the
    backward mode (returns ``(ds, d f_dst)``); the padding edges' rows of
    the [E_pad, H] output are zeroed here, the kernel never reaching
    them."""
    if f_dst.device.type != "cuda":
        raise ValueError(f"gat_softmax: unsupported device {f_dst.device}")
    backward = alpha is not None
    pair = dict(alpha=alpha, d_alpha=d_alpha) if backward else {}
    _check_softmax(graph, f_src=f_src, f_dst=f_dst, **pair)
    edge_out = torch.empty(graph.n_edge_pad, f_dst.shape[1],
                           dtype=torch.float32, device=f_dst.device)
    edge_out[graph.n_edges:] = 0.0
    out = torch.empty_like(f_dst) if backward else None
    if f_dst.numel():
        args = softmax_args(
            graph, f_src, f_dst, alpha, d_alpha, edge_out, out, slope,
            torch.cuda.current_stream(f_dst.device).cuda_stream,
            sm_count(f_dst.device.index or 0))
        lib = load("segment_max_kernel", _ENTRIES)
        with torch.cuda.device(f_dst.device):
            err = lib.gnn_gat_softmax(*args)
        check(lib, err, "gat_softmax kernel launch")
        segment_max.launches += 1
        segment_max_softmax.launches += 1
    return (edge_out, out) if backward else edge_out


def gat_softmax(graph: Graph, f_src: torch.Tensor, f_dst: torch.Tensor,
                slope: float) -> torch.Tensor:
    """GAT's edge softmax α [E_pad, H] (module docstring): the kernel's
    softmax mode on a card, ``gat_softmax_plain`` on the CPU."""
    if f_dst.device.type == "cpu":
        return gat_softmax_plain(graph, f_src, f_dst, slope)
    return _softmax_kernel(graph, f_src, f_dst, slope)


def gat_softmax_backward(graph: Graph, alpha: torch.Tensor,
                         d_alpha: torch.Tensor, f_src: torch.Tensor,
                         f_dst: torch.Tensor, slope: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ds [E_pad, H], d f_dst [N, H])`` of GAT's edge softmax (module
    docstring): the kernel's backward mode on a card,
    ``gat_softmax_backward_plain`` on the CPU."""
    if f_dst.device.type == "cpu":
        return gat_softmax_backward_plain(graph, alpha, d_alpha, f_src, f_dst,
                                          slope)
    return _softmax_kernel(graph, f_src, f_dst, slope, alpha, d_alpha)


def launch_floor(device: torch.device) -> None:
    """Launch the library's empty kernel on ``device``'s current stream,
    through the same ``ctypes`` path as ``segment_max``; counts nothing."""
    lib = load("segment_max_kernel", _ENTRIES)
    with torch.cuda.device(device):
        err = lib.gnn_noop(torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, "noop kernel launch")
