"""K1: receiver-sorted segment sum, per edge or with the sender gather
folded in (``csrc/spmm_kernel.cu``).

``segment_sum(values, receivers, row_ptr, n_out)`` computes
``out[r] = Σ_{e ∈ span(r)} values[e]`` for ``values`` of shape [E_pad, F]
in float32 or bfloat16, accumulated in float32 and returned in the input
type. Given ``senders`` it is the gathered form: ``values`` is a node
table [N, C] and

    out[r, c] = Σ_{e ∈ span(r)} round_T(w[wi(e), h(c)] · values[senders[e], c])

with ``weight`` float32 [E] or [E, H] (``h(c) = c / (C / H)``; no weight:
1), read at ``wi(e) = weight_at[e]`` where given, else at ``e``, and
rounded to the values' type ``T`` first where ``round_weight`` is set; the
product rounds to ``T`` before it is added. ``span(r)`` is
``[row_ptr[r], row_ptr[r+1])`` and ``receivers[e]`` the row of edge ``e``
(read by the plain version only). It replaces the TPU kernels
``_spmm_kernel_hilo`` / ``_spmm_kernel_bf16`` of
``graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py`` (``_spmm_pallas_call``);
the design note is in the CUDA source.

Only the edges that ``row_ptr`` spans count: edges ``e >= row_ptr[-1]``
(a graph's padding) are ignored whatever their values. A CUDA tensor
launches the kernel; a CPU tensor takes the plain version on the spanned
edges (``segment_sum_plain``, after ``gathered_plain``'s products in the
gathered form). The host picks the kernel's layout (``spmm_layout``: lanes
an edge from the width, lanes and warps a row from the mean row length,
the row count and how many fill the card) and takes the rows that a CTA of
their own takes from ``long_rows`` (``Graph.long_rows`` or the
transpose's); ``spmm_args`` builds the launch arguments.
``segment_sum.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from .build import check, load
from .tile_walk import sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Vectors a slab of the grid's second dimension holds (one a lane), and
#: edges in flight a lane (``csrc``'s ``kSlabVecs`` and ``kUnroll``).
SLAB_VECS = 32
UNROLL = 4
#: Edges a row's group covers in one step at least.
MIN_STEP_EDGES = 16
#: Warps a row takes at most (a CTA's 8): where a row's group covers twice
#: the mean row in one step, long-row graphs such as GTN's final
#: convolution (920 rows of ~140 edges) take several warps a row.
MAX_ROW_WARPS = 8
#: Columns from which float32 takes two 16-byte vectors a lane: one a lane
#: would take a whole warp for each edge.
PAIRED_VECTOR_COLS = 128
#: CTAs (of 8 warps) an SM keeps resident at K1's register use
#: (``kMinBlocks``): where a graph's rows take more warps than one such
#: wave of the card, groups shrink down to covering half the mean row
#: length in one step, and the rows take one wave of CTAs whose warps loop
#: over the rest, unless they would loop more than ``PERSISTENT_LOOPS``
#: times: then as many CTAs as they take (the hardware's own scheduling of
#: short CTAs beat loops of 9 and 31 on the 4,637-node and 2M-edge graphs,
#: the loop won at 4.7 on GTN's second composition).
ROW_CTAS_PER_SM = 4
PERSISTENT_LOOPS = 6


def segment_sum_plain(values: torch.Tensor, receivers: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """The plain PyTorch version: float32 ``index_add_``, cast back."""
    out = torch.zeros(n_out, values.shape[1], dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, receivers, values.float())
    return out.to(values.dtype)


def gathered_plain(table: torch.Tensor, senders: torch.Tensor,
                   weight: Optional[torch.Tensor] = None,
                   weight_at: Optional[torch.Tensor] = None,
                   round_weight: bool = False) -> torch.Tensor:
    """The gathered form's per-edge values in plain PyTorch: ``table``'s
    rows at ``senders``, each times its weight in float32 (the weight
    rounded to the table's type first where ``round_weight`` is set) and
    rounded to the table's type once. ``segment_sum_plain`` of these is
    the gathered form's plain version."""
    rows = table[senders.long()]
    if weight is None:
        return rows
    w = weight if weight_at is None else weight[weight_at.long()]
    w = w[:, None] if w.ndim == 1 else w
    if round_weight:
        w = w.to(table.dtype)
    e, h = w.shape
    c = rows.shape[1]
    prod = rows.float().reshape(e, h, c // h) * w.float()[:, :, None]
    return prod.to(table.dtype).reshape(e, c)


def _pow2_at_least(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class SpmmLayout:
    """K1's layout for ``C`` columns: vectors of ``vec`` elements, ``lpe``
    lanes an edge (one vector each), ``group`` lanes a row within a warp
    (32 / ``group`` rows a warp) on ``row_warps`` warps (``group`` 32
    where more than one), slabs of ``per`` vectors on the grid's second
    dimension, ``n_slabs`` of them; at most ``row_ctas`` CTAs for the
    rows, which loop over the rest."""

    vec: int
    lpe: int
    group: int
    row_warps: int
    per: int
    n_slabs: int
    row_ctas: int

    def args(self) -> list:
        return [self.vec, self.lpe, self.group, self.row_warps, self.per,
                self.n_slabs, self.row_ctas]


def spmm_layout(c: int, f: int, elt: int, mean_row_edges: float,
                n_rows: int, sm_count: int, align: int = 32) -> SpmmLayout:
    """16-byte vectors (4 float32 or 8 bfloat16 of ``elt`` bytes), for
    float32 from ``PAIRED_VECTOR_COLS`` columns two a lane, where ``C``,
    the head width ``f`` and the addresses' alignment ``align`` (in bytes)
    allow, else pairs, else scalars;
    an edge's vectors in equal slabs of at most ``SLAB_VECS``, one a lane
    over the fewest lanes (a power of two); a row's edge lanes cover twice
    the mean row length, and at least ``MIN_STEP_EDGES``, in one step
    (``UNROLL`` edges a lane), on at most ``MAX_ROW_WARPS`` warps; where
    the rows' warps exceed one wave of the card (8 warps a CTA,
    ``ROW_CTAS_PER_SM`` CTAs an SM), they shrink down to covering half the
    mean row length in one step; the rows take one wave of CTAs, which loop
    over the rest, or as many CTAs as they take where that wave would loop
    more than ``PERSISTENT_LOOPS`` times (measured on an H100: PERF.md
    §6)."""
    wide = 16 // elt
    paired = (2 * wide,) if elt == 4 and c >= PAIRED_VECTOR_COLS else ()
    vec = next(v for v in (*paired, wide, 2, 1)
               if v == 1 or (v * elt <= align and c % v == 0
                             and f % v == 0))
    vpe = c // vec
    n_slabs = -(-vpe // SLAB_VECS)
    per = -(-vpe // n_slabs)
    lpe = _pow2_at_least(per)
    step = max(2 * mean_row_edges, MIN_STEP_EDGES)
    epg = min(32 * MAX_ROW_WARPS // lpe,
              _pow2_at_least(math.ceil(step / UNROLL)))
    ctas = sm_count * ROW_CTAS_PER_SM
    wave = 8 * ctas
    while (epg > 1 and n_rows * n_slabs * lpe * epg > 32 * wave
           and epg // 2 * UNROLL * 2 >= mean_row_edges):
        epg //= 2
    lanes = lpe * epg
    group, row_warps = min(lanes, 32), max(lanes // 32, 1)
    rows_per_cta = 8 * (32 // group) if row_warps == 1 else 8 // row_warps
    needed = -(-n_rows // rows_per_cta)
    return SpmmLayout(vec, lpe, group, row_warps, per, n_slabs,
                      ctas if needed <= PERSISTENT_LOOPS * ctas else 0)


#: pointers (src, idx, w, wperm, row_ptr, long_rows, out), n_rows, c, f,
#: dtype, the layout (vec, lpe, group, row_warps, per, n_slabs, row_ctas),
#: n_long, long_edges, round_w, stream
_ENTRIES = {"gnn_segment_sum": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
            + [ctypes.c_void_p]}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def spmm_args(values: torch.Tensor, senders: Optional[torch.Tensor],
              weight: Optional[torch.Tensor],
              weight_at: Optional[torch.Tensor], round_weight: bool,
              row_ptr: torch.Tensor, long_rows: Optional[torch.Tensor],
              long_edges: int, out: torch.Tensor, n_edges: int, stream: int,
              sm_count: int) -> list:
    """``gnn_segment_sum``'s arguments (``_ENTRIES``) on a card of
    ``sm_count`` SMs; ``n_edges`` (the spanned edges, a host count) sets
    the mean row length."""
    n, c = out.shape
    heads = 1 if weight is None or weight.ndim == 1 else weight.shape[1]
    f = c // heads
    addr = values.data_ptr() | out.data_ptr()
    align = min(addr & -addr, 32) if addr else 32
    lay = spmm_layout(c, f, values.element_size(), n_edges / max(n, 1), n,
                      sm_count, align)
    n_long = 0 if long_rows is None else long_rows.numel()
    return [values.data_ptr(), _ptr(senders), _ptr(weight), _ptr(weight_at),
            row_ptr.data_ptr(), _ptr(long_rows), out.data_ptr(), n, c, f,
            _DTYPE_CODES[values.dtype], *lay.args(), n_long,
            long_edges if n_long else 0, int(round_weight), stream]


def _int32_on(t, device, what, at_least):
    if (t.dtype != torch.int32 or t.device != device or t.ndim != 1
            or not t.is_contiguous() or t.shape[0] < at_least):
        raise ValueError(f"segment_sum: {what} must be a contiguous int32 "
                         f"tensor of at least {at_least} entries on "
                         f"{device}")


def segment_sum(values: torch.Tensor, receivers: torch.Tensor,
                row_ptr: torch.Tensor, n_out: int, *,
                senders: Optional[torch.Tensor] = None,
                weight: Optional[torch.Tensor] = None,
                weight_at: Optional[torch.Tensor] = None,
                round_weight: bool = False,
                n_edges: Optional[int] = None,
                long_rows: Optional[torch.Tensor] = None,
                long_edges: int = 0) -> torch.Tensor:
    """K1 (module docstring). ``n_edges``: the edges that ``row_ptr``
    spans, on the host (default: ``values``' rows, or ``senders``' in the
    gathered form), which sizes the layout; ``long_rows`` (int32, may be
    None): the rows above ``long_edges`` edges, a CTA each. Weights
    come with ``senders`` only."""
    if weight is not None and senders is None:
        raise ValueError("segment_sum: weights need the gathered form")
    if values.device.type == "cpu":
        e = int(row_ptr[-1])
        if senders is not None:
            if weight is not None and weight_at is None:
                weight = weight[:e]
            values = gathered_plain(
                values, senders[:e], weight,
                None if weight_at is None else weight_at[:e], round_weight)
        return segment_sum_plain(values[:e], receivers[:e], n_out)
    device = values.device
    if device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {device}")
    if values.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_sum: values dtype {values.dtype} is not "
                        "float32 or bfloat16")
    if values.ndim != 2 or not values.is_contiguous():
        raise ValueError("segment_sum: values must be a contiguous 2-d "
                         f"tensor, got shape {tuple(values.shape)}")
    if (row_ptr.dtype != torch.int32 or row_ptr.device != device
            or not row_ptr.is_contiguous()
            or row_ptr.shape != (n_out + 1,)):
        raise ValueError("segment_sum: row_ptr must be a contiguous int32 "
                         f"[{n_out + 1}] tensor on {device}")
    if n_edges is None:
        n_edges = values.shape[0] if senders is None else senders.shape[0]
    if senders is not None and senders.numel() == 0:
        # no edge to gather (an empty graph's transpose): the kernel reads
        # no sender, but takes a null pointer for the per-edge form
        senders = torch.zeros(1, dtype=torch.int32, device=device)
    if senders is not None:
        _int32_on(senders, device, "senders", n_edges)
    elif values.shape[0] < n_edges:
        raise ValueError(f"segment_sum: {values.shape[0]} rows of values "
                         f"for {n_edges} edges")
    if weight is not None:
        if weight.dtype == torch.bfloat16:
            weight = weight.float()   # exact
        c = values.shape[1]
        if (weight.dtype != torch.float32 or weight.device != device
                or not weight.is_contiguous() or weight.ndim not in (1, 2)
                or (weight.ndim == 2 and c % weight.shape[1])):
            raise ValueError("segment_sum: weight must be a contiguous "
                             "float32 [E] or [E, H] tensor, H dividing "
                             f"{c}, on {device}")
        if weight_at is not None:
            _int32_on(weight_at, device, "weight_at", n_edges)
        elif weight.shape[0] < n_edges:
            raise ValueError(f"segment_sum: {weight.shape[0]} weights for "
                             f"{n_edges} edges")
    if long_rows is not None:
        _int32_on(long_rows, device, "long_rows", 0)
    if values.numel() >= 2 ** 31:
        raise ValueError("segment_sum: values too large for int32 offsets")
    out = torch.empty(n_out, values.shape[1], dtype=values.dtype,
                      device=device)
    if out.numel() == 0:
        return out
    args = spmm_args(values, senders, weight, weight_at, round_weight,
                     row_ptr, long_rows, long_edges, out, n_edges,
                     torch.cuda.current_stream(device).cuda_stream,
                     sm_count(device.index or 0))
    lib = load("spmm_kernel", _ENTRIES)
    with torch.cuda.device(device):
        err = lib.gnn_segment_sum(*args)
    check(lib, err, "segment_sum kernel launch")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
