"""What the hybrid attend kernels K4-K6 and K8-K10 and their plain versions
share.

The dropout hash (``head_keep``) and its constants, the edge lists that the
plain versions build from the hybrid layout, the softmax partials over such
a list (``softmax_parts``), the checks and launch arguments of the
wrappers, and the column layout of the kernels' row walk
(``attend_layout``, ``csrc/attend_walk.cuh``). Pure PyTorch: nothing here
builds or loads a kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ...core.bcsr import (COL_BLOCK, LONG_ROW_EDGES, ROW_BLOCK, BCSRGraph,
                          HybridGraph)

NEG = -1e30  # "-inf" stand-in that survives float32 arithmetic
_MASK32 = 0xFFFFFFFF
#: Elements of a per-edge [E, H*F] temporary of the plain versions.
PLAIN_CHUNK_ELEMENTS = 1 << 26
#: The row walk of K4-K6 and K8-K10 (``csrc/attend_walk.cuh``): heads of
#: a slab at most (``kSlabHeads``), vectors a lane holds at most, columns a
#: lane holds at most.
SLAB_HEADS = 8
MAX_VECS_PER_LANE = 4
MAX_COLS_PER_LANE = 16
#: Scalars a lane of K5 holds at most for a head wider than
#: ``MAX_VECS_PER_LANE`` scalars a lane cover, before the head splits into
#: parts: K5 walks a head's parts within each batch, so each part gathers
#: the batch's edges again (on an H100 one head of 251 scalars took 26.1 µs
#: in two parts of four a lane and 24.2 in one part of eight: PERF.md §6).
WIDE_SCALARS_PER_LANE = 8
#: 16-byte vectors a lane holds at most, by element size: four of float32,
#: one of bfloat16 (at 8 heads x 128 on an H100 a bfloat16 lane holding two
#: took 17 % longer in K4 and 24 % in K6, a float32 lane holding two in
#: place of four 44 % and 22 %: PERF.md §6).
VECS_PER_LANE = {4: 4, 2: 1}


def head_mul(h: int) -> int:
    """Odd multiplier that decorrelates head ``h``'s dropout stream."""
    return (0x9E3779B1 * (2 * h + 1)) & _MASK32


def keep_thresh(keep_prob: float) -> int:
    """uint32 threshold: a hashed word below it keeps its slot."""
    return min(int(round(keep_prob * 2.0 ** 32)), 2 ** 32 - 1)


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """``(v * c) mod 2^32`` for int64 ``v`` in [0, 2^32): split into 16-bit
    halves so that no product leaves int64."""
    lo = (v & 0xFFFF) * c
    hi = ((v >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def head_keep(bits: torch.Tensor, h: int, keep_prob: float) -> torch.Tensor:
    """Per-head Bernoulli(``keep_prob``) from the shared uint32 lattice
    (stored as int32 with the same bits): bit-equal to the JAX package's
    ``_head_keep``. Computed in int64 masked to 32 bits, because torch's
    int32 ``>>`` is arithmetic."""
    v = _mul32(bits.to(torch.int64) & _MASK32, head_mul(h))
    v = v ^ (v >> 13)
    v = _mul32(v, 0x5BD1E995)
    v = v ^ (v >> 15)
    return v < keep_thresh(keep_prob)


def keep_factors(bits: torch.Tensor, heads: int,
                 keep_prob: float) -> torch.Tensor:
    """[E, H] numerator multiplier of tile slots with lattice words
    ``bits`` [E]: ``1 / keep_prob`` where ``head_keep`` keeps, else 0."""
    keep = torch.stack([head_keep(bits, h, keep_prob)
                        for h in range(heads)], dim=1)
    return keep.float() * (1.0 / keep_prob)


def leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v > 0, v, slope * v)


def leaky_grad(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v > 0, 1.0, slope)


def tile_slots(bg: BCSRGraph):
    """Every nonzero tile slot as (tile, i, j, row node, col node, weight);
    a slot's row is ``row_ids[t]*128 + i`` and its col ``col_ids[t]*128+j``
    (receiver and sender for the forward tiles, the other way round for the
    transpose tiles)."""
    t, i, j = torch.nonzero(bg.tiles, as_tuple=True)
    rows = bg.row_ids[t].long() * ROW_BLOCK + i
    cols = bg.col_ids[t].long() * COL_BLOCK + j
    return t, i, j, rows, cols, bg.tiles[t, i, j].float()


def edge_chunks(n_edges: int, width: int) -> Iterator[slice]:
    """Slices of the edge list that bound a per-edge [chunk, width]
    temporary to ``PLAIN_CHUNK_ELEMENTS``."""
    step = max(PLAIN_CHUNK_ELEMENTS // max(width, 1), 1)
    for lo in range(0, n_edges, step):
        yield slice(lo, min(lo + step, n_edges))


def tile_edges(hg: HybridGraph, bits: Optional[torch.Tensor], heads: int,
               keep_prob: float):
    """The forward tiles' nonzero slots as an edge list: (receivers,
    senders, weights, numerator multiplier [E, H] or None)."""
    t, i, j, recv, send, w = tile_slots(hg.bcsr)
    keep = (keep_factors(bits[t, i, j], heads, keep_prob)
            if keep_prob < 1.0 else None)
    return recv, send, w, keep


def rem_edges(hg: HybridGraph, keep_mul: Optional[torch.Tensor]):
    """The remainder's real edges: (receivers, senders, weights, numerator
    multiplier [E, H] or None)."""
    rem = hg.rem
    e = rem.n_edges
    return (rem.receivers[:e].long(), rem.senders[:e].long(),
            rem.edge_weight[:e], None if keep_mul is None else keep_mul[:e])


def softmax_weights(recv: torch.Tensor, send: torch.Tensor, w: torch.Tensor,
                    f_src: torch.Tensor, f_dst: torch.Tensor, m: torch.Tensor,
                    slope: float) -> torch.Tensor:
    """``p = w * exp(min(LeakyReLU(f_dst[r] + f_src[s]) - m[r], 0))`` per
    edge ``s -> r`` and head, [E, H]."""
    score = leaky(f_dst[recv] + f_src[send], slope)
    return w[:, None] * torch.exp(torch.clamp_max(score - m[recv], 0.0))


def softmax_parts(recv: torch.Tensor, send: torch.Tensor, w: torch.Tensor,
                  keep: Optional[torch.Tensor], x: torch.Tensor,
                  f_src: torch.Tensor, f_dst: torch.Tensor, m: torch.Tensor,
                  slope: float, num: Optional[torch.Tensor] = None,
                  den: Optional[torch.Tensor] = None):
    """The softmax partials over the edges ``send -> recv`` given the shift
    ``m``: ``p = w * exp(min(LeakyReLU(f_dst[r] + f_src[s]) - m[r], 0))``,
    ``den[r] += p`` and ``num[r] += p * keep * x[s]``, in float32, the
    per-edge rows in chunks. ``num`` [N, H, F] and ``den`` [N, H] start
    from zero unless given (then they are added to in place)."""
    n, hf = x.shape
    heads = f_src.shape[1]
    feat = hf // heads
    if num is None:
        num = torch.zeros(n, heads, feat, dtype=torch.float32,
                          device=x.device)
    if den is None:
        den = torch.zeros(n, heads, dtype=torch.float32, device=x.device)
    p = softmax_weights(recv, send, w, f_src, f_dst, m, slope)
    den.index_add_(0, recv, p)
    pn = p if keep is None else p * keep
    for sl in edge_chunks(recv.shape[0], hf):
        vals = pn[sl, :, None] * x[send[sl]].float().view(-1, heads, feat)
        num.index_add_(0, recv[sl], vals)
    return num, den


@dataclasses.dataclass(frozen=True)
class AttendLayout:
    """The column layout of the row walk (K4-K6, K8-K10): vectors of ``vec``
    elements (16 bytes, or 1 element where the head width or the address
    does not allow 16), ``nv`` of them a lane, ``lpe`` lanes an edge (32 /
    ``lpe`` edges at a time); slabs of ``slab_heads`` whole heads or, with
    ``parts > 1``, one head in ``parts`` slabs; ``n_slabs`` slabs a row (the
    grid's second dimension)."""

    vec: int
    nv: int
    lpe: int
    slab_heads: int
    parts: int
    n_slabs: int

    def args(self) -> list:
        return [self.vec, self.nv, self.lpe, self.slab_heads]


def attend_layout(heads: int, feat: int, itemsize: int,
                  aligned: bool = True,
                  wide_scalars: int = MAX_VECS_PER_LANE) -> AttendLayout:
    """The slab rule: a slab holds as many whole heads as a warp's 32 lanes
    hold at ``VECS_PER_LANE`` 16-byte vectors (or ``MAX_VECS_PER_LANE``
    scalars) each, at most ``MAX_COLS_PER_LANE`` columns (and at most
    ``SLAB_HEADS`` heads); a head wider than that takes up to
    ``MAX_VECS_PER_LANE`` vectors (or ``wide_scalars`` scalars: K5's
    ``WIDE_SCALARS_PER_LANE``) a lane, and a head wider than those hold
    splits into equal parts. A slab of up to 32
    vectors takes one vector a lane and the smallest power of two of lanes
    an edge that covers it; a wider one all 32 lanes and the fewest vectors
    a lane. ``aligned``: every row operand's address is a multiple of 16
    bytes (else ``vec`` is 1)."""
    full = 16 // itemsize
    vec = full if feat % full == 0 and aligned else 1
    vph = feat // vec
    vecs = VECS_PER_LANE[itemsize] if vec > 1 else MAX_VECS_PER_LANE
    width = 32 * min(vecs, MAX_COLS_PER_LANE // vec)
    if vph > width:   # a head wider than that: as many as 16 columns hold
        width = 32 * min(MAX_VECS_PER_LANE if vec > 1 else wide_scalars,
                         MAX_COLS_PER_LANE // vec)
    if vph <= width:
        slab_heads = max(1, min(heads, SLAB_HEADS, width // vph))
        parts = 1
        vecs = slab_heads * vph
    else:
        slab_heads = 1
        parts = -(-vph // width)
        vecs = -(-vph // parts)
    if vecs <= 32:
        nv, lpe = 1, 1 << (vecs - 1).bit_length()
    else:
        nv, lpe = 1 << (-(-vecs // 32) - 1).bit_length(), 32
    n_slabs = heads * parts if parts > 1 else -(-heads // slab_heads)
    return AttendLayout(vec, nv, lpe, slab_heads, parts, n_slabs)


def walk_layout(heads: int, x: torch.Tensor, *rows: torch.Tensor,
                wide_scalars: int = MAX_VECS_PER_LANE) -> AttendLayout:
    """``attend_layout`` for ``x`` and the other [N, H*F] operands of one
    call (their addresses decide the vector width)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *rows))
    return attend_layout(heads, x.shape[1] // heads, x.element_size(),
                         aligned, wide_scalars)


def check_operands(name: str, hg: HybridGraph, x: torch.Tensor,
                   heads: int, bits: Optional[torch.Tensor],
                   keep_mul: Optional[torch.Tensor], dropping: bool,
                   masks: tuple[str, ...] = ("bits", "keep_mul"),
                   **node_arrays: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take. Under dropout the
    kernel reads the masks named in ``masks``: the tiles' lattice
    (``bits``), the remainder's multiplier (``keep_mul``) or both."""
    n = hg.n_nodes
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x dtype {x.dtype} is not float32 or "
                        "bfloat16")
    if x.ndim != 2 or x.shape[0] != n or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [{n}, H*F] "
                         f"tensor, got {tuple(x.shape)}")
    if not 1 <= heads <= 32 or x.shape[1] % heads:
        raise ValueError(f"{name}: {heads} heads do not divide "
                         f"{x.shape[1]} columns (at most 32 heads)")
    if hg.device != x.device:
        raise ValueError(f"{name}: graph on {hg.device}, x on {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: x too large for int32 offsets")
    for key, arr in node_arrays.items():
        want = x.dtype if key == "gn" else torch.float32
        if (arr.dtype != want or arr.device != x.device
                or arr.shape[0] != n or not arr.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous {want} "
                             f"[{n}, ...] tensor on {x.device}")
    for bg in (hg.bcsr, hg.bcsr_t):
        if bg.tiles.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: tile dtype {bg.tiles.dtype}")
    if not dropping:
        return
    if "bits" in masks:
        if bits is None:
            raise ValueError(f"{name}: dropout needs bits")
        if (bits.dtype != torch.int32 or bits.device != x.device
                or bits.shape != hg.bcsr.tiles.shape
                or not bits.is_contiguous()):
            raise ValueError(f"{name}: bits must be a contiguous int32 "
                             f"{tuple(hg.bcsr.tiles.shape)} tensor")
    if "keep_mul" in masks:
        if keep_mul is None:
            raise ValueError(f"{name}: dropout needs keep_mul")
        if (keep_mul.dtype != torch.float32 or keep_mul.device != x.device
                or keep_mul.shape != (hg.rem.n_edge_pad, heads)
                or not keep_mul.is_contiguous()):
            raise ValueError(f"{name}: keep_mul must be a contiguous "
                             f"float32 [{hg.rem.n_edge_pad}, {heads}] "
                             "tensor")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


#: ctypes argument types of ``scalar_args``: n, heads, feat, x_bf16,
#: tile_bf16, then the trailing slope, inv_keep, thresh, dropping, stream
#: (the entries take the column layout between the two).
SCALAR_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float,
                                        ctypes.c_uint32, ctypes.c_int,
                                        ctypes.c_void_p]


def cuda_stream(x: torch.Tensor) -> int:
    """The handle of the current stream of ``x``'s card."""
    return torch.cuda.current_stream(x.device).cuda_stream


def scalar_args(x: torch.Tensor, tiles: torch.Tensor, heads: int,
                slope: float, keep_prob: float, dropping: bool,
                stream: int) -> list:
    """The scalars of ``SCALAR_ARGTYPES``."""
    n, hf = x.shape
    return [n, heads, hf // heads, int(x.dtype == torch.bfloat16),
            int(tiles.dtype == torch.bfloat16), float(slope),
            float(np.float32(1.0 / keep_prob)),
            keep_thresh(keep_prob) if dropping else 0, int(dropping), stream]
