"""The work split of K3 and K7 (``csrc/tile_walk.cuh``), chosen on the host.

A work item is ``rows`` rows of one 128-row block (128, or a 64-row half)
times one slab of ``slab`` columns (4 ... 128); a CTA (512 threads for the
walk, 256 for the tensor-core product) takes items in turn and, per tile,
stages the tile's rows and the 128-row block of ``x`` in one stage of a ring
in shared memory (as many stages as fit, 2 to 8), so the slab is capped by
what two stages take:

  * the walk (float32 ``x``: K3 in float32, K7): per stage ``rows`` tile
    rows of 128 values (K7 stages none: its ``tile_size`` is 0), their
    nonzero masks (16 bytes a row) and 128 ``x`` rows of ``slab`` floats;
  * the tensor-core product (bfloat16 ``x``, K3): the same with every
    shared row padded by 8 values and no masks, and a slab of at least 16
    (two warps of 8 columns each).

``smem_bytes`` mirrors the C side's ``WalkRing`` and ``MmaRing``, which the
tests here check without a compiler; a shape whose two stages do not fit
there makes the launch fail, not fall back.

The rule (``tile_grid``): the slab is the smallest power of two from 4 that
covers the width, capped at the largest that fits; the rows are a whole
block unless the row blocks times the slabs give fewer items than the card
has SMs, and then a half (with its own slab); where the halves still leave
SMs idle, the slab is halved, down to 32 columns, as long as the items
still fit on the SMs at once.
"""

from __future__ import annotations

import functools

import torch

from ...core.bcsr import COL_BLOCK

ROWS = (128, 64)
SLABS = (4, 8, 16, 32, 64, 128)
STAGES = 2
PAD = 8
#: Bytes ahead of the ring: the stages' mbarriers.
BAR_BYTES = 128
#: The narrowest slab that ``tile_grid`` takes to add items.
MIN_SPLIT_SLAB = 32
#: A CTA's dynamic shared memory limit on Hopper (232,448 bytes).
MAX_SMEM = 227 * 1024


def smem_bytes(rows: int, slab: int, tile_size: int, mma: bool) -> int:
    """Dynamic shared memory of a CTA's ring at its least, two stages
    (``tile_walk.cuh``'s ``WalkRing``, ``bcsr_spmm_kernel.cu``'s
    ``MmaRing``); ``tile_size`` is the element size of the staged tile
    values, 0 where none are staged (K7)."""
    if mma:
        return BAR_BYTES + STAGES * (rows * (COL_BLOCK + PAD) * tile_size
                                     + COL_BLOCK * (slab + PAD) * 2)
    return BAR_BYTES + STAGES * (rows * COL_BLOCK * tile_size + rows * 16
                                 + COL_BLOCK * slab * 4)


def slab_width(width: int, rows: int, tile_size: int, mma: bool) -> int:
    fits = [s for s in SLABS if (s >= 16 or not mma)
            and smem_bytes(rows, s, tile_size, mma) <= MAX_SMEM]
    return next((s for s in fits if s >= width), fits[-1])


@functools.lru_cache(maxsize=None)
def tile_grid(n_row_blocks: int, width: int, n_sms: int, tile_size: int,
              mma: bool) -> tuple[int, int, int]:
    """(rows, slab, items) for ``n_row_blocks`` row blocks of ``width``
    columns on a card with ``n_sms`` SMs."""
    def items(rows, slab):
        return n_row_blocks * (COL_BLOCK // rows) * -(-width // slab)

    for rows in ROWS:
        slab = slab_width(width, rows, tile_size, mma)
        if items(rows, slab) >= n_sms:
            return rows, slab, items(rows, slab)
    while slab > MIN_SPLIT_SLAB and items(rows, slab // 2) <= n_sms:
        slab //= 2
    return rows, slab, items(rows, slab)


def copy_bytes(x: torch.Tensor) -> int:
    """The largest chunk (16, 8, 4 or 2 bytes) that divides both the byte
    width of a row of the 2-D ``x`` and its address: every chunk of a row
    then lies wholly inside the row. 16: the slab of each row lands by one
    bulk copy (``cp.async.bulk``); 8 and 4: by ``cp.async`` chunks; 2
    (bfloat16 at an odd width): through registers."""
    row = x.shape[1] * x.element_size()
    return next(g for g in (16, 8, 4, 2)
                if row % g == 0 and x.data_ptr() % g == 0)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(n_row_blocks: int, x: torch.Tensor, tile_size: int,
                 mma: bool) -> tuple[int, int, int]:
    """(rows, slab, copy bytes) of a launch on ``x``'s card; ``tile_size``
    as for ``smem_bytes``."""
    rows, slab, _ = tile_grid(n_row_blocks, x.shape[1],
                              sm_count(x.device.index or 0), tile_size, mma)
    return rows, slab, copy_bytes(x)
