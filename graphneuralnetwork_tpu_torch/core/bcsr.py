"""Block-compressed sparse row (BCSR) tiles and the hybrid layout.

Port of ``graphneuralnetwork_tpu/core/bcsr.py`` (host numpy build path).
After locality reordering (``core/reorder.py``) most edges of a clustered
graph fall into a few 128x128 (receiver block x sender block) tiles. The
hybrid layout stores those tiles densely and keeps the stragglers as a COO
remainder (a ``Graph``):

  * ``BCSRGraph.tiles[t, i, j]`` is the summed weight of the edges
    ``col_ids[t]*128 + j -> row_ids[t]*128 + i`` (duplicates accumulate, so
    an unweighted tile holds edge counts); tiles are sorted by row block and
    ``tile_off``/``tile_cnt`` give each row block's span;
  * ``HybridGraph`` adds the transpose tiles (``bcsr_t``, the same object
    for a symmetric graph), the receiver-sorted remainder ``rem`` and its
    sender-sorted transpose ``rem_t``, whose ``row_ptr``s the CUDA attend
    kernels walk, and the maps that view the forward dropout masks in the
    transpose layout (``bits_tmap``, ``rem_t_eperm``).

The ``rem_*fine_*`` spans (256-edge chunks per 128-row block) are the TPU
kernels' layout; they are kept so that the arrays compare equal with the
JAX builder. Every array equals the JAX one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .graph import Graph, build_graph, compute_chunk_spans

ROW_BLOCK = 128   # receiver rows per tile
COL_BLOCK = 128   # sender columns per tile
#: Remainder chunk width of the TPU attend kernels (``rem_fine_*`` spans).
ATTEND_CHUNK = 256
#: A row of the attend walk with more edges than this (remainder edges
#: plus nonzero tile slots; K8: remainder edges) is split over the 8 warps
#: of a CTA of its own (``HybridGraph.long_rows``, ``rem_long_rows``);
#: picked on the hub case (PERF.md §6).
LONG_ROW_EDGES = 32


def _tensors_to(obj, device):
    """``obj`` with every tensor or graph field moved to ``device``; a
    field that appears twice (a symmetric graph's tiles) moves once."""
    moved, changes = {}, {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, (torch.Tensor, Graph, BCSRGraph)):
            if id(value) not in moved:
                moved[id(value)] = value.to(device)
            changes[f.name] = moved[id(value)]
    return dataclasses.replace(obj, **changes)


def _pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """int32 [..., 4]: the last axis of 128 booleans as four 32-bit words,
    bit j of word q for entry 32 q + j."""
    bits = flags.reshape(*flags.shape[:-1], 4, 32).long()
    words = (bits << torch.arange(32, device=flags.device)).sum(-1)
    return (words - (words >= 2 ** 31).long() * 2 ** 32).int()


@dataclasses.dataclass(frozen=True)
class BCSRGraph:
    """Row-sorted dense tiles and per-row-block tile spans."""

    tiles: torch.Tensor      # float32 or bfloat16 [T, ROW_BLOCK, COL_BLOCK]
    col_ids: torch.Tensor    # int32[T] sender block of each tile
    row_ids: torch.Tensor    # int32[T] receiver block of each tile
    tile_off: torch.Tensor   # int32[n_row_blocks] first tile of each block
    tile_cnt: torch.Tensor   # int32[n_row_blocks] tiles of each block
    n_nodes: int
    n_edges: int
    n_node_pad: int
    max_tiles: int

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @functools.cached_property
    def slot_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows, cols), int64: the nonzero tile slots as an edge list
        ``cols -> rows``. Built at first use (``torch.nonzero``, a host
        sync) and kept with the graph."""
        t, i, j = torch.nonzero(self.tiles, as_tuple=True)
        return (self.row_ids[t].long() * ROW_BLOCK + i,
                self.col_ids[t].long() * COL_BLOCK + j)

    @functools.cached_property
    def row_masks(self) -> torch.Tensor:
        """int32 [T, ROW_BLOCK, 4]: each tile row's nonzero slots as a
        128-bit set in four words, bit j of word q for column 32 q + j. K3
        and K7 walk these instead of testing the tile values. Built at
        first use and kept with the graph."""
        return _pack_bits(self.tiles != 0)

    @functools.cached_property
    def col_masks(self) -> torch.Tensor:
        """int32 [T, 2, 4]: the columns of each tile that each 64-row half
        names (a nonzero slot in some row of the half), as 128-bit sets in
        four words, bit j of word q for column 32 q + j. K3 and K7 copy
        only those rows of ``x``. Built at first use and kept with the
        graph."""
        named = (self.tiles != 0).view(-1, 2, ROW_BLOCK // 2, COL_BLOCK)
        return _pack_bits(named.any(dim=2))

    def warm(self) -> "BCSRGraph":
        """Build the caches built at first use (``slot_edges``,
        ``row_masks``, ``col_masks``), so that a later use does not sync
        with the host."""
        self.slot_edges, self.row_masks, self.col_masks
        return self

    def to(self, device) -> "BCSRGraph":
        return _tensors_to(self, device)


def build_bcsr(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    dtype: torch.dtype = torch.float32,
    max_bytes: int = 2 << 30,
    device: str | torch.device = "cuda",
) -> BCSRGraph:
    """Group edges into (row block, col block) tiles and densify them, on
    ``device`` (the card unless the caller asks for the CPU).

    Raises ``ValueError`` when the dense tile store would exceed
    ``max_bytes``: a graph without block locality (reorder it first) would
    make one near-empty tile per edge.
    """
    device = resolve_device(device)
    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    n_edges = len(s)
    w = (np.ones(n_edges, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).ravel())

    n_rb = -(-max(n_nodes, 1) // ROW_BLOCK)
    n_cb = -(-max(n_nodes, 1) // COL_BLOCK)
    key = (r // ROW_BLOCK) * n_cb + s // COL_BLOCK
    uniq, tile_of_edge = np.unique(key, return_inverse=True)
    n_tiles = max(len(uniq), 1)
    itemsize = torch.empty((), dtype=dtype).element_size()
    store = n_tiles * ROW_BLOCK * COL_BLOCK * itemsize
    if store > max_bytes:
        fill = n_edges / (n_tiles * ROW_BLOCK * COL_BLOCK)
        raise ValueError(
            f"BCSR tile store would be {store / 1e9:.1f} GB ({n_tiles} "
            f"tiles, fill {fill:.4f}) — the graph lacks block locality; "
            f"reorder with core.reorder.locality_order or keep the COO "
            f"layout")

    tiles = np.zeros((n_tiles, ROW_BLOCK, COL_BLOCK), np.float32)
    np.add.at(tiles, (tile_of_edge, r % ROW_BLOCK, s % COL_BLOCK), w)
    if len(uniq):
        row_ids = (uniq // n_cb).astype(np.int32)
        col_ids = (uniq % n_cb).astype(np.int32)
    else:
        row_ids = col_ids = np.zeros(1, np.int32)
    # np.unique sorts the keys, so the tiles are already row-block sorted
    bounds = np.arange(n_rb + 1) * n_cb
    off = np.searchsorted(uniq if len(uniq) else np.zeros(1), bounds,
                          side="left")
    tile_off = off[:-1].astype(np.int32)
    tile_cnt = (off[1:] - off[:-1]).astype(np.int32)
    return BCSRGraph(
        tiles=torch.from_numpy(tiles).to(dtype),
        col_ids=torch.from_numpy(col_ids),
        row_ids=torch.from_numpy(row_ids),
        tile_off=torch.from_numpy(tile_off),
        tile_cnt=torch.from_numpy(tile_cnt),
        n_nodes=int(n_nodes),
        n_edges=int(n_edges),
        n_node_pad=n_rb * ROW_BLOCK,
        max_tiles=int(max(tile_cnt.max(initial=1), 1)),
    ).to(device)


def build_bcsr_transpose(
    senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
    edge_weight: Optional[np.ndarray] = None, **kw,
) -> BCSRGraph:
    """The tiles of the transposed adjacency (rows are senders)."""
    return build_bcsr(receivers, senders, n_nodes, edge_weight, **kw)


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    """Dense tiles for the well-filled blocks plus a COO remainder.

    ``bits_tmap[t']`` is the forward tile whose edges transpose tile ``t'``
    covers, and ``rem_t_eperm[k]`` the ``rem`` slot of ``rem_t``'s edge
    ``k``: the backward pass over sender rows reads the forward's dropout
    masks through them.
    """

    bcsr: BCSRGraph
    bcsr_t: BCSRGraph            # transpose tiles; same object if symmetric
    rem: Graph                   # receiver-sorted remainder
    rem_fine_off: torch.Tensor   # int32[n_row_blocks]
    rem_fine_cnt: torch.Tensor   # int32[n_row_blocks]
    rem_t: Graph                 # sender-sorted remainder (rows = senders)
    rem_t_fine_off: torch.Tensor
    rem_t_fine_cnt: torch.Tensor
    bits_tmap: torch.Tensor      # int32[T_t]
    rem_t_eperm: torch.Tensor    # int32[E_pad_t]
    rem_fine_max: int
    rem_t_fine_max: int

    @property
    def n_nodes(self) -> int:
        return self.bcsr.n_nodes

    @property
    def n_edges(self) -> int:
        return self.bcsr.n_edges + self.rem.n_edges

    @property
    def tiled_fraction(self) -> float:
        return self.bcsr.n_edges / max(self.n_edges, 1)

    @property
    def symmetric(self) -> bool:
        return self.bcsr_t is self.bcsr

    @property
    def device(self) -> torch.device:
        return self.bcsr.device

    @functools.cached_property
    def row_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """int32 [N] twice: each receiver row's edges in the forward layout
        (its nonzero tile slots, as ``bcsr.row_masks`` holds them, plus its
        remainder edges) and each sender row's in the transpose layout
        (``bcsr_t``, ``rem_t``): the length of the row that K4 and K6 walk.
        Built at first use and kept with the graph."""
        return (_row_edges(self.bcsr, self.rem),
                _row_edges(self.bcsr_t, self.rem_t))

    @functools.cached_property
    def long_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """int32 twice: the rows (ascending) of the forward layout and of
        the transpose layout with more than ``LONG_ROW_EDGES`` edges
        (``row_edges``). K4 and K6 give each such row a CTA of its own.
        Built at first use (a host sync) and kept with the graph."""
        return tuple(torch.nonzero(c > LONG_ROW_EDGES).flatten().int()
                     for c in self.row_edges)

    @functools.cached_property
    def rem_long_rows(self) -> torch.Tensor:
        """int32: the receiver rows (ascending) whose remainder edges alone
        number more than ``LONG_ROW_EDGES`` (``rem.row_ptr``). K8, which
        walks only the remainder, gives each such row a CTA of its own, so
        that a row long only by its tile slots keeps one warp. Built at
        first use (a host sync) and kept with the graph."""
        counts = self.rem.row_ptr[1:] - self.rem.row_ptr[:-1]
        return torch.nonzero(counts > LONG_ROW_EDGES).flatten().int()

    @functools.cached_property
    def mean_counts(self) -> dict:
        """SAGE-mean's divisors ``max(spmm(graph, 1), 1)`` [N, 1] by compute
        dtype: filled by ``nn.conv.SAGEConv`` at its first mean over the
        graph in a dtype (K3 and K1, no host sync, under
        ``graph.mean_weights``) and kept with the graph, so that an epoch
        does not sum the counts again in each aggregation."""
        return {}

    def warm(self) -> "HybridGraph":
        """Build every cache of the graph and of its parts that is built at
        first use with a host sync (the tiles' ``slot_edges`` and masks,
        ``row_edges``, ``long_rows``, ``rem_long_rows``, the remainders'
        ``long_rows``, and ``rem``'s ``transpose``, over which K1 sums
        its gathers' backward; ``rem_t`` is walked by K6 alone and needs
        none): a CUDA graph's capture cannot sync, so the captured epoch
        block calls this before it captures, whichever paths its warm-up
        epoch takes."""
        self.bcsr.warm()
        self.bcsr_t.warm()
        self.rem.warm()
        self.rem_t.long_rows
        self.row_edges, self.long_rows, self.rem_long_rows
        return self

    def to(self, device) -> "HybridGraph":
        return _tensors_to(self, device)


def _row_edges(bg: BCSRGraph, rem: Graph) -> torch.Tensor:
    """int32 [N]: each row's nonzero tile slots plus its remainder edges."""
    n = bg.n_nodes
    rows = (bg.row_ids.long()[:, None] * ROW_BLOCK
            + torch.arange(ROW_BLOCK, device=bg.device)).flatten()
    slots = torch.zeros(bg.n_node_pad, dtype=torch.int64, device=bg.device)
    slots.index_add_(0, rows, (bg.tiles != 0).sum(-1).flatten())
    return (slots[:n] + (rem.row_ptr[1:] - rem.row_ptr[:-1])).int()


def build_hybrid(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    min_edges_per_tile: int = 192,
    symmetric: bool = False,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> HybridGraph:
    """Split edges by tile fill: tiles holding >= ``min_edges_per_tile``
    edges are densified (in ``dtype``), the rest stay COO. With
    ``symmetric=True`` the forward tiles double as the transpose (valid for
    a symmetric adjacency: tiles (i, j) and (j, i) hold equal counts)."""
    device = resolve_device(device)
    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    w = (np.ones(len(s), np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).ravel())

    n_cb = -(-max(n_nodes, 1) // COL_BLOCK)
    key = (r // ROW_BLOCK) * n_cb + (s // COL_BLOCK)
    _, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    dense = cnt[inv] >= min_edges_per_tile

    bg = build_bcsr(s[dense], r[dense], n_nodes, w[dense], dtype=dtype,
                    device="cpu")
    bg_t = (bg if symmetric else
            build_bcsr_transpose(s[dense], r[dense], n_nodes, w[dense],
                                 dtype=dtype, device="cpu"))
    sub_s, sub_r = s[~dense], r[~dense]
    rem = build_graph(sub_s.astype(np.int32), sub_r.astype(np.int32),
                      n_nodes, w[~dense], device="cpu")
    rem_t = build_graph(sub_r.astype(np.int32), sub_s.astype(np.int32),
                        n_nodes, w[~dense], device="cpu")
    f_off, f_cnt, f_max = compute_chunk_spans(
        rem.receivers.numpy(), n_nodes, chunk=ATTEND_CHUNK)
    ft_off, ft_cnt, ft_max = compute_chunk_spans(
        rem_t.receivers.numpy(), n_nodes, chunk=ATTEND_CHUNK)

    # transpose tile (sb, rb) covers forward tile (rb, sb)
    fkeys = bg.row_ids.numpy().astype(np.int64) * n_cb + bg.col_ids.numpy()
    tkeys = (bg_t.col_ids.numpy().astype(np.int64) * n_cb
             + bg_t.row_ids.numpy())
    bits_tmap = np.minimum(np.searchsorted(fkeys, tkeys),
                           len(fkeys) - 1).astype(np.int32)
    # both remainders sort the same subset stably: composing the two
    # argsorts matches the slots edge by edge
    order_r = np.argsort(sub_r, kind="stable")
    order_s = np.argsort(sub_s, kind="stable")
    inv_r = np.empty(len(order_r), np.int64)
    inv_r[order_r] = np.arange(len(order_r))
    eperm = np.zeros(rem_t.n_edge_pad, np.int32)
    eperm[:len(order_s)] = inv_r[order_s]
    return HybridGraph(
        bcsr=bg, bcsr_t=bg_t, rem=rem,
        rem_fine_off=torch.from_numpy(f_off),
        rem_fine_cnt=torch.from_numpy(f_cnt),
        rem_t=rem_t,
        rem_t_fine_off=torch.from_numpy(ft_off),
        rem_t_fine_cnt=torch.from_numpy(ft_cnt),
        bits_tmap=torch.from_numpy(bits_tmap),
        rem_t_eperm=torch.from_numpy(eperm),
        rem_fine_max=int(f_max),
        rem_t_fine_max=int(ft_max),
    ).to(device)
