"""Multi-device GAT over the halo-partitioned graph.

Port of ``graphneuralnetwork_tpu/parallel/halo_attention.py``. With
receiver-owned edges the softmax over each node's incoming edges is local
to its owner, so a GAT layer costs one exchange:

  1. each rank: ``h = x_local · W`` and the logits ``f_src``/``f_dst``;
  2. one ``all_to_all`` of the ``[h ‖ f_src]`` rows of boundary senders
     (``halo.exchange``, the same plan ``spmm_halo`` uses);
  3. the rest is local: the edge scores (interior from local rows,
     boundary from the halo slab, tiles as outer sums), the per-receiver
     max (K2 over the edges, K7 over the tiles, both on the detached
     scores), exponentials and denominators (K1), and the numerator (K1's
     gathered form with ``[E, H]`` weights over the interior and the
     boundary edges; the tiles in plain PyTorch, as JAX leaves them to
     XLA).

Attention dropout draws from the caller's ``torch.Generator``: one per
rank, seeded from ``(seed, rank)`` (``rank_generator``), where JAX folds
the mesh axis index into its key. The draws differ from JAX's, as every
device draw of the port does; at rate 0 the layer is exact.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from ..core.bcsr import COL_BLOCK, ROW_BLOCK as TILE_ROWS
from ..ops.aggregate import aggregate_edges, aggregate_gathered, \
    gather_receivers, gather_senders
from ..ops.cuda.attend_common import NEG
from ..ops.cuda.neighbor_max_kernel import neighbor_max
from ..ops.cuda.segment_max_kernel import segment_max
from .halo import HaloGraph, HaloShard, exchange


def rank_generator(seed: int, rank: int,
                   device: str | torch.device) -> torch.Generator:
    """The dropout generator of rank ``rank`` of a run seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(rank)) % 2 ** 63)


def _drop(e: torch.Tensor, keep: float,
          generator: torch.Generator) -> torch.Tensor:
    mask = torch.rand(e.shape, generator=generator, device=e.device) < keep
    return torch.where(mask, e / keep, 0.0)


def gat_halo(hg: HaloGraph, x: torch.Tensor, w: torch.Tensor,
             a_src: torch.Tensor, a_dst: torch.Tensor, *,
             negative_slope: float = 0.2) -> torch.Tensor:
    """One multi-head GAT layer on this rank's rows ``x`` [nps, F_in]:
    ``w`` [F_in, H·F] and ``a_src``/``a_dst`` [H, F] replicated. Returns
    this rank's rows [nps, H·F] (heads concatenated)."""
    n_heads, feat = a_src.shape
    h = (x @ w).reshape(x.shape[0], n_heads, feat)
    hf32 = h.float()
    f_src = torch.einsum("nhf,hf->nh", hf32, a_src)
    f_dst = torch.einsum("nhf,hf->nh", hf32, a_dst)
    return gat_halo_attend(hg, h, f_src, f_dst,
                           negative_slope=negative_slope)


def gat_halo_attend(hg: HaloGraph, h: torch.Tensor, f_src: torch.Tensor,
                    f_dst: torch.Tensor, *, negative_slope: float = 0.2,
                    attn_dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Attention and aggregation given this rank's projections: ``h``
    [nps, H, F], ``f_src``/``f_dst`` [nps, H]. Returns [nps, H·F].

    ``attn_dropout`` drops each edge's softmax numerator (survivors scale
    by ``1/(1-p)``) while the denominator keeps the full mass: dropout on
    α, without materialising it."""
    sh = hg.local
    n_heads, feat = h.shape[1], h.shape[2]
    payload = torch.cat([h.reshape(h.shape[0], n_heads * feat).float(),
                         f_src], dim=1)
    halo = exchange(sh, payload, hg.mesh)
    return attend_local(sh, h, f_src, f_dst, halo,
                        negative_slope=negative_slope,
                        attn_dropout=attn_dropout, generator=generator)


def _check(sh: HaloShard, attn_dropout: float,
           generator: Optional[torch.Generator]) -> None:
    if sh.tiles is not None and not sh.unit_edge_weights:
        # the tiled softmax multiplies exp(S) by the tile values: right only
        # for 0/1 edge indicators, where the COO and boundary edges use
        # their weights as masks
        raise ValueError(
            "gat_halo_attend requires a partition with unit (0/1) tile "
            "weights; this HaloGraph was built with non-binary edge "
            "weights. Build a separate partition_graph_halo(..., "
            "edge_weight=None) for the attention layers.")
    if attn_dropout > 0.0 and generator is None:
        raise ValueError("attn_dropout > 0 requires a generator")


def _edge_scores(graph, f_src_table, f_dst, slope):
    """(LeakyReLU(f_src[senders] + f_dst[receivers]) [E_pad, H], the real
    edges' mask [E_pad, 1]); the gathers' backward is K1."""
    sc = F.leaky_relu(gather_senders(graph, f_src_table)
                      + gather_receivers(graph, f_dst), slope)
    return sc, graph.edge_mask[:, None]


def attend_local(sh: HaloShard, h: torch.Tensor, f_src: torch.Tensor,
                 f_dst: torch.Tensor, halo: torch.Tensor, *,
                 negative_slope: float = 0.2, attn_dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """One rank's attention step given the received slab ``halo``
    [D·H_halo, H·F + H] (``[h ‖ f_src]`` rows of the boundary senders)."""
    _check(sh, attn_dropout, generator)
    nps, n_heads, feat = h.shape
    hf = n_heads * feat
    halo_h = halo[:, :hf].to(h.dtype).reshape(-1, n_heads, feat)
    halo_fs = halo[:, hf:]
    inner, bnd = sh.interior, sh.boundary
    sc_i, mask_i = _edge_scores(inner, f_src, f_dst, negative_slope)
    sc_b, mask_b = _edge_scores(bnd, halo_fs, f_dst, negative_slope)

    # the receiver's max over interior, boundary and tile edges, on the
    # detached scores (the softmax does not depend on it)
    with torch.no_grad():
        m = torch.maximum(
            segment_max(inner, torch.where(mask_i, sc_i, NEG).contiguous()),
            segment_max(bnd, torch.where(mask_b, sc_b, NEG).contiguous()))
        if sh.tiles is not None:
            # max leaky(fd + fs) = leaky(fd + max fs) over tile neighbours
            tnmax = neighbor_max(sh.tiles, f_src.detach().contiguous())
            m_t = F.leaky_relu(f_dst + tnmax, negative_slope)
            m = torch.maximum(m, torch.where(tnmax > NEG / 2, m_t, NEG))
        m = torch.where(m > NEG / 2, m, 0.0)

    # masked before the exponential, so that no padding edge's score
    # overflows into the gradient
    e_i = torch.exp(torch.where(mask_i, sc_i - m[inner.receivers.long()],
                                NEG))
    e_b = torch.exp(torch.where(mask_b, sc_b - m[bnd.receivers.long()],
                                NEG))
    denom = aggregate_edges(inner, e_i) + aggregate_edges(bnd, e_b)
    keep = 1.0 - attn_dropout
    if attn_dropout > 0.0:
        e_i = _drop(e_i, keep, generator)
        e_b = _drop(e_b, keep, generator)
    num = (aggregate_gathered(inner, h.reshape(nps, hf), e_i)
           + aggregate_gathered(bnd, halo_h.reshape(-1, hf), e_b))
    num = num.reshape(nps, n_heads, feat)

    if sh.tiles is not None:
        # the dense tiles: P = W ⊙ exp(S − m) on each tile, S the outer sum
        # f_dst[row] + f_src[col]; a score above the max happens only at
        # float ties with it, where exp(0) = 1 is exact
        bg = sh.tiles
        rows, cols = bg.row_ids.long(), bg.col_ids.long()
        fs_blk = f_src.reshape(nps // COL_BLOCK, COL_BLOCK, n_heads)[cols]
        fd_blk = f_dst.reshape(nps // TILE_ROWS, TILE_ROWS, n_heads)[rows]
        m_blk = m.reshape(nps // TILE_ROWS, TILE_ROWS, n_heads)[rows]
        s_t = F.leaky_relu(fd_blk[:, :, None, :] + fs_blk[:, None, :, :],
                           negative_slope) - m_blk[:, :, None, :]
        p_t = bg.tiles[:, :, :, None] * torch.exp(torch.clamp_max(s_t, 0.0))
        n_rb = nps // TILE_ROWS
        den_t = torch.zeros(n_rb, TILE_ROWS, n_heads, device=h.device)
        denom = denom + den_t.index_add(0, rows, p_t.sum(dim=2)).reshape(
            nps, n_heads)
        if attn_dropout > 0.0:
            p_t = _drop(p_t, keep, generator)
        h_blk = h.reshape(nps // COL_BLOCK, COL_BLOCK, n_heads, feat)[cols]
        num_t = torch.einsum("trch,tchf->trhf", p_t.to(h.dtype), h_blk)
        num_tb = torch.zeros(n_rb, TILE_ROWS, n_heads, feat,
                             dtype=num_t.dtype, device=h.device)
        num = num + num_tb.index_add(0, rows, num_t).reshape(
            nps, n_heads, feat).to(num.dtype)

    denom = torch.clamp_min(denom, 1e-16)
    out = num / denom[:, :, None].to(num.dtype)
    return out.reshape(nps, hf)
