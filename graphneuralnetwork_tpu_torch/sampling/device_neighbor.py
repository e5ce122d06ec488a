"""Fanout neighbour sampling on the device (torch).

Port of ``graphneuralnetwork_tpu/sampling/device_neighbor.py``: the padded
neighbour table lives in device memory and each hop is a uniform draw and
a row gather, so a batch's hops never cross from the host. The semantics
are the host sampler's: fanout draws with replacement, uniform over each
node's true neighbours; a node without neighbours repeats itself.

The draws come from an explicit ``torch.Generator`` on the tensors'
device. JAX's threefry keys cannot be reproduced in torch, so the draws
differ from the JAX package's by design (as the dropout masks do); the
table is built on the host and is equal to JAX's array for array.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def build_device_neighbor_table(
    indptr: np.ndarray, indices: np.ndarray,
    max_deg: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR -> ([N, max_deg] int32 padded neighbour table, [N] int32
    degree) on ``device``.

    Rows shorter than ``max_deg`` are padded with the node itself (never
    drawn: a draw is below the degree). ``max_deg`` caps the table for
    degree-skewed graphs: a row above the cap keeps a uniform subsample of
    ``max_deg`` neighbours without replacement, drawn from
    ``default_rng(0)`` row by row in node order, as the JAX package draws
    it.
    """
    n = len(indptr) - 1
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    md = int(deg.max(initial=1)) if max_deg is None else int(max_deg)
    md = max(md, 1)
    table = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, md))
    # the first md entries of every row, scattered at once
    pos = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
    sel = pos < md
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)[sel]
    table[rows, pos[sel]] = indices[sel].astype(np.int32)
    # rows over the cap take a random subsample instead of a truncation
    rng = np.random.default_rng(0)
    for v in np.flatnonzero(deg > md):
        table[v] = rng.choice(indices[indptr[v]:indptr[v + 1]], size=md,
                              replace=False).astype(np.int32)
    device = resolve_device(device)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(np.minimum(deg, md).astype(np.int32)).to(device))


def draw_offsets(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Uniform offsets in [0, max(deg, 1)) from uniforms ``u`` in [0, 1)
    (one row per node, ``deg`` [B, 1]): ``floor(u·d)``, clamped to d - 1,
    because a float32 product of a ``u`` near 1 and a large d can round up
    to d."""
    d = torch.clamp_min(deg, 1)
    return torch.minimum((u * d).long(), (d - 1).long())


def device_sample_neighbors(generator: torch.Generator, nodes: torch.Tensor,
                            table: torch.Tensor, deg: torch.Tensor,
                            fanout: int) -> torch.Tensor:
    """[B * fanout] int32 neighbours drawn with replacement, uniform per
    node."""
    nodes = nodes.long()
    d = deg[nodes][:, None]                                   # [B, 1]
    u = torch.rand((nodes.shape[0], fanout), generator=generator,
                   device=nodes.device)
    nbrs = table[nodes[:, None], draw_offsets(u, d)]          # [B, fanout]
    self_rep = nodes[:, None].to(nbrs.dtype).expand_as(nbrs)
    return torch.where(d > 0, nbrs, self_rep).reshape(-1)


def device_multihop_sampling(generator: torch.Generator, nodes: torch.Tensor,
                             fanouts: Sequence[int], table: torch.Tensor,
                             deg: torch.Tensor) -> List[torch.Tensor]:
    """[hop 0 nodes, hop 1 nodes, ...] int32: hop k has
    B * prod(fanouts[:k]) nodes (``sampling/neighbor.py:multihop_sampling``'s
    contract)."""
    result = [nodes.to(torch.int32)]
    for f in fanouts:
        result.append(device_sample_neighbors(generator, result[-1], table,
                                              deg, f))
    return result


def device_uniform_walks(generator: torch.Generator, starts: torch.Tensor,
                         length: int, table: torch.Tensor,
                         deg: torch.Tensor) -> torch.Tensor:
    """[W, length] int32 uniform random walks on the device: each step is
    one draw and a row gather from the table; a walker at a node without
    neighbours stays there."""
    cur = starts.to(torch.int32)
    steps = [cur]
    for _ in range(length - 1):
        cur = device_sample_neighbors(generator, cur, table, deg, 1)
        steps.append(cur)
    return torch.stack(steps, dim=1)
