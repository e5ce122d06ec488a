"""The dropout multipliers of the program's first steps, drawn again for the
reference.

The program draws its dropout from one generator (``TrainState.generator``)
in the order of its forward pass. Before each checked step the benchmark
records that generator's state; here a generator set to it draws the same
values again, through the same calls, and the values are mapped to the
reference's order: node rows back to the generated ids (the hybrid layout
renumbers them), and per-edge values to the canonical edge order of
``reference.gnn.Edges``. The mapping reads the program's layout (its
renumbering, its edge order, its tiles); the masks themselves are checked
on their own (``keep_z``: each keep share against its probability;
``edge_cover``: every canonical edge masked exactly once).
"""

from __future__ import annotations

import math

import torch

from graphneuralnetwork_tpu_torch.ops.bcsr_attention import draw_dropout
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import (rem_edges,
                                                                 tile_edges)

from . import spec


class MaskReplay:
    """Draws one step's masks from a recorded generator state.

    ``graph`` is the program's graph (a ``Graph`` or ``HybridGraph``),
    ``perm`` its renumbering (``perm[new] = old``; None on the COO
    layout), ``keys`` the canonical edge keys (``receiver * n + sender``,
    ascending)."""

    def __init__(self, cfg: dict, graph, perm, keys: torch.Tensor,
                 device):
        self.cfg, self.graph, self.keys = cfg, graph, keys
        self.device = device
        self.n = int(graph.n_nodes)
        self.perm = (None if perm is None else
                     torch.as_tensor(perm, dtype=torch.int64, device=device))
        self.z = 0.0            # the largest keep-share deviation, in sigmas
        self.uncovered = 0      # canonical edges not masked exactly once

    def _keep(self, keep: torch.Tensor, p: float) -> None:
        count = keep.numel()
        share = float(keep.float().mean())
        self.z = max(self.z, abs(share - p) / math.sqrt(p * (1 - p) / count))

    def nodes(self, gen, width: int, rate: float) -> torch.Tensor:
        """``nn.conv.dropout``'s draw: keep where ``rand < 1 - rate``."""
        p = 1.0 - rate
        keep = torch.rand((self.n, width), generator=gen,
                          device=self.device) < p
        self._keep(keep, p)
        mult = keep.float() / p
        if self.perm is None:
            return mult
        out = torch.empty_like(mult)
        out[self.perm] = mult
        return out

    def _to_canonical(self, recv, send, mult) -> torch.Tensor:
        """Per-edge multipliers in program ids -> canonical order."""
        recv, send = recv.long(), send.long()
        if self.perm is not None:
            recv, send = self.perm[recv], self.perm[send]
        pos = torch.searchsorted(self.keys, recv * self.n + send)
        pos = pos.clamp(max=self.keys.shape[0] - 1)
        hit = self.keys[pos] == recv * self.n + send
        counts = torch.bincount(pos[hit], minlength=self.keys.shape[0])
        self.uncovered += int((counts != 1).sum()) + int((~hit).sum())
        out = mult.new_zeros((self.keys.shape[0], mult.shape[1]))
        out[pos[hit]] = mult[hit]
        return out

    def edges(self, gen, heads: int, rate: float) -> torch.Tensor:
        p = 1.0 - rate
        g = self.graph
        if hasattr(g, "bcsr"):
            bits, keep_mul = draw_dropout(g, heads, p, gen)
            t_recv, t_send, _, t_mult = tile_edges(g, bits, heads, p)
            r_recv, r_send, _, r_mult = rem_edges(g, keep_mul)
            mult = torch.cat([t_mult, r_mult])
            self._keep(mult > 0, p)
            return self._to_canonical(torch.cat([t_recv, r_recv]),
                                      torch.cat([t_send, r_send]), mult)
        keep = torch.rand((g.n_edge_pad, heads), generator=gen,
                          device=self.device) < p
        e = g.n_edges
        self._keep(keep[:e], p)
        return self._to_canonical(g.receivers[:e], g.senders[:e],
                                  keep[:e].float() / p)

    def step(self, state: torch.Tensor, generator_device) -> dict:
        """The masks of one training step, drawn from ``state`` in the
        order of the model's forward (``models/<model>.py``)."""
        gen = torch.Generator(device=generator_device)
        gen.set_state(state)
        return spec.part("models", self.cfg["model"]).replay_masks(
            self, gen, self.cfg)
