"""Optimizers and the warmup → poly(0.9) learning-rate schedule.

Port of ``graphneuralnetwork_tpu/train/schedule.py``:

  * ``adamw`` is ``torch.optim.AdamW`` with optax's defaults (betas 0.9 /
    0.999, eps 1e-8) and decoupled weight decay on every parameter, as
    ``optax.adamw`` applies it;
  * ``sgd`` is ``torch.optim.SGD(momentum, weight_decay)`` — the decay is
    added to the gradient before momentum, as ``add_decayed_weights`` then
    ``optax.sgd`` do — under a ``LambdaLR`` equal to the warmup-poly
    schedule. Step ``t`` (from 0) uses the factor of ``t``, as optax's
    count does, because ``LambdaLR`` sets factor(0) when it is built and
    the loop calls ``scheduler.step()`` after each optimizer step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch


def warmup_poly_factor(step: int, total_steps: int, warmup_steps: int = 0,
                       warmup_factor: float = 1e-3,
                       power: float = 0.9) -> float:
    """Factor of the reference's ``warmup_poly_schedule`` at ``step``:
    linear from ``warmup_factor`` to 1 over ``warmup_steps``, then
    ((1 - p) / (1 - p_warmup)) ** power. Computed in float32 like the
    reference."""
    f32 = np.float32
    step = f32(step)
    warm = f32(max(warmup_steps, 0))
    total = f32(max(total_steps, 1))
    alpha = step / max(warm, f32(1.0)) if warm > 0 else f32(1.0)
    if step < warm:
        return float(f32(warmup_factor) * (f32(1.0) - alpha) + alpha)
    frac = (f32(1.0) - step / total) / max(f32(1.0) - warm / total,
                                            f32(1e-8))
    return float(max(frac, f32(0.0)) ** f32(power))


@dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer recipe; ``build`` binds it to parameters."""

    name: str
    lr: float
    weight_decay: float = 0.0
    total_steps: int = 0
    warmup_steps: int = 0
    momentum: float = 0.0

    def build(self, params: Iterable[torch.nn.Parameter]) -> tuple[
            torch.optim.Optimizer,
            Optional[torch.optim.lr_scheduler.LRScheduler]]:
        if self.name == "adamw":
            return torch.optim.AdamW(
                params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=self.weight_decay), None
        opt = torch.optim.SGD(params, lr=self.lr, momentum=self.momentum,
                              weight_decay=self.weight_decay)
        if self.total_steps <= 0:
            return opt, None
        factor = functools.partial(warmup_poly_factor,
                                   total_steps=self.total_steps,
                                   warmup_steps=self.warmup_steps)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0,
                   total_steps: int = 0, warmup_steps: int = 0,
                   momentum: float = 0.0) -> OptimizerSpec:
    """The reference's optimizers by name: ``"adamw"`` or ``"sgd"`` (SGD +
    warmup-poly when ``total_steps > 0``, else constant lr)."""
    if name not in ("adamw", "sgd"):
        raise ValueError(f"unknown optimizer {name!r} (sgd|adamw)")
    return OptimizerSpec(name, lr, weight_decay, total_steps, warmup_steps,
                         momentum)
