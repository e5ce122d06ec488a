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

On CUDA parameters both take a form that a CUDA graph can capture, with no
host work in a step: ``AdamW(capturable=True)``, and for SGD under the
schedule ``ScheduledSGD`` with ``WarmupPolyTable``, whose step count and
factors (``warmup_poly_factor`` at every step, float32) live on the
device; the update reads ``lr · factors[count]`` there.
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


def warmup_poly_table(total_steps: int, warmup_steps: int = 0,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """float32 ``warmup_poly_factor(t)`` for t = 0 ... max(total_steps,
    warmup_steps); every later step's factor is 0, the last entry's."""
    n = max(total_steps, warmup_steps, 0) + 1
    return torch.tensor([warmup_poly_factor(t, total_steps, warmup_steps)
                         for t in range(n)], dtype=torch.float32,
                        device=device)


def constant_schedule(base_lr: float):
    """The learning rate at every step: ``base_lr`` (``optax``'s
    ``constant_schedule``)."""
    return lambda step: base_lr


class WarmupPolyTable:
    """The warmup-poly schedule as a step count and a table on the device,
    the capturable counterpart of ``LambdaLR(warmup_poly_factor)``:
    ``factor()`` is the current step's factor on the device and
    ``step()`` advances the count, neither with a host read. The count and
    the table are its state (``state_dict``), which checkpoints save."""

    def __init__(self, total_steps: int, warmup_steps: int,
                 device: str | torch.device):
        self.factors = warmup_poly_table(total_steps, warmup_steps, device)
        self.count = torch.zeros(1, dtype=torch.int64, device=device)

    def factor(self) -> torch.Tensor:
        """float32 [1]: the factor of step ``count`` (an index kernel, no
        host read)."""
        return self.factors.index_select(
            0, self.count.clamp(max=len(self.factors) - 1))

    def step(self) -> None:
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count.clone(), "factors": self.factors.clone()}

    def load_state_dict(self, state: dict) -> None:
        """Copies the count in place (a captured step reads it there) and
        takes the saved table."""
        self.count.copy_(state["count"])
        self.factors = state["factors"].to(self.factors.device)


class ScheduledSGD(torch.optim.SGD):
    """``torch.optim.SGD`` (momentum, weight decay added to the gradient
    first) at the learning rate ``lr · schedule.factor()``, a tensor on the
    device: the update takes a tensor learning rate without a host read,
    so a CUDA graph can capture the step. ``param_groups`` keep the base
    ``lr`` as a float. Each operation is ``torch.optim.SGD``'s own on one
    tensor (``param.addcmul_(grad, lr, value=-1)``, its update for a
    tensor ``lr``), so on the CPU the two agree bit for bit."""

    def __init__(self, params, lr: float, momentum: float,
                 weight_decay: float, schedule: WarmupPolyTable):
        super().__init__(params, lr=lr, momentum=momentum,
                         weight_decay=weight_decay)
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduledSGD.step takes no closure")
        factor = self.schedule.factor()
        for group in self.param_groups:
            # in float64, as torch.optim.SGD forms lr from a Python
            # float; the update rounds it to float32 once, as SGD does
            lr = factor.double().squeeze(0) * group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                grad = p.grad
                if group["weight_decay"]:
                    grad = grad.add(p, alpha=group["weight_decay"])
                if group["momentum"]:
                    state = self.state[p]
                    if "momentum_buffer" not in state:   # the first step
                        state["momentum_buffer"] = grad.clone()
                    else:
                        state["momentum_buffer"].mul_(
                            group["momentum"]).add_(grad)
                    grad = state["momentum_buffer"]
                p.addcmul_(grad, lr, value=-1)


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
            Optional[torch.optim.lr_scheduler.LRScheduler
                     | WarmupPolyTable]]:
        """The optimizer and its schedule (None for a constant lr), in
        their capturable forms where the parameters lie on CUDA."""
        params = list(params)
        cuda = params[0].device.type == "cuda"
        if self.name == "adamw":
            return torch.optim.AdamW(
                params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=self.weight_decay, capturable=cuda), None
        if cuda and self.total_steps > 0:
            sched = WarmupPolyTable(self.total_steps, self.warmup_steps,
                                    params[0].device)
            return ScheduledSGD(params, self.lr, self.momentum,
                                self.weight_decay, sched), sched
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
