"""The plain training steps that decide ``correct``: AdamW steps of a
model in plain PyTorch, each followed by the val forward, either each
from the state the step before left (``train_steps``) or each from another
run's state before that step (``follow``). Each model's forward,
parameters and dropout sites are ``reference/<model>.py``, found by the
configuration's ``model``. It imports nothing of the program. From the
program it takes the dropout multipliers of each step, which the
benchmark draws again from the program's random stream
(``benchmark/masks.py``), and, when it follows the program, the
parameters and moments the program held before each step after the
first. The loss is the mean softmax cross-entropy over
the training rows; AdamW is PyTorch's (decoupled weight decay). Float32
throughout: the caller sets TF32 off (``tf32=False``), or on for the
control.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.nn import functional as F

from benchmark import spec


@dataclasses.dataclass(frozen=True)
class Edges:
    """The symmetrised edges with one self loop a node, sorted by
    (receiver, sender): the canonical order of every per-edge mask."""

    recv: torch.Tensor   # int64 [E]
    send: torch.Tensor   # int64 [E]
    n: int

    @property
    def keys(self) -> torch.Tensor:
        return self.recv * self.n + self.send


def canonical_edges(senders: np.ndarray, receivers: np.ndarray, n: int,
                    device) -> Edges:
    s = np.concatenate([senders, receivers, np.arange(n)]).astype(np.int64)
    r = np.concatenate([receivers, senders, np.arange(n)]).astype(np.int64)
    keys = np.unique(r * n + s)
    keys_t = torch.from_numpy(keys).to(device)
    return Edges(keys_t // n, keys_t % n, n)


def aggregate(edges: Edges, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_(s -> r) w · x[s]``; ``w`` [E] or [E, H] with ``x``
    [N, H, F]."""
    msg = x[edges.send] * (w[:, None] if w.ndim == 1 else w[..., None])
    return x.new_zeros((edges.n,) + x.shape[1:]).index_add_(0, edges.recv,
                                                            msg)


def model(cfg: dict):
    """The configuration's model, ``reference/<model>.py``."""
    return spec.part("reference", cfg["model"])


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits[idx], labels[idx])


def initial_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The parameters both sides start from, by the port's names: each
    weight glorot-uniform (``U(-l, l)``, ``l = sqrt(6 / fan)``) from one
    draw on ``device``, biases zero."""
    shapes = model(cfg).params(cfg)
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    params, at = {}, 0
    for name, (shape, fan) in shapes.items():
        k = math.prod(shape)
        if fan:
            params[name] = (draw[at:at + k].view(shape)
                            * math.sqrt(6.0 / fan)).clone()
        else:
            params[name] = torch.zeros(shape, device=device)
        at += k
    return params


@dataclasses.dataclass
class State:
    """The parameters and AdamW's two moments before a step."""

    params: dict[str, torch.Tensor]
    m1: dict[str, torch.Tensor]
    m2: dict[str, torch.Tensor]


def start_state(params0: dict) -> State:
    """``params0`` with both moments zero: the state before step 1."""
    return State({k: v.detach().clone() for k, v in params0.items()},
                 {k: torch.zeros_like(v) for k, v in params0.items()},
                 {k: torch.zeros_like(v) for k, v in params0.items()})


@dataclasses.dataclass
class Readings:
    """What a training run gives for the comparison: each step's loss, the
    val loss after it, its gradient and its change of the parameters per
    leaf, and the state before each step and after the last."""

    losses: list[float]
    val_losses: list[float]
    grads: list[dict[str, torch.Tensor]]
    steps: list[dict[str, torch.Tensor]]
    states: list[State]


def train_steps(cfg: dict, params0: dict, x: torch.Tensor,
                labels: torch.Tensor, train_idx: torch.Tensor,
                val_idx: torch.Tensor, edges: Edges, masks: list[dict],
                tf32: bool = False, half_batch: bool = False) -> Readings:
    """``len(masks)`` AdamW steps from ``params0``, each from the state the
    one before left, each followed by the val forward. ``half_batch`` is
    a planted fault: the loss over the first half of the training rows
    only."""
    return _run(cfg, None, start_state(params0), x, labels, train_idx,
                val_idx, edges, masks, tf32, half_batch)


def follow(cfg: dict, states: list[State], x: torch.Tensor,
           labels: torch.Tensor, train_idx: torch.Tensor,
           val_idx: torch.Tensor, edges: Edges, masks: list[dict]
           ) -> Readings:
    """Another run's steps done again: step ``t`` from that run's state
    before it (``states[t - 1]``), each followed by the val forward of the
    parameters this step made, so that each step is judged alone."""
    return _run(cfg, states, None, x, labels, train_idx, val_idx, edges,
                masks, False, False)


def _run(cfg, states, own, x, labels, train_idx, val_idx, edges, masks,
         tf32, half_batch) -> Readings:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        step_idx = (train_idx[:train_idx.shape[0] // 2] if half_batch
                    else train_idx)
        out = Readings([], [], [], [], [own] if own is not None else [])
        for t, mask in enumerate(masks, start=1):
            before = states[t - 1] if states is not None else own
            loss, grads, own = _step(cfg, before, t, x, labels, step_idx,
                                     edges, mask)
            out.losses.append(loss)
            out.grads.append(grads)
            out.steps.append({k: own.params[k] - before.params[k]
                              for k in own.params})
            out.val_losses.append(float(loss_fn(
                model(cfg).forward(cfg, own.params, x, edges, None),
                labels, val_idx)))
            if states is None:
                out.states.append(own)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _step(cfg, before: State, t: int, x, labels, step_idx, edges, mask
          ) -> tuple[float, dict, State]:
    """One AdamW step (PyTorch's, decoupled decay) from ``before``: the
    loss, the gradient per leaf and the state after it."""
    opt = cfg["optimizer"]
    lr, wd, eps = opt["lr"], opt["weight_decay"], opt["eps"]
    b1, b2 = opt["betas"]
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in before.params.items()}
    loss = loss_fn(model(cfg).forward(cfg, leaves, x, edges, mask), labels,
                   step_idx)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    after = State({}, {}, {})
    with torch.no_grad():
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for k, v in leaves.items():
            g, v = grads[k], v.detach()
            v.mul_(1 - lr * wd)
            m1 = before.m1[k].lerp(g, 1 - b1)
            m2 = before.m2[k].mul(b2).addcmul_(g, g, value=1 - b2)
            denom = (m2.sqrt() / math.sqrt(bc2)).add_(eps)
            v.addcdiv_(m1, denom, value=-lr / bc1)
            after.params[k], after.m1[k], after.m2[k] = v, m1, m2
    return float(loss.detach()), grads, after
