"""Full-batch training loop with the reference's training semantics.

Port of ``graphneuralnetwork_tpu/train/loop.py``: best-val selection (save
params whenever val loss improves), early stop after ``patience``
non-improving evals, test with the best params. PyTorch runs eagerly, so a
step is the forward, the loss, the backward and the optimizer update; the
loop reads a number back to the host only where it has to decide.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from .metrics import accuracy, masked_softmax_cross_entropy
from .schedule import OptimizerSpec, WarmupPolyTable


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    #: ``LambdaLR`` on the CPU, ``WarmupPolyTable`` on CUDA (``schedule.py``)
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler
                        | WarmupPolyTable]
    generator: torch.Generator       # dropout draws, on the data's device


def _split_seed(seed: int) -> tuple[int, int]:
    """Two independent seeds (parameters, dropout) from one."""
    a, b = np.random.SeedSequence(seed).generate_state(2)
    return int(a), int(b)


def create_train_state(model: nn.Module, data, seed: int,
                       optimizer: OptimizerSpec,
                       params: Optional[dict] = None) -> TrainState:
    """Initialise ``model`` from ``seed`` (or load ``params``), move it to
    the data's device and bind the optimizer and a dropout generator."""
    init_seed, dropout_seed = _split_seed(seed)
    model.to("cpu")
    model.reset_parameters(torch.Generator().manual_seed(init_seed))
    if params is not None:
        model.load_state_dict(params)
    model.to(data.device)
    opt, sched = optimizer.build(model.parameters())
    gen = torch.Generator(device=data.device).manual_seed(dropout_seed)
    return TrainState(model, opt, sched, gen)


def train_step(state: TrainState, data) -> tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on the training nodes; returns (loss, train_acc)
    as device scalars."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    logits = model(data.graph, data.features, generator=state.generator)
    sel = logits[data.train_idx]
    labels = data.labels[data.train_idx]
    loss = masked_softmax_cross_entropy(sel, labels)
    loss.backward()
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    return loss.detach(), accuracy(sel.detach(), labels)


def make_eval_fn(model: nn.Module) -> Callable:
    """``evaluate(graph, features, labels, idx) -> (loss, acc)`` in eval
    mode (no dropout) without gradients."""

    @torch.no_grad()
    def evaluate(graph, features, labels, idx):
        was_training = model.training
        model.eval()
        try:
            sel = model(graph, features)[idx]
        finally:
            model.train(was_training)
        lab = labels[idx]
        return masked_softmax_cross_entropy(sel, lab), accuracy(sel, lab)

    return evaluate


def snapshot(model: nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@dataclass
class FitResult:
    best_params: Any
    best_val_loss: float
    best_val_acc: float
    test_loss: float = float("nan")
    test_acc: float = float("nan")
    epochs_run: int = 0
    history: list = field(default_factory=list)
    seconds: float = 0.0


def finish(state: TrainState, data, evaluate, best_params, best_val,
           best_val_acc, epochs_run, history, t0) -> FitResult:
    """Test with the best params (kept in the model afterwards)."""
    state.model.load_state_dict(best_params)
    test_loss, test_acc = evaluate(data.graph, data.features, data.labels,
                                   data.test_idx)
    return FitResult(
        best_params=best_params, best_val_loss=best_val,
        best_val_acc=best_val_acc, test_loss=float(test_loss),
        test_acc=float(test_acc), epochs_run=epochs_run, history=history,
        seconds=time.perf_counter() - t0)


def fit_node_classifier(
    model: nn.Module, data, *,
    epochs: int,
    optimizer: OptimizerSpec,
    eval_every: int = 20,
    patience: int = 10,
    seed: int = 0,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
) -> FitResult:
    """Step every epoch, evaluate every ``eval_every`` epochs (and at the
    last), stop after ``patience`` evals without a better val loss."""
    state = create_train_state(model, data, seed, optimizer)
    if resume and checkpoint_dir is not None:
        from .checkpoint import restore_checkpoint
        try:
            restore_checkpoint(checkpoint_dir, state)
        except FileNotFoundError:
            pass
    evaluate = make_eval_fn(model)

    best_val, best_val_acc = float("inf"), 0.0
    best_params = snapshot(model)
    bad_evals, history, epochs_run = 0, [], 0
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        loss, train_acc = train_step(state, data)
        epochs_run = epoch
        if epoch % eval_every == 0 or epoch == epochs:
            val_loss, val_acc = evaluate(data.graph, data.features,
                                         data.labels, data.val_idx)
            val_loss = float(val_loss)
            history.append((epoch, float(loss), float(train_acc),
                            val_loss, float(val_acc)))
            if verbose:
                print(f"epoch {epoch}: loss {float(loss):.4f} "
                      f"train_acc {float(train_acc):.4f} "
                      f"val_loss {val_loss:.4f} val_acc {float(val_acc):.4f}")
            if val_loss < best_val:
                best_val, best_val_acc = val_loss, float(val_acc)
                best_params = snapshot(model)
                bad_evals = 0
                if checkpoint_dir is not None:
                    from .checkpoint import save_checkpoint
                    save_checkpoint(checkpoint_dir, state, epoch)
            else:
                bad_evals += 1
                if bad_evals >= patience:
                    break
    return finish(state, data, evaluate, best_params, best_val,
                  best_val_acc, epochs_run, history, t0)
