"""Block-wise training: the host reads metrics once per block of epochs.

Port of ``graphneuralnetwork_tpu/train/scan_loop.py``. The reference folds
``epochs_per_call`` epochs into one ``lax.scan`` dispatch; here the block
is a Python loop whose per-epoch metrics stay on the device and come back
to the host in one transfer at the block's end. Early stopping and
best-val selection keep the reference's rules: compare the block-end val
loss, stop after ``patience_calls`` blocks without improvement.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from .loop import (FitResult, TrainState, create_train_state, finish,
                   make_eval_fn, snapshot, train_step)
from .schedule import OptimizerSpec


def run_epochs(state: TrainState, data, evaluate, n: int) -> np.ndarray:
    """Train ``n`` epochs, evaluating val after each; returns float32
    ``[n, 4]`` rows of (loss, train_acc, val_loss, val_acc)."""
    rows = []
    for _ in range(n):
        loss, train_acc = train_step(state, data)
        val_loss, val_acc = evaluate(data.graph, data.features, data.labels,
                                     data.val_idx)
        rows.append(torch.stack([loss, train_acc, val_loss, val_acc]))
    return torch.stack(rows).cpu().numpy()      # the block's one host read


def fit_node_classifier_scan(
    model: nn.Module, data, *,
    epochs: int,
    optimizer: OptimizerSpec,
    epochs_per_call: int = 100,
    patience_calls: int = 3,
    seed: int = 0,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
) -> FitResult:
    """Blocks of ``epochs_per_call`` epochs until ``epochs`` are done or
    early stopping cuts the run. ``checkpoint_dir`` saves params and
    optimizer state on every val improvement; ``resume`` restores a prior
    checkpoint first (a missing one means a fresh run)."""
    state = create_train_state(model, data, seed, optimizer)
    start_epoch = 0
    if resume and checkpoint_dir is not None:
        from .checkpoint import restore_checkpoint
        try:
            state, start_epoch = restore_checkpoint(checkpoint_dir, state)
            if verbose:
                print(f"resumed from {checkpoint_dir} "
                      f"at epoch {start_epoch}")
        except FileNotFoundError:
            pass
    evaluate = make_eval_fn(model)

    best_val, best_val_acc = float("inf"), 0.0
    best_params = snapshot(model)
    bad, done, history = 0, 0, []
    t0 = time.perf_counter()
    while done < epochs:
        ms = run_epochs(state, data, evaluate, epochs_per_call)
        done += epochs_per_call
        loss, train_acc, end_val, val_acc = (float(v) for v in ms[-1])
        history.append((done, loss, train_acc, end_val, val_acc))
        if verbose:
            print(f"epoch {done}: val_loss {end_val:.4f} "
                  f"val_acc {val_acc:.4f}")
        if end_val < best_val:
            best_val, best_val_acc = end_val, val_acc
            best_params = snapshot(model)
            bad = 0
            if checkpoint_dir is not None:
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_dir, state, start_epoch + done)
        else:
            bad += 1
            if bad >= patience_calls:
                break
    return finish(state, data, evaluate, best_params, best_val,
                  best_val_acc, done, history, t0)
