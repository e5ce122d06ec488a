"""Block-wise training: the host reads metrics once per block of epochs.

Port of ``graphneuralnetwork_tpu/train/scan_loop.py``.
``make_scanned_node_classification_run`` is the counterpart of the
reference's (``train/scan_loop.py:22``), which folds ``epochs_per_call``
epochs into one jitted ``lax.scan`` dispatch. On CUDA, one epoch (the train
step, the val forward and the write of its metrics row into a device
buffer at an index that the epoch advances) is captured once as a
``torch.cuda.CUDAGraph`` and each block replays it ``epochs_per_call``
times: one host call an epoch, no kernel launched from the host, and one
host read at the block's end. The first block runs its first epoch
eagerly, on a side stream (the warm-up that builds every first-use cache
and kernel library), then captures the second and replays the rest. On
the CPU the block is ``run_epochs``, a Python loop of eager epochs with
the same single read. Early stopping and best-val selection keep the
reference's rules: compare the block-end val loss, stop after
``patience_calls`` blocks without improvement.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops.cuda.counters import add_launches, count_capture
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


class EpochGraph:
    """One epoch as a ``torch.cuda.CUDAGraph``, after PyTorch's recipe for
    capturing a whole network: a warm-up run on a side stream, then one
    capture (in the default error mode: a host sync raises), replayed on
    the current stream. The dropout generator, if any, is registered with
    the graph, so that each replay draws afresh."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)

    def warm_up(self, epoch: Callable[[], None]) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            epoch()
        current.wait_stream(side)

    def capture(self, epoch: Callable[[], None]) -> None:
        with torch.cuda.graph(self.graph):
            epoch()

    def replay(self) -> None:
        self.graph.replay()


class CapturedBlock:
    """Blocks of ``epochs_per_call`` epochs of ``state`` on ``data``, each
    epoch a replay of one captured ``EpochGraph``; ``run()`` returns the
    block's float32 ``[K, 4]`` rows as ``run_epochs`` does. The first
    ``run()`` builds the graph's caches (``warm()``), runs its first epoch
    as the warm-up and captures the second; one capture serves every
    later block. A capture counts its wrappers' launches and launches
    nothing, a replay the reverse: the capture's counts come off the
    launch totals and go back on at each replay."""

    def __init__(self, state: TrainState, data, evaluate: Callable,
                 epochs_per_call: int):
        self.state, self.data, self.evaluate = state, data, evaluate
        self.epochs_per_call = epochs_per_call
        device = data.features.device
        self.rows = torch.zeros(epochs_per_call, 4, device=device)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.graph: Optional[EpochGraph] = None
        self.launches: dict[str, int] = {}

    def warm(self) -> None:
        """Build the data's first-use caches before the capture."""
        self.data.graph.warm()

    def epoch(self) -> None:
        data = self.data
        loss, train_acc = train_step(self.state, data)
        val_loss, val_acc = self.evaluate(data.graph, data.features,
                                          data.labels, data.val_idx)
        row = torch.stack([loss, train_acc, val_loss, val_acc])
        self.rows.index_copy_(0, self.index, row[None])
        self.index += 1

    def run(self) -> np.ndarray:
        self.index.zero_()
        replays = self.epochs_per_call
        if self.graph is None:
            self.warm()
            graph = EpochGraph(self.data.features.device,
                               self.state.generator)
            graph.warm_up(self.epoch)
            # the backward allocates the captured step's gradients anew
            self.state.optimizer.zero_grad(set_to_none=True)
            self.launches = count_capture(lambda: graph.capture(self.epoch))
            self.graph = graph
            replays -= 1
        for _ in range(replays):
            self.graph.replay()
            add_launches(self.launches)
        # the block's one host read; a copy, as the next block rewrites
        # the buffer
        return self.rows.cpu().numpy().copy()


def make_scanned_node_classification_run(
        model: nn.Module, epochs_per_call: int
) -> Callable[[TrainState, object], np.ndarray]:
    """``run(state, data) -> [K, 4]`` float32 rows (loss, train_acc,
    val_loss, val_acc) of the ``K = epochs_per_call`` epochs it trains.
    Data on CUDA train in replays of one captured epoch (``CapturedBlock``,
    bound to the state and data of the first call: build the runner after
    any checkpoint restore, which replaces the optimizer's state tensors);
    any other device in ``run_epochs``."""
    evaluate = make_eval_fn(model)
    block: Optional[CapturedBlock] = None

    def run(state: TrainState, data) -> np.ndarray:
        nonlocal block
        if data.features.device.type != "cuda":
            return run_epochs(state, data, evaluate, epochs_per_call)
        if block is None:
            block = CapturedBlock(state, data, evaluate, epochs_per_call)
        elif block.state is not state or block.data is not data:
            raise ValueError("a captured run trains the state and data of "
                             "its first call only")
        return block.run()

    return run


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
    run = make_scanned_node_classification_run(model, epochs_per_call)
    evaluate = make_eval_fn(model)

    best_val, best_val_acc = float("inf"), 0.0
    best_params = snapshot(model)
    bad, done, history = 0, 0, []
    t0 = time.perf_counter()
    while done < epochs:
        ms = run(state, data)
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
