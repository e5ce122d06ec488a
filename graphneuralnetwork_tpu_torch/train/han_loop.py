"""Full-batch HAN training: the ``--model han`` loop of the reference CLI.

The reference trains in chunks of ``min(20, epochs)`` epochs, each one
jitted ``lax.scan`` dispatch whose losses the host reads once, then tests
with one forward (``graphneuralnetwork_tpu/cli.py``, ``han`` branch). Here
a chunk is a ``HANBlock``: on CUDA one epoch (the train step, its loss
written into a device buffer) is captured once as a CUDA graph and each
chunk replays it, after every metapath graph has built its first-use
caches (``warm()``); on the CPU the chunk is ``run_han_epochs``, eager
epochs with the same single read. There is no validation pass, as in the
reference.

HAN trains without dropout here: the reference's loss applies the model
without ``deterministic=False``, so its attention dropout and the dropout
between layers are off in every ``han`` epoch. ``han_step`` therefore runs
the model in eval mode while it takes the gradient.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from .loop import TrainState, create_train_state
from .metrics import accuracy, masked_softmax_cross_entropy
from .scan_loop import CapturedBlock
from .schedule import OptimizerSpec


def han_step(state: TrainState, data) -> torch.Tensor:
    """One optimizer step of ``state.model`` on ``data``'s training papers,
    dropout off (see the module docstring); returns the loss as a device
    scalar."""
    model = state.model
    model.eval()
    state.optimizer.zero_grad(set_to_none=True)
    logits = model(data.graphs, data.features)
    loss = masked_softmax_cross_entropy(logits[data.train_idx],
                                        data.labels[data.train_idx])
    loss.backward()
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    return loss.detach()


def run_han_epochs(state: TrainState, data, n: int) -> np.ndarray:
    """``n`` eager epochs; float32 ``[n, 1]`` losses, read once."""
    return torch.stack([han_step(state, data)
                        for _ in range(n)])[:, None].cpu().numpy()


class HANBlock(CapturedBlock):
    """``CapturedBlock`` for HAN: the epoch is ``han_step`` and writes the
    loss alone (``run()`` returns float32 ``[K, 1]``), and the warm-up
    before the capture warms every metapath graph."""

    def __init__(self, state: TrainState, data, epochs_per_call: int):
        super().__init__(state, data, None, epochs_per_call)
        self.rows = torch.zeros(epochs_per_call, 1,
                                device=data.features.device)

    def warm(self) -> None:
        for graph in self.data.graphs:
            graph.warm()

    def epoch(self) -> None:
        loss = han_step(self.state, self.data)
        self.rows.index_copy_(0, self.index, loss.reshape(1, 1))
        self.index += 1


@dataclass
class HANFit:
    test_acc: float
    epochs_run: int
    seconds: float
    losses: list = field(default_factory=list)
    #: epochs/s after the first chunk (None for one chunk)
    steady_epochs_per_s: Optional[float] = None


@torch.no_grad()
def accuracy_on_test(model: nn.Module, data) -> float:
    """Accuracy on the test papers from one forward in eval mode."""
    model.eval()
    logits = model(data.graphs, data.features)
    idx = data.test_idx
    return float(accuracy(logits[idx], data.labels[idx]))


def fit_han(model: nn.Module, data, *, epochs: int,
            optimizer: OptimizerSpec, epochs_per_call: int = 20,
            seed: int = 0, verbose: bool = False) -> HANFit:
    """Chunks of ``epochs_per_call`` epochs until ``epochs`` are done (the
    last chunk runs whole, as the reference's does), then the test
    accuracy; CUDA data train in ``HANBlock`` replays."""
    state = create_train_state(model, data, seed, optimizer)
    cuda = data.features.device.type == "cuda"
    block = HANBlock(state, data, epochs_per_call) if cuda else None
    done, losses, t_after_first = 0, [], None
    t0 = time.perf_counter()
    while done < epochs:
        rows = (block.run() if cuda
                else run_han_epochs(state, data, epochs_per_call))
        losses += rows[:, 0].tolist()
        done += epochs_per_call
        if t_after_first is None:
            t_after_first = time.perf_counter()
        if verbose:
            print(f"epoch {done}: loss {losses[-1]:.4f}")
    t_end = time.perf_counter()
    steady = ((done - epochs_per_call) / (t_end - t_after_first)
              if done > epochs_per_call else None)
    return HANFit(test_acc=accuracy_on_test(model, data), epochs_run=done,
                  seconds=t_end - t0, losses=losses,
                  steady_epochs_per_s=steady)
