"""GTN training: the ``--model gtn`` loop of the reference CLI.

The reference trains in chunks of ``min(10, epochs)`` epochs, each one
jitted ``lax.scan`` dispatch whose losses the host reads once, with
``optax.multi_transform`` over two AdamW groups (the ``gt*`` layers at
half the learning rate), no dropout and no validation pass, then scores
the test targets with one forward: accuracy and macro precision, recall
and F1 (``graphneuralnetwork_tpu/cli.py``, ``gtn`` branch). Here a chunk
is a ``GTNBlock``: on CUDA one epoch (the train step, its loss written
into a device buffer) is captured once as a CUDA graph and each chunk
replays it; on the CPU the chunk is ``run_gtn_epochs``, eager epochs with
the same single read. The model's input ``graph`` is the dense stack
(``GTN``) or a ``GTNPlan`` (``SparseGTN``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.gtn_sparse import GTNPlan
from .loop import TrainState, _split_seed
from .metrics import masked_softmax_cross_entropy, precision_recall_fbeta
from .scan_loop import CapturedBlock

#: The reference's AdamW groups: the ``gt*`` layers, the rest; one decay.
GT_LR, OTHER_LR, WEIGHT_DECAY = 2.5e-3, 5e-3, 1e-3


def create_gtn_state(model: nn.Module, data, seed: int,
                     params: Optional[dict] = None) -> TrainState:
    """Initialise ``model`` from ``seed`` (or load ``params``) as
    ``create_train_state`` does, move it to the data's device and bind one
    AdamW (optax's betas and eps; capturable on CUDA) over two groups:
    the parameters whose top-level name starts with ``gt`` at ``GT_LR``,
    the others at ``OTHER_LR``."""
    init_seed, dropout_seed = _split_seed(seed)
    model.to("cpu")
    model.reset_parameters(torch.Generator().manual_seed(init_seed))
    if params is not None:
        model.load_state_dict(params)
    model.to(data.device)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        groups[name.startswith("gt")].append(p)
    opt = torch.optim.AdamW(
        [{"params": groups[True], "lr": GT_LR},
         {"params": groups[False], "lr": OTHER_LR}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY,
        capturable=data.device.type == "cuda")
    gen = torch.Generator(device=data.device).manual_seed(dropout_seed)
    return TrainState(model, opt, None, gen)


def gtn_step(state: TrainState, data, graph) -> torch.Tensor:
    """One AdamW step on the training targets' mean negative
    log-softmax; returns the loss as a device scalar."""
    state.optimizer.zero_grad(set_to_none=True)
    logits = state.model(graph, data.features)
    # the splits index the target nodes (the papers)
    loss = masked_softmax_cross_entropy(
        logits[data.target_idx[data.train_idx]],
        data.labels[data.train_idx])
    loss.backward()
    state.optimizer.step()
    return loss.detach()


def run_gtn_epochs(state: TrainState, data, graph, n: int) -> np.ndarray:
    """``n`` eager epochs; float32 ``[n, 1]`` losses, read once."""
    return torch.stack([gtn_step(state, data, graph)
                        for _ in range(n)])[:, None].cpu().numpy()


class GTNBlock(CapturedBlock):
    """``CapturedBlock`` for GTN: the epoch is ``gtn_step`` on ``graph``
    and writes the loss alone (``run()`` returns float32 ``[K, 1]``); the
    warm-up before the capture warms a ``GTNPlan`` (the dense stack has
    nothing to warm)."""

    def __init__(self, state: TrainState, data, graph, epochs_per_call: int):
        super().__init__(state, data, None, epochs_per_call)
        self.graph_in = graph
        self.rows = torch.zeros(epochs_per_call, 1,
                                device=data.features.device)

    def warm(self) -> None:
        if isinstance(self.graph_in, GTNPlan):
            self.graph_in.warm()

    def epoch(self) -> None:
        loss = gtn_step(self.state, self.data, self.graph_in)
        self.rows.index_copy_(0, self.index, loss.reshape(1, 1))
        self.index += 1


@dataclass
class GTNFit:
    test_acc: float
    f1: float
    precision: float
    recall: float
    epochs_run: int
    seconds: float
    losses: list = field(default_factory=list)
    #: epochs/s after the first chunk (None for one chunk)
    steady_epochs_per_s: Optional[float] = None


@torch.no_grad()
def score_on_test(model: nn.Module, data, graph) -> dict:
    """Accuracy and macro precision, recall and F1 of the test targets
    from one forward."""
    logits = model(graph, data.features)[data.target_idx[data.test_idx]]
    labels = data.labels[data.test_idx]
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    prec, rec, f1 = precision_recall_fbeta(logits, labels, data.num_classes)
    return dict(test_acc=float(acc), f1=float(f1), precision=float(prec),
                recall=float(rec))


def fit_gtn(model: nn.Module, data, graph, *, epochs: int,
            epochs_per_call: int = 10, seed: int = 0,
            verbose: bool = False) -> GTNFit:
    """Chunks of ``epochs_per_call`` epochs until ``epochs`` are done (the
    last chunk runs whole, as the reference's does), then the test scores;
    CUDA data train in ``GTNBlock`` replays."""
    state = create_gtn_state(model, data, seed)
    cuda = data.features.device.type == "cuda"
    block = GTNBlock(state, data, graph, epochs_per_call) if cuda else None
    done, losses, t_after_first = 0, [], None
    t0 = time.perf_counter()
    while done < epochs:
        rows = (block.run() if cuda
                else run_gtn_epochs(state, data, graph, epochs_per_call))
        losses += rows[:, 0].tolist()
        done += epochs_per_call
        if t_after_first is None:
            t_after_first = time.perf_counter()
        if verbose:
            print(f"epoch {done}: loss {losses[-1]:.4f}")
    t_end = time.perf_counter()
    steady = ((done - epochs_per_call) / (t_end - t_after_first)
              if done > epochs_per_call else None)
    return GTNFit(**score_on_test(model, data, graph), epochs_run=done,
                  seconds=t_end - t0, losses=losses,
                  steady_epochs_per_s=steady)
