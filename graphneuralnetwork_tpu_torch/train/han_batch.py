"""HAN node-minibatch training, the reference's batch mode.

Port of ``graphneuralnetwork_tpu/train/han_batch.py``: batches of training
paper ids, a dense [P, B, B] sub-adjacency per batch
(``adj[:, idx][:, :, idx]``), ``DenseHAN`` with dropout, SGD with momentum
under the warmup-poly schedule (one epoch of warm-up steps), evaluation on
the val papers every ``eval_every`` batches with the best-val parameters
kept, and a stop after ``patience`` evaluations without a better val loss.
The numpy generator is drawn in the reference's order (one permutation of
the training ids an epoch; evaluation batches draw nothing), so the batches
are the reference's.

The dense [P, N, N] stack lives on the device once and each step gathers
its sub-adjacency there; the host sends only the batch's index vector. The
final batch of a pass wraps around the permutation, so every batch has
``batch_size`` ids. Each step runs eagerly.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.graph import dense_adj
from ..nn.han import DenseHAN
from .loop import FitResult, create_train_state, snapshot
from .metrics import accuracy, masked_softmax_cross_entropy
from .schedule import make_optimizer


def dense_metapath_stack(data) -> torch.Tensor:
    """float32 [P, N, N]: each metapath's adjacency, symmetrised (receiver
    rows), on the data's device."""
    mats = []
    for g in data.graphs:
        a = dense_adj(g)
        mats.append(torch.maximum(a, a.T))
    return torch.stack(mats)


def _batches(idx: np.ndarray, batch_size: int, rng: np.random.Generator,
             shuffle: bool) -> np.ndarray:
    """[num_batches, B] int64 ids, the tail wrapped around so every batch
    is full (the reference's ``_batches``, draw for draw)."""
    idx = np.asarray(idx)
    perm = rng.permutation(idx) if shuffle else idx
    nb = max(1, -(-len(perm) // batch_size))
    return np.resize(perm, nb * batch_size).reshape(nb, batch_size).astype(
        np.int64)


def fit_han_minibatch(
    data, *,
    batch_size: int = 32,
    lr: float = 0.05,
    momentum: float = 0.9,
    epochs: int = 100,
    hidden: int = 8,
    num_heads=(4,),
    dropout: float = 0.6,
    eval_every: int = 20,
    patience: int = 20,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    verbose: bool = False,
) -> FitResult:
    """Train ``DenseHAN`` on node minibatches of ``data``
    (``HeteroNodeData``); ``epochs_run`` counts batches, as the
    reference's does."""
    nprng = np.random.default_rng(seed)
    adj = dense_metapath_stack(data)
    features, labels = data.features, data.labels
    device = features.device
    model = DenseHAN(int(features.shape[1]), num_metapaths=adj.shape[0],
                     num_classes=data.num_classes, hidden=hidden,
                     num_heads=tuple(num_heads), dropout=dropout,
                     dtype=dtype)
    train_np = data.train_idx.cpu().numpy()
    steps_per_epoch = max(1, -(-len(train_np) // batch_size))
    opt = make_optimizer("sgd", lr, total_steps=steps_per_epoch * epochs,
                         warmup_steps=steps_per_epoch, momentum=momentum)
    state = create_train_state(model, data, seed, opt)

    def step(idx: torch.Tensor):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        y = labels[idx]
        logits = model(adj[:, idx][:, :, idx], features[idx],
                       generator=state.generator)
        loss = masked_softmax_cross_entropy(logits, y)
        loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        return loss.detach(), accuracy(logits.detach(), y)

    @torch.no_grad()
    def eval_split(split_idx) -> tuple[float, float]:
        model.eval()
        losses, accs = [], []
        for b in _batches(split_idx, batch_size, nprng, shuffle=False):
            idx = torch.from_numpy(b).to(device)
            logits = model(adj[:, idx][:, :, idx], features[idx])
            losses.append(masked_softmax_cross_entropy(logits, labels[idx]))
            accs.append(accuracy(logits, labels[idx]))
        # one read; the mean in float64, as the reference's np.mean
        parts = torch.stack([torch.stack(losses), torch.stack(accs)])
        lo, ac = parts.cpu().numpy().astype(np.float64).mean(axis=1)
        return float(lo), float(ac)

    val_np = data.val_idx.cpu().numpy()
    best_val, best_val_acc = float("inf"), 0.0
    best_params = snapshot(model)
    bad_evals, history, total_batch, stop = 0, [], 0, False
    t0 = time.perf_counter()
    for _ in range(epochs):
        for b in _batches(train_np, batch_size, nprng, shuffle=True):
            loss, train_acc = step(torch.from_numpy(b).to(device))
            if total_batch % eval_every == 0:
                val_loss, val_acc = eval_split(val_np)
                history.append((total_batch, float(loss), float(train_acc),
                                val_loss, val_acc))
                if verbose:
                    print(f"iter {total_batch}: loss {float(loss):.4f} "
                          f"val_loss {val_loss:.4f} val_acc {val_acc:.4f}")
                if val_loss < best_val:
                    best_val, best_val_acc = val_loss, val_acc
                    best_params = snapshot(model)
                    bad_evals = 0
                else:
                    bad_evals += 1
                    if bad_evals >= patience:
                        stop = True
                        break
            total_batch += 1
        if stop:
            break

    model.load_state_dict(best_params)
    test_loss, test_acc = eval_split(data.test_idx.cpu().numpy())
    return FitResult(best_params=best_params, best_val_loss=best_val,
                     best_val_acc=best_val_acc, test_loss=test_loss,
                     test_acc=test_acc, epochs_run=total_batch,
                     history=history, seconds=time.perf_counter() - t0)
