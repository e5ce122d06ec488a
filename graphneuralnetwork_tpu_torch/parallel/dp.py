"""The data-parallel training step: what GSPMD does implicitly in JAX's
multi-device runs.

  * every rank starts from the same parameters (``broadcast_parameters``);
  * each rank's loss is its share of the global loss: the sum of its
    selected rows' losses over the **global** count of selected rows
    (``global_count``), so the ranks' losses add up to the single-device
    mean whatever the split;
  * the gradients are summed over the ranks (``all_reduce_gradients``).

DDP's per-rank mean is not used: with an uneven split of the selected rows
it weights the ranks equally and gives other gradients than the
single-device loss.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..train.metrics import masked_softmax_cross_entropy
from .collectives import all_reduce_gradients, all_reduce_sum
from .multihost import Mesh


def global_count(n_local: int, mesh: Mesh) -> torch.Tensor:
    """The number of selected rows over every rank (float32, on the mesh's
    device)."""
    return all_reduce_sum(
        torch.tensor(float(n_local), device=mesh.device), mesh)


def owned_rows(idx: torch.Tensor, rank: int, nps: int) -> torch.Tensor:
    """The local rows, in ``idx``'s order, of the global node ids ``idx``
    that rank ``rank`` owns (rows ``[rank·nps, (rank+1)·nps)``)."""
    lo = rank * nps
    mine = (idx >= lo) & (idx < lo + nps)
    return idx[mine] - lo


def dp_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of the mean softmax cross-entropy over the
    selected rows of every rank: ``Σ_local / global count``."""
    count = global_count(rows.shape[0], mesh)
    if rows.shape[0] == 0:
        return logits.sum() * 0.0
    mean = masked_softmax_cross_entropy(logits[rows], labels[rows])
    return mean * rows.shape[0] / count


def dp_step(params: Iterable[torch.nn.Parameter],
            optimizer: torch.optim.Optimizer,
            local_loss: Callable[[], torch.Tensor],
            mesh: Mesh) -> torch.Tensor:
    """One optimizer step on the sum of every rank's ``local_loss()`` (its
    share of the global loss): backward, the gradients summed over the
    ranks, the step. Returns the global loss (detached)."""
    params = list(params)
    optimizer.zero_grad(set_to_none=True)
    loss = local_loss()
    loss.backward()
    all_reduce_gradients(params, mesh)
    optimizer.step()
    return all_reduce_sum(loss.detach(), mesh)
