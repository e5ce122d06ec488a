"""Checkpoint save/restore: params, optimizer (and schedule) state, epoch.

Port of the msgpack backend of ``graphneuralnetwork_tpu/train/checkpoint.py``
onto ``torch.save``: one file, written atomically, loaded with
``weights_only=True`` (tensors and plain containers only). Only the
primary process writes it (``parallel/multihost.py:is_primary``): every
rank of a data-parallel run holds the same parameters, and concurrent
writers would race.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .loop import TrainState

FILENAME = "checkpoint.pt"


def _path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, FILENAME)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    from ..parallel.multihost import is_primary

    p = _path(ckpt_dir)
    if not is_primary():
        return p
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "params": state.model.state_dict(),
        "opt_state": state.optimizer.state_dict(),
        "scheduler": (None if state.scheduler is None
                      else state.scheduler.state_dict()),
    }
    tmp = p + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, p)  # atomic — a crash never leaves a torn checkpoint
    return p


def restore_checkpoint(ckpt_dir: str,
                       state: TrainState) -> tuple[TrainState, int]:
    """Load params and optimizer state into ``state``; returns (state,
    step). Raises FileNotFoundError when there is no checkpoint."""
    p = _path(ckpt_dir)
    if not os.path.exists(p):
        raise FileNotFoundError(f"no checkpoint at {p}")
    device = next(state.model.parameters()).device
    payload = torch.load(p, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    if state.scheduler is not None and payload["scheduler"] is not None:
        state.scheduler.load_state_dict(payload["scheduler"])
    return state, int(payload["step"])



def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step of the checkpoint in ``ckpt_dir``; ``None`` when there is
    none."""
    p = _path(ckpt_dir)
    if not os.path.exists(p):
        return None
    return int(torch.load(p, map_location="cpu", weights_only=True)["step"])
