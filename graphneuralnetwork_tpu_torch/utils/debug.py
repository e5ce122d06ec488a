"""Debug utilities: NaN checking of outputs, parameters and states.

Port of the JAX package's ``utils/debug.py``. JAX wraps a step in
``checkify``'s float checks; PyTorch has no such transform, so
``nan_checked`` checks what the wrapped function returns, on the host,
when ``GNN_TPU_DEBUG_NANS=1`` (the JAX package's flag), and costs one flag
read otherwise. ``assert_all_finite`` and ``find_nonfinite`` scan every
floating tensor of a nested structure of dicts, lists, tuples and
``nn.Module`` states, naming each leaf by its path as JAX's
``keystr`` does (``['x']``, ``[0]``; a module's entries as ``.name``).
"""

from __future__ import annotations

import os
from functools import wraps
from typing import Callable, Iterator

import torch


def debug_nans_enabled() -> bool:
    return os.environ.get("GNN_TPU_DEBUG_NANS", "0") == "1"


def _leaves(tree, path: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, tensor) of every floating tensor in ``tree``."""
    if isinstance(tree, torch.nn.Module):
        for name, value in tree.state_dict(keep_vars=True).items():
            yield from _leaves(value, f"{path}.{name}")
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree.detach()


def find_nonfinite(tree) -> list[str]:
    """``"<path>: <count> bad"`` for each floating leaf holding NaN or
    Inf."""
    out = []
    for path, leaf in _leaves(tree):
        n = int((~torch.isfinite(leaf)).sum())
        if n:
            out.append(f"{path}: {n} bad")
    return out


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming every leaf of ``tree`` that holds
    a NaN or an Inf (a host-side audit after a step)."""
    bad = [path for path, leaf in _leaves(tree)
           if not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {', '.join(bad)}")


def nan_checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that, when ``GNN_TPU_DEBUG_NANS=1``, a NaN or Inf in
    any floating tensor it returns raises ``FloatingPointError`` (the check
    reads the values on the host, so it waits for the device); with the
    flag off the wrapper only calls ``fn``."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if debug_nans_enabled():
            assert_all_finite(out, getattr(fn, "__name__", "output"))
        return out

    return wrapper
