"""Convert flax parameter trees to this package's ``state_dict`` layout.

The input is a nested dict of numpy arrays (e.g. ``jax.tree.map(np.asarray,
params)`` of the JAX package's models); nothing here imports flax or JAX.
Scopes join with ``.``; a Dense ``kernel`` [in, out] becomes
``linear.weight`` [out, in]; every other leaf (``bias``, ``attn_src``,
``attn_dst``) keeps its name and shape.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_flax(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(from_flax(value, prefix=name + "."))
        elif key == "kernel":
            out[f"{prefix}weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(value, np.float32).T))
        else:
            out[name] = torch.from_numpy(
                np.array(value, dtype=np.float32, copy=True))
    return out
