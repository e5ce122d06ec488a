"""What the per-layer readers (``metrics/<name>.py``) share: the context a
run hands them, the kernel families by name, and the epoch's work.

A reader is ``read(ctx) -> float | None``; ``None`` means it found nothing
to read, and the harness leaves the metric out of the line. ``ctx`` holds
``cfg`` (the configuration file), ``cell`` (the workload file), ``n`` and
``e`` (nodes, directed edges with self loops), ``spans`` (seconds by
name) and, in a traced run, ``trace``: ``kernel_s`` (device seconds by
kernel name), ``busy_s``, ``window_s`` and ``epochs``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

from . import work
from .reference import gnn

KERNEL_NAMES = {k: re.compile(v) for k, v in json.loads(
    (Path(__file__).resolve().parent / "kernel_names.json").read_text()
).items() if not k.startswith("_")}


def family_s(ctx: dict, families) -> float:
    """Device seconds of the port's kernels of ``families`` (e.g. K1)."""
    pats = [KERNEL_NAMES[f] for f in families]
    return sum(s for name, s in ctx["trace"]["kernel_s"].items()
               if any(p.search(name) for p in pats))


def is_port_kernel(name: str) -> bool:
    return any(p.search(name) for p in KERNEL_NAMES.values())


def epoch_ops(ctx: dict, layout: str) -> list[work.Op]:
    """The work of one epoch of the cell's model (``reference/<model>.py``)
    on ``layout``."""
    return gnn.model(ctx["cfg"]).epoch_ops(ctx["cfg"], ctx["n"], ctx["e"],
                                           layout)


def roofline(ctx: dict, kinds, families) -> Optional[float]:
    """The epoch's least time for the work of ``kinds`` over the device
    time per epoch of the kernels of ``families``, in %; None where those
    kernels did not run or do no such work in this cell."""
    if "trace" not in ctx:
        return None
    least_ms = work.least_ms(epoch_ops(ctx, ctx["cell"]["layout"]),
                             ctx["cfg"]["dtype"], kinds)
    spent = family_s(ctx, families)
    if least_ms <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * least_ms * 1e-3 * ctx["trace"]["epochs"] / spent
