"""The traced window: whole blocks under ``torch.profiler`` (host and
device), reduced to device seconds by kernel name, the device's busy time
(the union of its operations' intervals), and the longest idle gaps by
the host operation that was running at the time.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np
import torch

#: the traced window's length: whole blocks until this many seconds (or the
#: run's ``--seconds``, if shorter); long enough for a few blocks, short
#: enough for the trace to be read within the run's time limit
TRACE_SECONDS = 2.0
TOP = 10


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer."))


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    reach = np.maximum.accumulate(ends)
    new = np.concatenate([[True], starts[1:] > reach[:-1]])
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:] - 1, [len(starts) - 1]])
    return starts[first], reach[last]


def _gap_labels(mid: np.ndarray, host) -> list[str]:
    """The innermost host operation running at each gap's midpoint."""
    label = np.full(mid.shape[0], -1, np.int64)
    order = np.argsort(mid)
    sorted_mid = mid[order]
    names = []
    # longest first, so that shorter (inner) operations overwrite
    for e in sorted(host, key=lambda e: -(e.time_range.end
                                          - e.time_range.start)):
        lo = np.searchsorted(sorted_mid, e.time_range.start, "left")
        hi = np.searchsorted(sorted_mid, e.time_range.end, "right")
        if hi > lo:
            label[order[lo:hi]] = len(names)
            names.append(e.name)
    return [names[i] if i >= 0 else "no host operation" for i in label]


def traced_blocks(run_block: Callable[[], object], epochs_per_call: int,
                  seconds: float) -> dict:
    """Run whole blocks under the profiler for ``min(seconds,
    TRACE_SECONDS)``; returns ``kernel_s``, ``busy_s``, ``window_s``,
    ``epochs`` and the ``breakdown``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    limit = min(seconds, TRACE_SECONDS)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        epochs = 0
        while True:
            run_block()
            epochs += epochs_per_call
            if time.perf_counter() - t0 >= limit:
                break
        window_s = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events if _is_device(e)]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    kernel_s = collections.Counter()
    for e in device:
        kernel_s[e.name] += e.time_range.elapsed_us() * 1e-6
    busy_s, gaps = 0.0, collections.Counter()
    if device:
        s, e = _union(np.array([d.time_range.start for d in device], float),
                      np.array([d.time_range.end for d in device], float))
        busy_s = float((e - s).sum()) * 1e-6
        gap = (s[1:] - e[:-1]) * 1e-6
        for name, g in zip(_gap_labels((s[1:] + e[:-1]) / 2, host), gap):
            gaps[name] += float(g)
    return {
        "kernel_s": dict(kernel_s), "busy_s": busy_s, "window_s": window_s,
        "epochs": epochs,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in kernel_s.most_common(TOP)],
            "idle_gaps": [[n[:160], s] for n, s in gaps.most_common(TOP)]},
    }
