"""Profiling and throughput observability.

Port of the JAX package's ``utils/profiling.py``:

  * ``trace`` — context manager around ``torch.profiler`` writing a
    TensorBoard-loadable trace (``*.pt.trace.json``) into ``logdir``;
  * ``StepTimer`` — wall-clock per-step timing with warmup skip, plus
    derived throughput counters (edges/s, steps/s);
  * ``MetricLogger`` — windowed smoothing and printed progress with ETA.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block on the CPU and, when a card is present, on it;
    the trace is written into ``logdir`` when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Wall-clock time of each ``with`` block after the first ``warmup``.

    PyTorch's CUDA launches return before the card has done the work, so
    the exit synchronises CUDA when CUDA is initialised: a step's time then
    includes its device work, not only its launches."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def edges_per_s(self, edges_per_step: int) -> float:
        return edges_per_step / self.mean if self.times else 0.0

    def steps_per_s(self) -> float:
        return 1.0 / self.mean if self.times else 0.0


class MetricLogger:
    """Windowed smoothing of named metrics and a printed progress line with
    the elapsed time and an ETA every ``print_freq`` updates."""

    def __init__(self, window: int = 20, print_freq: int = 50,
                 header: str = ""):
        self.window = window
        self.print_freq = print_freq
        self.header = header
        self.series: dict[str, deque] = {}
        self.start = time.perf_counter()
        self.step = 0

    def update(self, **metrics):
        self.step += 1
        for k, v in metrics.items():
            self.series.setdefault(
                k, deque(maxlen=self.window)).append(float(v))

    def smoothed(self, key: str) -> float:
        d = self.series.get(key)
        return sum(d) / len(d) if d else float("nan")

    def log(self, total_steps: Optional[int] = None, force: bool = False):
        if not force and self.step % self.print_freq != 0:
            return
        elapsed = time.perf_counter() - self.start
        parts = [f"{self.header}[{self.step}"
                 + (f"/{total_steps}]" if total_steps else "]")]
        for k in self.series:
            parts.append(f"{k} {self.smoothed(k):.4f}")
        parts.append(f"{elapsed:.1f}s")
        if total_steps and self.step:
            eta = elapsed / self.step * (total_steps - self.step)
            parts.append(f"eta {eta:.0f}s")
        print("  ".join(parts), flush=True)
