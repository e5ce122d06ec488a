"""Device time of one call on the card: by CUDA events (``time_ms``) and
by the profiler's kernel durations (``kernel_ms``)."""

from __future__ import annotations

import collections
import statistics

import torch


def time_ms(fn, reps: int = 7, batch: int = 20) -> float:
    """Median device time of one call, in ms. A long sleep kernel holds the
    stream while the host queues a batch, so the events time the calls
    back to back on the card, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def kernel_ms(fn, top: int = 0):
    """The device time of one call of ``fn``: its kernels' (and copies')
    durations summed by ``torch.profiler``, ms; with ``top``, also the
    ``top`` costliest kernels' ms by name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.time_range.elapsed_us()
    total = sum(by_name.values()) / 1e3
    if not top:
        return total
    return total, {name[:80]: us / 1e3
                   for name, us in by_name.most_common(top)}
