"""Device time of one call on the card, by CUDA events."""

from __future__ import annotations

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
