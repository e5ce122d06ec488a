"""Optional TensorBoard summary writing (BiNE parity).

A copy of ``graphneuralnetwork_tpu/utils/tb.py``.

The reference's BiNE trainer logs its three loss terms to TensorBoard
(BiNE/train_utils/train_eval.py:41,75-77). This shim prefers
``torch.utils.tensorboard`` and degrades to a JSONL event log
(``events.jsonl`` in the log directory) when no writer backend can be
imported, so training code can always call it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as _TB
            self._tb = _TB(log_dir=logdir)
        except Exception:
            self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None,
                   global_step: Optional[int] = None):
        # `global_step=` is torch SummaryWriter's keyword (used by ported
        # call sites, BiNE/train_utils/train_eval.py:75-77); `step=` kept
        # as the native spelling.
        if step is None:
            step = global_step
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._jsonl.write(json.dumps(
                {"ts": time.time(), "tag": tag,
                 "value": float(value), "step": step}) + "\n")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        elif not self._jsonl.closed:
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        elif not self._jsonl.closed:
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
