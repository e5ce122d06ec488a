"""What the harness's tests share: the repository's root, the mixes'
shape at a size a test run holds, and ``scan_loop.EpochGraph`` on the
CPU."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the mixes' shape at a size a test run holds
SMALL = {"nodes": 1536, "edges": 6000, "split": [768, 384, 384]}
#: a mix whose edges fall mostly inside communities of consecutive ids
#: (before the shuffle), so that the hybrid layout fills tiles
CLUSTERED = {"intra_share": 0.9, "community": 128}


class StubEpochGraph:
    """``scan_loop.EpochGraph`` on the CPU: the warm-up runs the epoch, the
    capture records it without running it, and each replay runs it."""

    def __init__(self, device, generator=None):
        self.epoch = None

    def warm_up(self, epoch):
        epoch()

    def capture(self, epoch):
        self.epoch = epoch

    def replay(self):
        self.epoch()
