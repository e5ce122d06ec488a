#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s tile phase (every K3 and K7 case, held against
its plain version and timed) several times back to back in one process, to
show that the staged ring of ``csrc/tile_walk.cuh`` finishes every launch.
Run from the repository root on a CUDA card:

    python3 soak_tiles.py [--reps 4] [--rep-limit 300]

A repetition that takes longer than ``--rep-limit`` seconds (a kernel that
never returns) dumps the Python stack and exits 1; a case that disagrees
with its plain version raises. Prints a JSON line per case, then one line
per repetition and, last, ``{"soak": {...}}`` with every case's fastest and
slowest time over the repetitions.
"""

from __future__ import annotations

import argparse
import faulthandler
import sys
import time

import torch

import chip_smoke as cs
from graphneuralnetwork_tpu_torch.data import load_cora, load_pubmed_fullbatch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--rep-limit", type=float, default=300.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("soak_tiles: no CUDA device")
    cs.phase_device()
    cs.phase_build()
    cora_gat = load_cora(seed=0, layout="auto", layout_objective="attention",
                         device=cs.DEVICE, model="gat").graph
    cora_gcn = load_cora(seed=0, layout="hybrid", device=cs.DEVICE).graph
    pubmed = load_pubmed_fullbatch(seed=0, layout="hybrid",
                                   device=cs.DEVICE).graph
    large = cs._large_hybrid()
    times: dict[str, list[float]] = {}
    for rep in range(args.reps):
        t0 = time.perf_counter()
        faulthandler.dump_traceback_later(args.rep_limit, exit=True)
        cases = cs.phase_tile_kernels(cora_gcn, cora_gat, pubmed, large)
        torch.cuda.synchronize()
        faulthandler.cancel_dump_traceback_later()
        for c in cases:
            times.setdefault(f"{c['kernel']} {cs._tile_case(c)}",
                             []).append(c["kernel_ms"])
        cs.emit({"rep": rep, "seconds": time.perf_counter() - t0,
                 "cases": len(cases)})
    cs.emit({"soak": {"reps": args.reps, "ms_min_max": {
        k: [min(v), max(v)] for k, v in times.items()}}})


if __name__ == "__main__":
    main()
