#!/usr/bin/env python3
"""Runs one of ``chip_smoke.py``'s kernel phases several times back to back
in one process: the tile phase (every K3 and K7 case) or, with ``--phase
attend``, the attend phase's cases (K4-K6 and K8-K10 at every shape of
``chip_smoke.attend_shapes``; float32 and bfloat16; dropout off and on),
each held against its plain version and timed. It shows that the staged
ring of ``csrc/tile_walk.cuh`` and the row walk of ``csrc/attend_walk.cuh``
finish every launch, and how far the kernels' times spread. Run from the
repository root on a CUDA card:

    python3 soak_tiles.py [--reps 4] [--rep-limit 300] [--phase attend]

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


def _tile_cases(cora_gat, large):
    cora_gcn = load_cora(seed=0, layout="hybrid", device=cs.DEVICE).graph
    pubmed = load_pubmed_fullbatch(seed=0, layout="hybrid",
                                   device=cs.DEVICE).graph

    def run():
        cases = cs.phase_tile_kernels(cora_gcn, cora_gat, pubmed, large)
        return {f"{c['kernel']} {cs._tile_case(c)}": c for c in cases}
    return run


def _attend_cases(cora_gat, large):
    hub = cs._hub_hybrid()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(1)

    def run():
        cases = {}
        for dtype in (torch.float32, torch.bfloat16):
            for label, hg, heads, feat, reps in cs.attend_shapes(
                    cora_gat, hub, large):
                hg = cs._with_tile_dtype(hg, dtype)
                for dropping in (False, True):
                    for c in cs._attend_case(label, hg, heads, feat, dtype,
                                             dropping, gen, reps):
                        key = cs._attend_key(c)
                        cases[" ".join(map(str, key))] = c
        return cases
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--rep-limit", type=float, default=300.0)
    ap.add_argument("--phase", choices=("tiles", "attend"), default="tiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("soak_tiles: no CUDA device")
    cs.phase_device()
    cs.phase_build()
    cora_gat = load_cora(seed=0, layout="auto", layout_objective="attention",
                         device=cs.DEVICE, model="gat").graph
    large = cs._large_hybrid()
    run = (_tile_cases if args.phase == "tiles" else _attend_cases)(
        cora_gat, large)
    times: dict[str, list[float]] = {}
    for rep in range(args.reps):
        t0 = time.perf_counter()
        faulthandler.dump_traceback_later(args.rep_limit, exit=True)
        cases = run()
        torch.cuda.synchronize()
        faulthandler.cancel_dump_traceback_later()
        for key, c in cases.items():
            times.setdefault(key, []).append(c["kernel_ms"])
        cs.emit({"rep": rep, "seconds": time.perf_counter() - t0,
                 "cases": len(cases)})
    cs.emit({"soak": {"phase": args.phase, "reps": args.reps, "ms_min_max": {
        k: [min(v), max(v)] for k, v in times.items()}}})


if __name__ == "__main__":
    main()
