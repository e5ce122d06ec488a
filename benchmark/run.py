#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card it is started on.

    python3 benchmark/run.py --workload gcn-arxiv-coo --seed 7 \
        --seconds 10 --trace 0

Prints a few JSON lines (tiled fraction, launches per epoch, set-up parts,
the card's clocks and power limit), then the result line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; those also end the standard error. Exits non-zero without a result
where there is no card, fewer cards than the cell asks for, or where the
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "benchmark"]

#: top-level module names that no benchmark process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "graphneuralnetwork_tpu")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def card_info() -> dict:
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not read: {exc}"}
    return {"nvidia_smi": dict(zip(query.split(","), out[0].split(", ")))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number")

    import torch

    from benchmark import cell, spec

    s = spec.load(args.workload)
    chips = int(s["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from graphneuralnetwork_tpu_torch.ops.cuda import build
    ages = {"after_imports": cell.process_age_s()}
    build.build()
    ages["after_kernel_build"] = cell.process_age_s()
    result, checks, info = cell.run_cell(s, args.seed, args.seconds,
                                         bool(args.trace), "cuda")
    info.append({"process_age_s": ages})
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    info.append(card_info())
    for line in info:
        print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
