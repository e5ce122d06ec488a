#!/usr/bin/env python3
"""The readings that a cell's limits are set from, other than the program's
own (which every run prints under ``checks``):

* the control: the reference with TF32 on, the precision below the
  configuration's (float32, TF32 off), in the program's place;
* the fault of half the batch left out (the loss's mean over the first
  half of the training rows), planted in the reference in the program's
  place.

Each is judged as a cell judges the program: against the reference doing
each of its steps again from the state it held before that step.

A state left unchanged reads 1 on ``change_gap`` and needs no run. Each
run uses the cell's sizes, its generated inputs and initial weights, and
dropout masks drawn from the seed. The benchmark's own runs do not run
this.

    python3 benchmark/control.py --workload gcn-arxiv-coo --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:] = [str(Path(__file__).resolve().parents[1])] + [
    p for p in sys.path
    if Path(p or ".").resolve() != Path(__file__).resolve().parent]

import torch  # noqa: E402

from benchmark import check, generate, spec  # noqa: E402
from benchmark.reference import gnn  # noqa: E402


def random_masks(cfg: dict, n: int, e: int, seed: int, device) -> list:
    """Dropout multipliers at the model's sites (``dropout_sites``) for
    each step."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = 1.0 - cfg["dropout"]
    rows = {"nodes": n, "edges": e}
    sites = gnn.model(cfg).dropout_sites(cfg)
    return [{k: (torch.rand((rows[kind], width), generator=gen,
                            device=device) < p) / p
             for k, (kind, width) in sites.items()}
            for _ in range(check.CHECK_STEPS)]


def readings(workload: str, seed: int, device) -> dict:
    s = spec.load(workload)
    cfg = s["config"]
    ds = generate.make_dataset(s["mix"], seed, device)
    params0 = gnn.initial_params(cfg, generate.sub_seed(seed, 1), device)
    edges = gnn.canonical_edges(ds.senders, ds.receivers, ds.n_nodes, device)
    masks = random_masks(cfg, ds.n_nodes, int(edges.recv.shape[0]),
                         generate.sub_seed(seed, 2), device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    inputs = (ds.features, dev(ds.labels), dev(ds.train_idx),
              dev(ds.val_idx), edges, masks)

    def judged(**fault) -> dict[str, float]:
        """The run in the program's place, judged as a cell judges the
        program: the reference does each of its steps again from the
        state that run held before it."""
        run = gnn.train_steps(cfg, params0, *inputs, **fault)
        return check.numbers(run, gnn.follow(cfg, run.states, *inputs))

    return {"workload": workload, "seed": seed,
            "control_tf32": judged(tf32=True),
            "half_batch": judged(half_batch=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
