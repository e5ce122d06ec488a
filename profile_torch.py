#!/usr/bin/env python3
"""Where a training epoch of the PyTorch port goes on the card. Run from
the repository root:

    python3 profile_torch.py --model gcn|gat [--layout hybrid]
                             [--dtype bfloat16]
    python3 profile_torch.py --model graphsage --layout hybrid
                             [--aggregator mean|sum|max] [--dtype bfloat16]

Trains the CLI's model on its data (GCN and GAT: Cora, on the COO layout
or the CLI's hybrid: sym-normalised tiles for GCN, unit weights for GAT;
GraphSAGE: the Pubmed hybrid) and measures two kinds of epoch block on the
same state, in one run: the eager block (``run_epochs``: every kernel
launched from the host) after ``WARMUP`` epochs, and then the captured
block that the CLI trains in (``make_scanned_node_classification_run``:
one epoch captured as a CUDA graph and replayed), after its first block
(warm-up epoch, capture, replays). For each, a block of ``EPOCHS`` epochs
is timed with CUDA synchronisation (no profiler), then another is traced
under ``torch.profiler``. Prints one JSON line: per block kind, wall ms per
epoch (untraced and traced), device kernel ms per epoch, the device's busy
share (kernel time over untraced wall time), kernel launches per epoch,
the kernels that take the most device time, and the device ms per epoch
of three families by name: PyTorch's indexing backward (the backward of an
index gather, which sorts its indices), its sorts, and the port's K1
(``segment_sum_kernel``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from graphneuralnetwork_tpu_torch.core.device import resolve_device
from graphneuralnetwork_tpu_torch.data import load_cora, load_pubmed_fullbatch
from graphneuralnetwork_tpu_torch.nn import GAT, GCN, GraphSAGE
from graphneuralnetwork_tpu_torch.train.loop import (create_train_state,
                                                     make_eval_fn)
from graphneuralnetwork_tpu_torch.train.scan_loop import (
    make_scanned_node_classification_run, run_epochs)
from graphneuralnetwork_tpu_torch.train.schedule import make_optimizer

WARMUP, EPOCHS, TOP = 20, 50, 8
#: kernel families whose device time is summed by name (a substring)
FAMILIES = {"indexing_backward": "indexing_backward",
            "sort": "Sort", "K1": "segment_sum_kernel"}


def _measure(block) -> dict:
    """One block of ``EPOCHS`` epochs timed, then one traced."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / EPOCHS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / EPOCHS
    # device-side events, without user annotations such as the
    # optimizer's "Optimizer.step#AdamW.step" range
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    device_ms = sum(by_name.values()) / 1e3 / EPOCHS
    return {
        "wall_ms_per_epoch": wall_ms,
        "traced_wall_ms_per_epoch": traced_ms,
        "device_ms_per_epoch": device_ms if kernels else None,
        # against the untraced wall time: tracing slows the host only
        "device_busy_share": device_ms / wall_ms if kernels else None,
        "launches_per_epoch": len(kernels) / EPOCHS,
        "top_kernels_ms_per_epoch": {
            name[:80]: us / 1e3 / EPOCHS
            for name, us in by_name.most_common(TOP)},
        "families_ms_per_epoch": {
            fam: sum(us for name, us in by_name.items() if key in name)
            / 1e3 / EPOCHS for fam, key in FAMILIES.items()},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=["gcn", "gat", "graphsage"],
                    default="gcn")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--layout", choices=["coo", "hybrid"], default="coo",
                    help="hybrid: GCN on K3 + K1, GAT on K4-K6, GraphSAGE "
                         "(hybrid only) on K3 + K1 or K7 + K2")
    ap.add_argument("--aggregator", choices=["mean", "sum", "max"],
                    default="mean", help="GraphSAGE's aggregator")
    args = ap.parse_args(argv)
    if args.model == "graphsage" and args.layout != "hybrid":
        ap.error("--model graphsage profiles the hybrid layout only")
    device = resolve_device("cuda")
    cdtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    if args.model == "graphsage":
        data = load_pubmed_fullbatch(seed=0, layout="hybrid", device=device)
    else:
        data = load_cora(seed=0, layout=args.layout, device=device,
                         model=args.model, tile_dtype=cdtype or torch.float32)
    f = int(data.features.shape[1])
    if args.model == "gcn":
        model = GCN(f, hidden=128, num_classes=data.num_classes, dtype=cdtype)
        opt = make_optimizer("adamw", 2e-3, weight_decay=5e-4)
    elif args.model == "graphsage":
        model = GraphSAGE(f, hidden_dims=(128,), num_classes=data.num_classes,
                          aggregator=args.aggregator, dtype=cdtype)
        opt = make_optimizer("adamw", 1e-2, weight_decay=1e-4)
    else:
        model = GAT(f, hidden=8, num_heads=8, num_classes=data.num_classes,
                    dtype=cdtype)
        opt = make_optimizer("adamw", 1e-2, weight_decay=5e-4)
    state = create_train_state(model, data, 0, opt)
    evaluate = make_eval_fn(model)
    run_epochs(state, data, evaluate, WARMUP)
    eager = _measure(lambda: run_epochs(state, data, evaluate, EPOCHS))
    run = make_scanned_node_classification_run(model, EPOCHS)
    run(state, data)
    captured = _measure(lambda: run(state, data))
    result = {
        "model": args.model, "dtype": args.dtype, "layout": args.layout,
        "aggregator": args.aggregator if args.model == "graphsage" else None,
        "epochs": EPOCHS,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0],
        "eager": eager,
        "captured": captured,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
