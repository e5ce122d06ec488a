#!/usr/bin/env python3
"""Times the segment max (K2) of one checkout at ``chip_smoke.py``'s K2
shapes on one CUDA card, so that two designs can be compared in one call.
Run from a checkout's root:

    python3 time_segment_max.py [--tree DIR] [--reps 2] [--sweep]

It imports the port from ``--tree DIR`` (default: this checkout), builds
the graphs with that tree's builders from fixed seeds (the same graphs in
every tree), and times, per case: the K2 kernel alone (``kernel_ms``),
and, for the gathered cases, what the tree's path spends on them
(``path_ms``: a tree whose K2 takes per-edge values alone gathers them
with a PyTorch indexing kernel first; this PR's K2 reads the node table at
the senders). Cases: GAT-COO's per-edge scores on Cora (8 heads, 1), a
2M-edge random graph (8), a graph with a hub row (8); the remainders of
SAGE's Pubmed hybrid (500, 128), of the Cora GAT hybrid and of the 2M-edge
community graph (8). Every output is held against the plain version
exactly. Prints one JSON line per case and repetition, with the card's
name and power limit and a SHA-256 of each output. ``--sweep`` (this PR's
K2 only) also times every case at every row group the kernel takes (from
``lpe`` to 32 lanes) and with the rows' CTAs capped at 4, 8 or 16 an SM,
in place of ``segmax_layout``'s.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    from graphneuralnetwork_tpu_torch.core.bcsr import build_hybrid
    from graphneuralnetwork_tpu_torch.core.graph import build_graph
    from graphneuralnetwork_tpu_torch.data import (load_cora,
                                                   load_pubmed_fullbatch)
    from graphneuralnetwork_tpu_torch.ops.cuda import segment_max_kernel as k2
    from graphneuralnetwork_tpu_torch.ops.cuda.build import check, load
    from graphneuralnetwork_tpu_torch.ops.cuda.tile_walk import sm_count
    from graphneuralnetwork_tpu_torch.tools.timing import time_ms

    if not torch.cuda.is_available():
        sys.exit("time_segment_max: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gathers = "senders" in inspect.signature(k2.segment_max).parameters
    dev = "cuda"
    rng = np.random.default_rng(0)

    def random_graph(n, e):
        return build_graph(rng.integers(0, n, e), np.sort(
            rng.integers(0, n, e)), n, device=dev)

    def hub_graph():
        n = 65536
        r = np.concatenate([np.repeat(np.arange(n), 4),
                            np.zeros(32768, int)])
        return build_graph(rng.integers(0, n, r.shape[0]), r, n,
                           device=dev)

    def community(n=131072, e=2 ** 21, comm=256):
        s = rng.integers(0, n, e)
        intra = rng.random(e) < 0.9
        r = np.where(intra, np.minimum((s // comm) * comm
                                       + rng.integers(0, comm, e), n - 1),
                     rng.integers(0, n, e))
        keep = s != r
        return build_hybrid(s[keep], r[keep], n, device=dev)

    cora = load_cora(seed=0, layout="coo", device=dev).graph
    cora_hg = load_cora(seed=0, layout="auto", layout_objective="attention",
                        device=dev, model="gat").graph
    pubmed = load_pubmed_fullbatch(seed=0, layout="hybrid", device=dev).graph
    cases = [("cora", cora, 8, False), ("cora", cora, 1, False),
             ("large", random_graph(65536, 2 ** 21), 8, False),
             ("hub_row", hub_graph(), 8, False),
             ("pubmed_rem", pubmed.rem, 500, True),
             ("pubmed_rem", pubmed.rem, 128, True),
             ("cora_gat_rem", cora_hg.rem, 8, True),
             ("large_rem", community().rem, 8, True)]

    def sweep(label, g, c, src, gather, ref):
        """Every row group the kernel takes (lpe .. 32 lanes), each with
        the rows on a warp a row set or on at most 4, 8 or 16 CTAs an SM
        whose warps loop."""
        out = torch.empty_like(ref)
        sms = sm_count(0)
        base = k2.segmax_args(g, src, g.senders if gather else None, out,
                              torch.cuda.current_stream().cuda_stream, sms)
        lib = load("segment_max_kernel", k2._ENTRIES)
        group = base[8]   # lpe
        while group <= 32:
            for ctas in (0, 4 * sms, 8 * sms, 16 * sms):
                call_args = base[:9] + [group] + base[10:12] + [ctas] \
                    + base[13:]

                def call(call_args=call_args):
                    check(lib, lib.gnn_segment_max(*call_args),
                          "segment_max")
                out.fill_(0)
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"K2 {label} C={c} {call_args}")
                print(json.dumps({
                    "sweep": f"{label} C={c} "
                             f"{'gather' if gather else 'edges'}",
                    "group": group, "row_ctas": ctas,
                    "chosen": call_args[9:13] == base[9:13],
                    "kernel_ms": time_ms(call)}), flush=True)
            group *= 2

    gen = torch.Generator(device=dev).manual_seed(5)
    for rep in range(args.reps):
        for label, g, c, gather in cases:
            n, e = g.n_nodes, g.n_edges
            src = torch.randn(g.n_nodes if gather else g.n_edge_pad, c,
                              device=dev, generator=gen)
            rows = src[g.senders.long()] if gather else src

            def path(src=src, g=g, gather=gather):
                if gathers:
                    return k2.segment_max(g, src, g.senders if gather
                                          else None)
                vals = src[g.senders] if gather else src
                return k2.segment_max(vals.contiguous(), g.receivers,
                                      g.row_ptr, g.n_nodes)

            if gathers:
                kernel = path
            else:
                def kernel(rows=rows.contiguous(), g=g):
                    return k2.segment_max(rows, g.receivers, g.row_ptr,
                                          g.n_nodes)
            out = kernel()
            ref = k2.segment_max_plain(rows[:e], g.receivers[:e], n)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"K2 {label} C={c}: differs from the "
                                     "plain version")
            raw = out.contiguous().view(-1).view(torch.uint8).cpu().numpy()
            print(json.dumps({
                "tree": args.tree or ".", "card": card, "rep": rep,
                "case": f"{label} C={c} {'gather' if gather else 'edges'}",
                "kernel_ms": time_ms(kernel),
                "path_ms": time_ms(path) if gather else None,
                "sha256": hashlib.sha256(raw.tobytes()).hexdigest()}),
                flush=True)
            if args.sweep and rep == 0:
                sweep(label, g, c, src, gather, ref)


if __name__ == "__main__":
    main()
