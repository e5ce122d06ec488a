"""Stage-by-stage timing of the hybrid GAT attend on the card: the port of
the JAX package's ``tools/profile_attend.py``. Run from the repository
root:

    python -m graphneuralnetwork_tpu_torch.tools.profile_attend
        [--dtype bfloat16|float32] [--heads 8] [--feat 128] [--nodes 131072]
        [--edges 2097152] [--comm 256] [--min-edges-per-tile 192]
        [--stages nmax_tiles,...] [--device cuda|cpu]

It builds the JAX tool's community graph (numpy seed 0: ~90 % of the edges
inside blocks of ``--comm`` consecutive nodes) as a hybrid layout with
float32 tiles, draws ``x`` [N, H, F] in ``--dtype`` and float32 logits
from the same seed, and times each stage in isolation, forward only:

  nmax_tiles  K7, the tiles' neighbour max of f_src
  nmax_rem    K2, the remainder's segment max of f_src (read at the senders)
  tile_parts  K9, the tiles' softmax partials
  rem_parts   K8, the remainder's softmax partials
  fused       K10, the tile pass seeded with partials, divided
  epilogue    the plain PyTorch division of the partials
  three_pass  gat_tiled_attend_parts: K7, K2, K8, K10
  full        gat_tiled_attend: K4

The kernel stages take the JAX tool's stand-ins for the values that the
path would compute: ``m = 0`` (so the exponent's clamp at 0 bites) and
partials of ones. On the card each stage is timed with CUDA events (warmed,
median of batches: ``tools/timing.py``); with ``--device cpu`` (tests) the
plain versions run once each and only the host's clock is read. Each
stage's kernel launches are counted over one call (the counters are
read before and after it, not reset). ``main(argv)`` prints
the graph's line, one line per stage and a JSON line, and returns that
dict.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core.bcsr import COL_BLOCK, ROW_BLOCK, build_hybrid
from ..core.device import resolve_device
from ..ops.bcsr_attention import (_AttendFused, _RemParts, _TileParts,
                                  _rem_segment_max, bcsr_neighbor_max,
                                  gat_tiled_attend, gat_tiled_attend_parts)
from ..ops.cuda.counters import read_launches
from .timing import time_ms

STAGES = ("nmax_tiles", "nmax_rem", "tile_parts", "rem_parts", "fused",
          "epilogue", "three_pass", "full")
SLOPE = 0.2


def community_graph(n: int, e: int, comm: int, rng: np.random.Generator):
    """The JAX tool's graph: ``e`` random senders, 90 % of the receivers in
    the sender's block of ``comm`` nodes, self loops dropped."""
    s = rng.integers(0, n, e).astype(np.int64)
    intra = rng.random(e) < 0.9
    base = (s // comm) * comm
    r = np.where(intra, np.minimum(base + rng.integers(0, comm, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=131072)
    ap.add_argument("--edges", type=int, default=2_097_152)
    ap.add_argument("--comm", type=int, default=256)
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--min-edges-per-tile", type=int, default=192)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma list of: " + ",".join(STAGES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions, host clock)")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}")
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    card = _card() if on_card else None
    if card:
        print(card, flush=True)

    rng = np.random.default_rng(0)
    n, heads, feat = args.nodes, args.heads, args.feat
    s, r = community_graph(n, args.edges, args.comm, rng)
    hg = build_hybrid(s, r, n, min_edges_per_tile=args.min_edges_per_tile,
                      device=device)
    bg, rem = hg.bcsr, hg.rem
    graph = dict(nodes=n, edges=int(len(s)), tiled=hg.tiled_fraction,
                 tiles=bg.n_tiles,
                 fill=bg.n_edges / max(bg.n_tiles * ROW_BLOCK * COL_BLOCK, 1),
                 rem_edges=rem.n_edges)
    print(f"edges={graph['edges']} tiled={graph['tiled']:.3f} "
          f"tiles={graph['tiles']} fill={graph['fill']:.4f} "
          f"rem_edges={graph['rem_edges']}", flush=True)

    dtype = getattr(torch, args.dtype)
    x = torch.from_numpy(rng.normal(size=(n, heads, feat)).astype(
        np.float32)).to(device=device, dtype=dtype)
    fs = torch.from_numpy(rng.normal(size=(n, heads)).astype(
        np.float32)).to(device)
    fd = torch.from_numpy(rng.normal(size=(n, heads)).astype(
        np.float32)).to(device)
    x2 = x.reshape(n, heads * feat)
    # the JAX tool's stand-ins for the values the path would compute
    m0 = torch.zeros(n, heads, device=device)
    num0 = torch.ones(n, heads * feat, device=device)
    den0 = torch.ones(n, heads, device=device)
    num_x = num0.view(n, heads, feat).to(dtype)
    calls = {
        "nmax_tiles": lambda: bcsr_neighbor_max(bg, fs),
        "nmax_rem": lambda: _rem_segment_max(rem, fs),
        "tile_parts": lambda: _TileParts.apply(x2, fs, fd, m0, hg, None,
                                               SLOPE, 1.0),
        "rem_parts": lambda: _RemParts.apply(x2, fs, fd, m0, hg, None,
                                             SLOPE),
        "fused": lambda: _AttendFused.apply(x2, fs, fd, m0, num0, den0, hg,
                                            None, SLOPE, 1.0),
        "epilogue": lambda: (num_x + num0.view_as(num_x).to(dtype))
        / torch.clamp_min(den0 + den0, 1e-16)[:, :, None].to(dtype),
        "three_pass": lambda: gat_tiled_attend_parts(hg, x, fs, fd),
        "full": lambda: gat_tiled_attend(hg, x, fs, fd),
    }

    results = {}
    with torch.no_grad():
        for name in stages:
            fn = calls[name]
            before = read_launches()
            fn()
            if on_card:
                torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in read_launches().items()
                        if v != before[k]}
            if on_card:
                entry = {"ms": time_ms(fn)}
            else:
                t0 = time.perf_counter()
                fn()
                entry = {"ms": None,
                         "cpu_ms": (time.perf_counter() - t0) * 1e3}
            entry["launches"] = launches
            results[name] = entry
            shown = (f"{entry['ms']:9.4f} ms" if on_card
                     else f"{entry['cpu_ms']:9.2f} ms on the CPU")
            print(f"{name:12s} {shown}  launches {launches}", flush=True)
    out = {"tool": "profile_attend", "device": str(device), "card": card,
           "dtype": args.dtype, "heads": heads, "feat": feat,
           "min_edges_per_tile": args.min_edges_per_tile, "graph": graph,
           "stages": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
