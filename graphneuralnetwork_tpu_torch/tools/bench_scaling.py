"""Scaling efficiency of the halo-exchange SpMM: edges/s of ``spmm_halo``
on 1 vs N devices.

Port of the repo's ``tools/bench_scaling.py`` onto ``torch.distributed``,
one process per device. Weak scaling: each device owns a fixed (nodes,
edges) workload, so ideal scaling keeps the time constant as devices are
added; efficiency = t(1) / t(N). Strong scaling: the global graph is
fixed; efficiency = t(1) / (N · t(N)). Each size of ``--devices`` is a
sub-mesh of one world (``make_mesh(devices=...)``, which every rank
creates); ranks outside it wait. The timed chain is ``spmm_halo`` (K1 on
CUDA, over the interior and boundary edges, after one ``all_to_all`` of
the halo rows), ``ITERS`` calls each feeding the next, the best of 3
chains after a warm-up, divided by ``ITERS``.

    torchrun --standalone --nproc_per_node N \\
        -m graphneuralnetwork_tpu_torch.tools.bench_scaling [--mode weak]
    python -m graphneuralnetwork_tpu_torch.tools.bench_scaling --device cpu

Prints one JSON line a size and a summary line (from the primary),
with JAX's keys; ``platform`` (the backend: ``nccl`` or ``gloo``; no
process group: the device's type) takes the place of
``cpu_virtual_mesh``. The boundary and halo statistics bound the exchange's
traffic on any interconnect; a time on gloo is not a time on the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.halo import (partition_graph_halo,
                             partition_graph_halo_clustered,
                             shard_nodes_halo, spmm_halo)
from ..parallel.multihost import (initialize_distributed, is_primary,
                                  make_mesh, process_count)

#: ``spmm_halo`` calls in one timed chain
ITERS = 8


def _build_inputs(n_nodes, n_edges, f, n_parts=1, cross_frac=0.05, seed=0,
                  clustered=True):
    """Clustered graphs (default) model a METIS-partitioned real graph:
    each device's node range forms a community and only ``cross_frac`` of
    edges cross partitions. ``clustered=False`` gives the adversarial
    random graph where nearly every edge is boundary."""
    rng = np.random.default_rng(seed)
    if not clustered or n_parts == 1:
        s = rng.integers(0, n_nodes, n_edges)
        r = rng.integers(0, n_nodes, n_edges)
    else:
        per = n_nodes // n_parts
        part = rng.integers(0, n_parts, n_edges)
        r = part * per + rng.integers(0, per, n_edges)
        cross = rng.random(n_edges) < cross_frac
        s_part = np.where(cross, rng.integers(0, n_parts, n_edges), part)
        s = s_part * per + rng.integers(0, per, n_edges)
    w = np.ones(n_edges, np.float32)
    x = rng.normal(size=(n_nodes, f)).astype(np.float32)
    return s, r, w, x


def halo_stats(hg, n_edges: int) -> dict:
    """What fraction of edges need remote senders, and how many rows each
    device ships a layer (JAX's keys; empty on one device)."""
    n_dev = hg.n_devices
    if n_dev == 1:
        return {}
    bnd_edges = int((hg.bnd_weight != 0).sum())
    return dict(
        boundary_edge_frac=round(bnd_edges / max(n_edges, 1), 4),
        halo_rows_per_device=int((n_dev - 1) * hg.halo_size),
        local_rows_per_device=int(hg.nodes_per_shard),
        halo_to_local_ratio=round(
            (n_dev - 1) * hg.halo_size / max(hg.nodes_per_shard, 1), 3),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_spmm(mesh, s, r, w, x, n_nodes, clustered_partition=False):
    """(seconds a call, stats) on ``mesh``; None for the time on a rank
    outside it."""
    if clustered_partition and mesh.size > 1:
        hg, perm = partition_graph_halo_clustered(s, r, n_nodes, w,
                                                  mesh=mesh)
        x = x[perm]
    else:
        hg = partition_graph_halo(s, r, n_nodes, w, mesh=mesh)
    stats = halo_stats(hg, len(s))
    if not mesh.live:
        return None, stats
    xs = shard_nodes_halo(x, hg)
    device = mesh.device

    def chain(xs):
        for _ in range(ITERS):
            out = spmm_halo(hg, xs)
            xs = out * 1e-3 + xs * 0.5
        return xs

    with torch.no_grad():
        chain(xs)
        _sync(device)
        best = float("inf")
        for _ in range(3):
            if mesh.group is not None:
                dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            chain(xs)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
    return best / ITERS, stats


def _platform(device: torch.device) -> str:
    return dist.get_backend() if dist.is_initialized() else device.type


def main(argv=None) -> dict:
    """Run the sweep; returns the summary (every rank), printed by the
    primary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--nodes-per-dev", type=int, default=16384)
    ap.add_argument("--edges-per-dev", type=int, default=262144)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--graph", choices=["clustered", "random", "shuffled"],
                    default="clustered",
                    help="'shuffled' hides a community structure behind "
                         "random node ids and partitions via "
                         "partition_graph_halo_clustered (cluster → slice "
                         "→ tiled interiors) — the full locality pipeline")
    ap.add_argument("--cross-frac", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    initialize_distributed(device=args.device)
    n_avail = process_count()
    sizes = args.devices or [d for d in (1, 2, 4, 8) if d <= n_avail]
    if max(sizes) > n_avail:
        raise ValueError(f"--devices {sizes} exceed the {n_avail} processes")

    results = []
    t1 = device = None
    for nd in sizes:
        if args.mode == "weak":
            n_nodes = args.nodes_per_dev * nd
            n_edges = args.edges_per_dev * nd
        else:
            n_nodes = args.nodes_per_dev * max(sizes)
            n_edges = args.edges_per_dev * max(sizes)
        s, r, w, x = _build_inputs(
            n_nodes, n_edges, args.features, n_parts=nd,
            cross_frac=args.cross_frac,
            clustered=(args.graph != "random"))
        if args.graph == "shuffled":
            # hide the structure; the clustered partitioner must recover it
            rng_sh = np.random.default_rng(7)
            shuffle = rng_sh.permutation(n_nodes)
            s, r = shuffle[s], shuffle[r]
            inv = np.argsort(shuffle)
            x = x[inv]          # feature row of new id j = old node inv[j]
        mesh = make_mesh(devices=list(range(nd)), device=args.device)
        device = mesh.device
        t, stats = _time_spmm(mesh, s, r, w, x, n_nodes,
                              clustered_partition=(args.graph ==
                                                   "shuffled"))
        # the primary (rank 0, in every sub-mesh) holds every time
        if not results:
            t1, eff = t, 1.0
        elif t is None or t1 is None:
            eff = None
        elif args.mode == "weak":
            eff = t1 / t
        else:
            eff = t1 / (nd * t)
        results.append(dict(
            devices=nd, seconds=None if t is None else round(t, 6),
            edges_per_s=None if t is None else round(n_edges / t, 1),
            efficiency=None if eff is None else round(eff, 4), **stats))
        if is_primary():
            print(json.dumps(results[-1]), flush=True)
        if dist.is_initialized():
            dist.barrier()

    summary = {
        "metric": f"halo_spmm_{args.mode}_scaling_efficiency",
        "value": results[-1]["efficiency"],
        "unit": "ratio",
        # gloo on CPU processes shares the host's cores: its wall-time
        # efficiency says nothing of the card; the boundary/halo stats are
        # the hardware-independent signal
        "platform": _platform(device),
        "detail": results,
    }
    if is_primary():
        print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
