#!/usr/bin/env python3
"""Times the steps of the attend walk apart for K8, K9 and K10 (the three
modes of ``csrc/attend_fused_kernel.cu``) on one CUDA card. Run from the
repository root:

    python3 time_walk_steps.py [--cases cora:8x8,hub:8x8] [--kernels K8]
                               [--dtypes float32,bfloat16]

It builds the kernel's source four times with nvcc into
``build/walk_steps/``: as the port builds it (``all``) and with
``GNN_WALK_STOP`` 1, 2 and 3, where each warp stops before its first batch
(``stop1``: set-up, the row's first loads, the reductions and the
stores), after each batch's per-edge step (``stop2``: the senders,
weights and dropout words) and after its per-(edge, head) step
(``stop3``: ``p`` from ``f_src``). A step's cost is the difference
between two successive builds; ``all`` minus ``stop3`` is the per-column
step (the gathered ``x`` rows). For each case (a graph of
``chip_smoke.attend_shapes`` and a head layout, with attention dropout)
and kernel it times every build on the same operands
(``tools/timing.time_ms``) beside the launch floor, and holds the ``all``
build against the kernel's plain version. Prints one JSON line per case,
each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from graphneuralnetwork_tpu_torch.core.bcsr import build_hybrid
from graphneuralnetwork_tpu_torch.data import load_cora
from graphneuralnetwork_tpu_torch.ops import bcsr_attention
from graphneuralnetwork_tpu_torch.ops.cuda import attend_parts_kernel as k910
from graphneuralnetwork_tpu_torch.ops.cuda import build
from graphneuralnetwork_tpu_torch.ops.cuda import rem_attend_kernel as k8
from graphneuralnetwork_tpu_torch.ops.cuda import segment_max_kernel as k2
from graphneuralnetwork_tpu_torch.tools.timing import time_ms

OUT = Path(__file__).resolve().parent / "build" / "walk_steps"
STEPS = {"all": [], "stop1": ["-DGNN_WALK_STOP=1"],
         "stop2": ["-DGNN_WALK_STOP=2"], "stop3": ["-DGNN_WALK_STOP=3"]}
ENTRY = {"K8": "gnn_rem_attend", "K9": "gnn_tile_parts",
         "K10": "gnn_attend_fused"}
KEEP = 0.4


def _libs() -> dict[str, ctypes.CDLL]:
    """The four builds, compiled in parallel, each with its entries
    declared."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / "attend_fused_kernel.cu"
    jobs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o",
         str(OUT / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, flags in STEPS.items()}
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n"
                               f"{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for entry, argtypes in k910.WALK_ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def _graphs() -> dict:
    cora = load_cora(seed=0, layout="auto", layout_objective="attention",
                     device="cuda", model="gat").graph
    hub_s, hub_r, hub_n = cs._hub_graph()
    return {"cora": cora, "hub": cs._hub_hybrid(),
            "hub_t": cs._hub_hybrid(transpose=True),
            "hub_rem": build_hybrid(hub_s, hub_r, hub_n,
                                    min_edges_per_tile=cs.HUB_NO_TILES,
                                    device="cuda"),
            "large": cs._large_hybrid()}


def _case(hg, heads, feat, dtype, gen, stream):
    """Per kernel, (arguments, plain outputs, outputs); under "operands"
    the tensors the arguments point to, which must outlive the launches."""
    n = hg.n_nodes

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = randn(n, heads * feat).to(dtype)
    fs, fd = randn(n, heads), randn(n, heads)
    if hg.bcsr.n_edges:
        m = bcsr_attention.three_pass_shift(hg, fs, fd, 0.2)
    else:   # as chip_smoke._rem_split_cases: the shift on the CPU
        m = bcsr_attention.three_pass_shift(hg.to("cpu"), fs.cpu(),
                                            fd.cpu(), 0.2).cuda()
    bits, keep_mul = bcsr_attention.draw_dropout(hg, heads, KEEP, gen)
    num, den = torch.empty(n, heads * feat, device="cuda"), torch.empty(
        n, heads, device="cuda")
    r_num, r_den = k8.rem_attend_plain(hg, x, fs, fd, m, keep_mul, 0.2)
    return {
        "K8": (k8.rem_attend_args(hg, x, fs, fd, m, keep_mul, num, den, 0.2,
                                  stream), (r_num, r_den), (num, den)),
        "K9": (k910.tile_parts_args(hg, x, fs, fd, m, bits, num, den, 0.2,
                                    KEEP, stream),
               k910.tile_parts_plain(hg, x, fs, fd, m, bits, 0.2, KEEP),
               (num, den)),
        "K10": (k910.attend_fused_args(hg, x, fs, fd, m, r_num, r_den, bits,
                                       num, den, 0.2, KEEP, stream),
                k910.attend_fused_plain(hg, x, fs, fd, m, r_num, r_den, bits,
                                        0.2, KEEP), (num, den)),
        "operands": (x, fs, fd, m, bits, keep_mul, r_num, r_den)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="cora:8x8,cora:1x7,cora:1x50,"
                    "cora:3x42,hub:8x8,hub_t:8x8,hub_t:1x251,hub_rem:8x8,"
                    "large:8x128")
    ap.add_argument("--kernels", default="K8,K9,K10")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_walk_steps: no CUDA device")
    card = cs.phase_device()
    cs.phase_build()
    libs = _libs()
    graphs = _graphs()
    floor = time_ms(lambda: k2.launch_floor(torch.device("cuda")))
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for spec in args.cases.split(","):
        label, shape = spec.split(":")
        heads, feat = map(int, shape.split("x"))
        for dname in args.dtypes.split(","):
            dtype = getattr(torch, dname)
            hg = cs._with_tile_dtype(graphs[label], dtype)
            ops = _case(hg, heads, feat, dtype, gen, stream)
            for kern in args.kernels.split(","):
                if kern != "K8" and hg.bcsr.n_edges == 0:
                    continue   # no tile slot: K9 and K10 walk nothing
                kargs, ref, out = ops[kern]
                row = {"kernel": kern, "graph": label, "dtype": dname,
                       "shape": [hg.n_nodes, heads, feat], "dropout": True,
                       "card": card, "launch_floor_ms": floor}
                for name, lib in libs.items():
                    fn = getattr(lib, ENTRY[kern])
                    build.check(lib, fn(*kargs), f"{kern} {name}")
                    torch.cuda.synchronize()
                    if name == "all":
                        cs._held(kern, f"{spec} {dname}",
                                 [("num", out[0], ref[0], "float32"),
                                  ("den", out[1], ref[1], "float32")])
                    row[f"{name}_ms"] = time_ms(lambda f=fn: f(*kargs))
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
