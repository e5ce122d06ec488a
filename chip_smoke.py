#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphneuralnetwork_tpu_torch) on one
NVIDIA Hopper card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — needs a CUDA device; prints the card's name and power limit
               as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
  2. build   — compiles every kernel of ``csrc/`` with nvcc, in parallel;
  3. kernels — holds each kernel against its plain PyTorch version, on the
               card, at the shapes the main path gives it and at one large
               shape, and times kernel, plain version and one library call
               (CUDA events, warmed, median);
  4. path    — GCN and GAT on the Cora graph, kernels against plain
               versions end to end: logits and gradients on the card agree
               with the same model on the CPU;
  5. gcn     — the main path: ``--model gcn`` through the CLI entry point
               (auto layout -> COO), 200 epochs; K1 must have launched;
  6. gat     — ``--model gat --layout coo``, 50 epochs; K1 and K2 must have
               launched.
Then a ``kernels`` summary line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without the last line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from graphneuralnetwork_tpu_torch.cli import main as cli_main
from graphneuralnetwork_tpu_torch.data import load_cora
from graphneuralnetwork_tpu_torch.nn import GAT, GCN
from graphneuralnetwork_tpu_torch.ops.cuda import build
from graphneuralnetwork_tpu_torch.ops.cuda import segment_max_kernel as k2
from graphneuralnetwork_tpu_torch.ops.cuda import spmm_kernel as k1
from graphneuralnetwork_tpu_torch.train.metrics import (
    masked_softmax_cross_entropy)

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 rate
#: outside the tensor cores — K1 accumulates and K2 compares in float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
DEVICE = "cuda"
GCN_EPOCHS, GAT_EPOCHS = 200, 50
LARGE_NODES, LARGE_EDGES = 65536, 2 ** 21
#: Kernel vs plain version: |kernel - plain| <= rtol * |plain| + atol * S,
#: with S the row's sum of |values|. Both sum in float32 in different
#: orders (the plain version with atomics), which costs up to ~n * 2^-24 * S
#: for an n-edge row; atol = 1e-5 covers rows of ~100 edges at that worst
#: case. bf16: both round a float32 sum once, so they may also differ by
#: one bf16 step (2^-7 of the value). Segment max is exact.
TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 1e-5),
       "max": (0.0, 0.0)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 7, batch: int = 20) -> float:
    """Median device time of one call, in ms. A long sleep kernel holds the
    stream while the host queues a batch, so the events time the calls
    back to back on the card, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    """The least time for the work, in ms: the larger of the bytes over the
    memory rate and the float32 operations over their peak rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": build.kernel_names(), "ptxas": ptxas})


def _large_graph(gen):
    recv = torch.randint(0, LARGE_NODES, (LARGE_EDGES,), device=DEVICE,
                         generator=gen).sort().values.int()
    counts = torch.bincount(recv, minlength=LARGE_NODES)
    row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    return recv, row_ptr.contiguous(), LARGE_NODES


def _check(name, out, ref, tol_key, abs_sum=None):
    rtol, atol = TOL[tol_key]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = abs_sum if abs_sum is not None else torch.zeros_like(diff)
    ok = bool((diff <= rtol * ref.float().abs() + atol * scale).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, rtol {rtol}, "
                             f"atol {atol})")
    return err, rtol, atol


def _k1_case(values, recv, row_ptr, n, label):
    """K1 on ``values`` against its plain version. Only the ``row_ptr[-1]``
    spanned edges count (Cora's padding does not), so the plain version,
    the library call and the bound all take those edges alone."""
    elt = values.element_size()
    f = values.shape[1]
    e = int(row_ptr[-1])
    vals, rec = values[:e], recv[:e]
    out = k1.segment_sum(values, recv, row_ptr, n)
    ref = k1.segment_sum_plain(vals, rec, n)
    torch.cuda.synchronize()
    dtype = str(values.dtype).replace("torch.", "")
    abs_sum = k1.segment_sum_plain(vals.float().abs(), rec, n)
    err, rtol, atol = _check(f"K1 {label}", out, ref, dtype, abs_sum)
    lib_out = torch.zeros(n, f, dtype=values.dtype, device=DEVICE)
    n_bytes = e * f * elt + (n + 1) * 4 + n * f * elt
    b_ms, b_by = bound(n_bytes, e * f)
    return dict(
        kernel="K1", shape=list(values.shape), edges_read=e, dtype=dtype,
        n_out=n, graph=label, max_abs_err=err, rtol=rtol, atol=atol,
        kernel_ms=time_ms(lambda: k1.segment_sum(values, recv, row_ptr, n)),
        plain_ms=time_ms(lambda: k1.segment_sum_plain(vals, rec, n)),
        library_ms=time_ms(lambda: lib_out.index_add_(0, rec, vals)),
        library="index_add_", bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)


def _k2_case(scores, recv, row_ptr, n, label):
    """K2 against its plain version, over the spanned edges as in K1."""
    h = scores.shape[1]
    e = int(row_ptr[-1])
    sc, rec = scores[:e], recv[:e]
    out = k2.segment_max(scores, recv, row_ptr, n)
    ref = k2.segment_max_plain(sc, rec, n)
    torch.cuda.synchronize()
    err, rtol, atol = _check(f"K2 {label}", out, ref, "max")
    lib_out = torch.full((n, h), k2.EMPTY, device=DEVICE)
    idx = rec.long()[:, None].expand(-1, h)
    n_bytes = e * h * 4 + (n + 1) * 4 + n * h * 4
    b_ms, b_by = bound(n_bytes, e * h)
    return dict(
        kernel="K2", shape=list(scores.shape), edges_read=e,
        dtype="float32", n_out=n, graph=label, max_abs_err=err, rtol=rtol,
        atol=atol,
        kernel_ms=time_ms(lambda: k2.segment_max(scores, recv, row_ptr, n)),
        plain_ms=time_ms(lambda: k2.segment_max_plain(sc, rec, n)),
        library_ms=time_ms(lambda: lib_out.scatter_reduce_(
            0, idx, sc, "amax", include_self=True)),
        library="scatter_reduce_", bound_ms=b_ms, bound_by=b_by,
        bytes=n_bytes)


def phase_kernels(cora) -> list[dict]:
    """Cora's padding edges get random values too: the kernels must ignore
    them, as the plain versions do."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    g = cora.graph
    graphs = {"cora": (g.receivers, g.row_ptr, g.n_nodes, g.n_edge_pad),
              "large": _large_graph(gen) + (LARGE_EDGES,)}
    cases = []
    # main-path widths: GCN 128 and 7; GAT 64 (8 heads x 8), 8 (its
    # softmax denominator), 7 and 1 (output layer)
    for dtype in (torch.float32, torch.bfloat16):
        for label, f in [("cora", f) for f in (128, 7, 64, 8, 1)] + [
                ("large", 128)]:
            recv, row_ptr, n, e = graphs[label]
            values = torch.randn(e, f, device=DEVICE, generator=gen)
            cases.append(_k1_case(values.to(dtype), recv, row_ptr, n, label))
            emit({"phase": "kernels", **cases[-1]})
    # the same main-path case with row spans over the padded edge list
    # (the last row then holds all padding edges): what skipping them buys
    padded_ptr = torch.cat([g.row_ptr[:-1], g.row_ptr.new_tensor(
        [g.n_edge_pad])])
    values = torch.randn(g.n_edge_pad, 128, device=DEVICE, generator=gen)
    cases.append(_k1_case(values, g.receivers, padded_ptr, g.n_nodes,
                          "cora_padded_spans"))
    emit({"phase": "kernels", **cases[-1]})
    for label, h in (("cora", 8), ("cora", 1), ("large", 8)):
        recv, row_ptr, n, e = graphs[label]
        scores = torch.randn(e, h, device=DEVICE, generator=gen)
        cases.append(_k2_case(scores, recv, row_ptr, n, label))
        emit({"phase": "kernels", **cases[-1]})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "cases": len(cases)})
    return cases


def phase_path(cora) -> None:
    """The models with the kernels (card) against the plain versions (CPU)
    on the Cora graph: same weights, dropout off, float32."""
    t0 = time.perf_counter()
    cpu_graph = cora.graph.to("cpu")
    x_cpu, y_cpu = cora.features.cpu(), cora.labels.cpu()
    idx = torch.arange(140)
    report = {}
    for name, make in (("gcn", lambda: GCN(x_cpu.shape[1], hidden=128,
                                           num_classes=cora.num_classes)),
                       ("gat", lambda: GAT(x_cpu.shape[1], hidden=8,
                                           num_heads=8,
                                           num_classes=cora.num_classes))):
        ref, dev = make(), make()
        ref.reset_parameters(torch.Generator().manual_seed(1))
        dev.load_state_dict(ref.state_dict())
        dev.to(DEVICE)
        outs = []
        for model, graph, x, y in ((ref, cpu_graph, x_cpu, y_cpu),
                                   (dev, cora.graph, cora.features,
                                    cora.labels)):
            model.eval()
            logits = model(graph, x)
            masked_softmax_cross_entropy(logits[idx.to(x.device)],
                                         y[idx.to(x.device)]).backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.cpu() for k, p in
                          model.named_parameters()}))
        (lr, gr), (ld, gd) = outs
        if not torch.isfinite(ld).all() or ld.shape != lr.shape:
            raise AssertionError(f"{name}: bad logits on the card")
        scale = float(lr.abs().max())
        err = float((ld - lr).abs().max()) / scale
        # gradients relative to the model's largest entry: the attention
        # vectors' gradients cancel to ~1e-4 of it
        gscale = max(float(g.abs().max()) for g in gr.values())
        gerr = max(float((gd[k] - g).abs().max())
                   for k, g in gr.items()) / gscale
        if err > 1e-4 or gerr > 1e-3:
            raise AssertionError(f"{name}: card vs CPU logits rel err {err}, "
                                 f"grad rel err {gerr}")
        report[name] = dict(logits_rel_err=err, grad_rel_err=gerr)
    emit({"phase": "path", "seconds": time.perf_counter() - t0,
          "tolerance": {"logits": 1e-4, "grads": 1e-3}, **report})


def _drive(phase, argv, expect):
    """Run the CLI with the launch counts set to 0 just before and read
    just after; ``expect`` maps each kernel to its launches per epoch and
    per evaluation."""
    k1.segment_sum.launches = 0
    k2.segment_max.launches = 0
    t0 = time.perf_counter()
    res = cli_main(argv)
    launches = {"K1": k1.segment_sum.launches,
                "K2": k2.segment_max.launches}
    seconds = time.perf_counter() - t0
    epochs = res["epochs"]
    for kern, (per_epoch, per_eval) in expect.items():
        want = per_epoch * epochs + per_eval
        if launches[kern] != want:
            raise AssertionError(f"{phase}: {kern} launched "
                                 f"{launches[kern]} times, expected {want}")
    if not np.isfinite(res["loss"]) or res["test_acc"] < 0.80:
        raise AssertionError(f"{phase}: loss {res['loss']}, test_acc "
                             f"{res['test_acc']} (REPRO criterion 0.80)")
    emit({"phase": phase, "argv": argv, "loss": res["loss"],
          "val_acc": res["val_acc"], "test_acc": res["test_acc"],
          "epochs": epochs, "epochs_per_s": res["epochs_per_s"],
          "seconds": seconds, "launches": launches})
    return launches


#: name, source, TPU kernel replaced, and the width of the float32 Cora
#: case whose times the summary reports (GCN's first layer; GAT's 8 heads)
KERNELS = {
    "K1": ("segment_sum", "graphneuralnetwork_tpu_torch/csrc/spmm_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py:94", 128),
    "K2": ("segment_max",
           "graphneuralnetwork_tpu_torch/csrc/segment_max_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/segment_max_kernel.py:28", 8),
}


def summary(cases, launches) -> dict:
    rows = []
    for kern, (name, source, replaces, width) in KERNELS.items():
        f32 = [c for c in cases
               if c["kernel"] == kern and c["dtype"] == "float32"]
        c = next(c for c in f32
                 if c["graph"] == "cora" and c["shape"][1] == width)
        rows.append({
            "name": f"{kern} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": max(x["max_abs_err"] for x in f32),
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "timed_case": f"float32 {c['shape']} on cora",
        })
    return {"kernels": rows}


def main() -> None:
    phase_device()
    phase_build()
    cora = load_cora(seed=0, layout="coo", device=DEVICE)
    cases = phase_kernels(cora)
    phase_path(cora)
    gcn = _drive("gcn", ["--model", "gcn", "--epochs", str(GCN_EPOCHS),
                         "--device", DEVICE, "--quiet"],
                 {"K1": (4, 2), "K2": (0, 0)})
    gat = _drive("gat", ["--model", "gat", "--layout", "coo", "--epochs",
                         str(GAT_EPOCHS), "--device", DEVICE, "--quiet"],
                 {"K1": (8, 4), "K2": (4, 2)})
    emit(summary(cases, {k: gcn[k] + gat[k] for k in gcn}))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
