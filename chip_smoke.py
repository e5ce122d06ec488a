#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphneuralnetwork_tpu_torch) on one
NVIDIA Hopper card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — needs a CUDA device; prints the card's name and power limit
               as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
  2. build   — compiles every kernel of ``csrc/`` with nvcc, in parallel;
  3. kernels — holds each kernel against its plain PyTorch version, on the
               card, at the shapes the main path gives it and at larger
               shapes, and times kernel, plain version and, where one
               exists, one library call (CUDA events, warmed, median):
               the launch floor (an empty kernel through the same ctypes
               path); K1/K2 on the Cora COO graph and a 2M-edge graph, K2
               also on a graph with a hub row and in its gathered form on
               the remainders of SAGE's Pubmed hybrid (C 500 and 128), of
               the Cora GAT hybrid and of the 2M-edge community graph (the
               three-pass shift's 8 heads); K4, K5 and
               K6 on the Cora GAT hybrid (8x8 and 1x7; 8x256, 2x600 and
               3x42 and one head of 50, 256 and 512), a 2M-edge community
               graph (8x128) and a hub graph whose densest row block holds
               more than 8 remainder chunks and 6 tiles (8x8, 1x1024) and
               its reverse (8x8, 1x251); float32 and
               bfloat16, with and without attention dropout; K8, K9 and
               K10 on the same operands with the three-pass shift, and
               once at Cora 8x8 with the profiler's m = 0; K8 on the hub
               graph with its dense tiles left in the remainder (rows long
               by their remainder alone, split by K8's own rule); K3 on the
               GCN Cora hybrid (F 128 and 7), the Pubmed SAGE hybrid (F 500,
               128 and 1) and the 2M-edge community graph's tiles and
               transpose tiles (F 128), float32 and bfloat16; K7 on the
               Pubmed hybrid (C 500 and 128), the community graph (128)
               and, at the three-pass shift's 8 heads, the Cora GAT
               hybrid and the community graph's bfloat16 tiles;
  4. path    — GCN, GAT-COO, GAT on the hybrid Cora graph (dropout off,
               then attention dropout with the same masks on both sides),
               GCN on the Cora hybrid and GraphSAGE mean and max on the
               Pubmed hybrid, kernels against plain versions end to end:
               logits and gradients on the card agree with the same model
               on the CPU;
  5. three_pass — ``gat_tiled_attend_parts`` (K7, K2, K8, K10) at the GAT
               Cora widths, forward and gradients: card against CPU, and
               against ``gat_tiled_attend`` (K4-K6) on the card; exact
               launch counts;
  6. profile_attend — ``tools/profile_attend.py`` at its default shape in
               bfloat16 and float32: every stage's time and its exact
               launches per call (K9 only in ``tile_parts``);
  7. capture — the captured epoch block (``train/scan_loop.py``: one
               epoch captured as a CUDA graph, replayed) for each of the
               CLI's eight configurations below, as the CLI builds them:
               (a) without dropout, a 20-epoch captured block against
               ``run_epochs`` from a twin state (each row within
               ``TOL[dtype]``) and, in float32, its first 5 rows against
               the CPU's eager loop (``PATH_TOL``); (b) with the CLI's
               dropout, two replays must draw other masks at every
               dropout site (``dropout``, ``draw_dropout``), and whether
               they equal the eager loop's draws is reported; (c) wall ms
               per epoch of a captured and an eager block; then (a) for
               GCN with SGD + warmup-poly, all 20 rows and the final
               parameters against the CPU's ``LambdaLR``;
  8. gcn     — the main path: ``--model gcn`` through the CLI entry point
               (auto layout -> COO), 200 epochs; K1 must have launched;
  9. gat     — ``--model gat --layout coo``, 50 epochs; K1 and K2 must have
               launched;
 10. gat_hybrid — ``--model gat`` (auto layout -> hybrid), 50 epochs in
               float32, then in bfloat16; exact K4/K5/K6 launch counts and
               no K1 or K2 launch;
 11. gcn_hybrid — ``--model gcn --layout hybrid``, 200 epochs in float32,
               then in bfloat16; exact K3 and K1 launch counts;
 12. graphsage_hybrid(_max) — ``--model graphsage --layout hybrid``, 100
               epochs with the mean aggregator (K3 and K1, no K7 or K2),
               then with ``--set aggregator=max`` (K7 and K2, no K3 or K1).
Every CLI run of 8-12 trains in the captured block (a warm-up epoch, one
capture, replays; the launch counts add a replay's captured launches) and
must reach test_acc >= 0.80 with exact launch counts.
 13. row_sum — the read-bandwidth probe, the port of ``tools/bench_dma.py``:
               its entry point (``tools/bench_dma.py`` of the port) at the
               1 GiB shape with exact launch counts, every variant's ms,
               GB/s and share of ``PEAK_BYTES_PER_S``; both kernels (the
               ring at 2, 4 and 8 slots) at that shape and a small one
               against the float64 sum and the plain version (normal
               data within the float32 summation bound, integer data
               exactly), each call under a time limit; ``torch.sum``
               timed as the library call;
 14. sage_sampled — the sampled GraphSAGE pipeline (no kernel):
               ``SampledGraphSAGE`` at full width card vs CPU; ``--model
               graphsage`` (test_acc >= 0.80), with ``--set
               device_sampling=true`` (>= 0.80) and ``--model
               graphsage_unsup`` (binary_acc >= 0.75), no kernel launched;
               epochs/s, then each run instrumented: wall ms per training
               step split into host sampling, copy, host call and device
               time.
Then a ``previous_design`` line (every K2-K10 case beside its previous
design's time where ``PREVIOUS_DESIGN_MS`` records one, not measured
here), a ``kernels`` summary line (K1-K10 and the two row-sum kernels,
with the launch floor) and, last,
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without the last line.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import subprocess
import sys
import time

import numpy as np
import torch

from graphneuralnetwork_tpu_torch.cli import main as cli_main
from graphneuralnetwork_tpu_torch.core.bcsr import (COL_BLOCK, ROW_BLOCK,
                                                    build_hybrid)
from graphneuralnetwork_tpu_torch.core.graph import build_graph
from graphneuralnetwork_tpu_torch.data import (load_cora, load_pubmed,
                                               load_pubmed_fullbatch)
from graphneuralnetwork_tpu_torch.nn import GAT, GCN, GraphSAGE
from graphneuralnetwork_tpu_torch.nn.sage import SampledGraphSAGE
from graphneuralnetwork_tpu_torch.nn import conv as nn_conv
from graphneuralnetwork_tpu_torch.nn import models as nn_models
from graphneuralnetwork_tpu_torch.ops import bcsr_attention
from graphneuralnetwork_tpu_torch.ops.cuda import attend_bwd_kernel as k56
from graphneuralnetwork_tpu_torch.ops.cuda import attend_online_kernel as k4
from graphneuralnetwork_tpu_torch.ops.cuda import attend_parts_kernel as k910
from graphneuralnetwork_tpu_torch.ops.cuda import bcsr_spmm_kernel as k3
from graphneuralnetwork_tpu_torch.ops.cuda import build
from graphneuralnetwork_tpu_torch.ops.cuda import neighbor_max_kernel as k7
from graphneuralnetwork_tpu_torch.ops.cuda import rem_attend_kernel as k8
from graphneuralnetwork_tpu_torch.ops.cuda import row_sum_kernel as k_rs
from graphneuralnetwork_tpu_torch.ops.cuda import segment_max_kernel as k2
from graphneuralnetwork_tpu_torch.ops.cuda import spmm_kernel as k1
from graphneuralnetwork_tpu_torch.ops.cuda import tile_walk
from graphneuralnetwork_tpu_torch.ops.cuda.counters import (COUNTERS,
                                                            read_launches,
                                                            reset_launches)
from graphneuralnetwork_tpu_torch.sampling import (csr_from_edges,
                                                   multihop_sampling)
from graphneuralnetwork_tpu_torch.tools import bench_dma, profile_attend
from graphneuralnetwork_tpu_torch.tools.timing import time_ms
from graphneuralnetwork_tpu_torch.train import sage_loop
from graphneuralnetwork_tpu_torch.train.loop import (create_train_state,
                                                     make_eval_fn)
from graphneuralnetwork_tpu_torch.train.metrics import (
    masked_softmax_cross_entropy)
from graphneuralnetwork_tpu_torch.train.scan_loop import (
    make_scanned_node_classification_run, run_epochs)
from graphneuralnetwork_tpu_torch.train.schedule import (make_optimizer,
                                                         warmup_poly_factor)

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 rate
#: outside the tensor cores — K1 accumulates and K2 compares in float32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
#: Dense bf16 tensor-core rate (data sheet): the unit that could do the
#: attend kernels' and K3's bf16 products.
PEAK_BF16_OPS_PER_S = 989e12
#: Special-function unit (exp) rate: 16 results per clock per SM (CUDA
#: programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz, the
#: boost clock at which 132 SMs reach the 67 TFLOP/s float32 peak.
PEAK_EXP_PER_S = 16 * 132 * 1.98e9
DEVICE = "cuda"
GCN_EPOCHS, GAT_EPOCHS, SAGE_EPOCHS = 200, 50, 100
LARGE_NODES, LARGE_EDGES = 65536, 2 ** 21
#: The attend kernels' large shape: a community graph without shuffle
#: (``bench.py``'s 2M-edge GAT shape, its locality given, not recovered).
ATTEND_LARGE = dict(n=131072, e=2 ** 21, comm=256, heads=8, feat=128)
#: Times with each kernel's previous design, ms ("NVIDIA H100 80GB HBM3,
#: 700.00 W", PERF.md): K2 (a thread per row and column) keyed by
#: (kernel, graph, width); K3 and K7 (a CTA per quarter row block and
#: 32-column slab) by (kernel, graph, x dtype, width); K4, K5 and K6
#: (a warp per row, a lane group per head, two passes in K4) by (kernel,
#: graph, x dtype, "HxF", dropout); K8, K9 and K10 (a warp per row, a
#: lane group per head) by the same and the shift. Recorded, not measured
#: by this script: ``previous_design`` prints them on a line of their own
#: beside this run's times.
PREVIOUS_DESIGN_MS = {
    ("K2", "cora", 8): 0.00358,
    ("K2", "cora", 1): 0.00329,
    ("K2", "large", 8): 0.0308,
    ("K3", "cora_gcn", "float32", 128): 0.00752,
    ("K3", "cora_gcn", "float32", 7): 0.00455,
    ("K3", "pubmed", "float32", 500): 0.03735,
    ("K3", "pubmed", "float32", 128): 0.01135,
    ("K3", "pubmed", "float32", 1): 0.00953,
    ("K3", "large", "float32", 128): 0.3956,
    ("K3", "large", "bfloat16", 128): 0.403,
    ("K7", "pubmed", "float32", 500): 0.03732,
    ("K7", "pubmed", "float32", 128): 0.01130,
    ("K7", "large", "float32", 128): 0.4056,
    ("K4", "cora", "float32", "8x8", True): 0.00877,
    ("K6", "cora", "float32", "8x8", True): 0.01094,
    ("K4", "cora", "float32", "1x7", True): 0.00815,
    ("K4", "hub", "float32", "8x8", True): 0.03587,
    ("K4", "large", "float32", "8x128", False): 4.226,
    ("K6", "large", "float32", "8x128", False): 5.049,
    ("K4", "large", "bfloat16", "8x128", False): 4.170,
    ("K5", "cora", "float32", "8x8", True): 0.01044,
    ("K5", "large", "float32", "8x128", False): 3.054,
    ("K5", "large", "bfloat16", "8x128", False): 4.189,
    ("K5", "hub", "float32", "8x8", True): 0.03978,
    ("K5", "hub_t", "float32", "1x251", False): 0.01896,
    ("K5", "hub_t", "float32", "1x251", True): 0.01905,
    ("K5", "hub_t", "bfloat16", "1x251", False): 0.01894,
    ("K5", "hub_t", "bfloat16", "1x251", True): 0.01905,
    ("K10", "cora", "float32", "8x8", True, "exact"): 0.006346,
    ("K10", "cora", "float32", "1x7", True, "exact"): 0.00610,
    ("K10", "cora", "float32", "8x8", False, "zero"): 0.00623,
    ("K10", "hub", "float32", "8x8", True, "exact"): 0.01900,
    ("K10", "large", "float32", "8x128", False, "exact"): 3.510,
    ("K10", "large", "float32", "8x128", True, "exact"): 3.636,
    ("K10", "large", "bfloat16", "8x128", False, "exact"): 3.021,
    ("K10", "cora", "float32", "8x256", True, "exact"): 0.09599,
    ("K10", "cora", "bfloat16", "8x256", True, "exact"): 0.07523,
    ("K10", "cora", "float32", "2x600", True, "exact"): 0.1102,
    ("K10", "cora", "bfloat16", "2x600", True, "exact"): 0.08988,
    ("K8", "cora", "float32", "8x8", True, "exact"): 0.004070,
    ("K8", "hub", "float32", "8x8", True, "exact"): 0.00743,
    ("K8", "large", "float32", "8x128", False, "exact"): 1.329,
    ("K8", "large", "float32", "8x128", True, "exact"): 1.332,
    ("K8", "large", "bfloat16", "8x128", False, "exact"): 0.941,
    ("K8", "cora", "float32", "8x256", True, "exact"): 0.06670,
    ("K8", "cora", "bfloat16", "8x256", True, "exact"): 0.04524,
    ("K8", "cora", "float32", "2x600", True, "exact"): 0.04428,
    ("K8", "cora", "bfloat16", "2x600", True, "exact"): 0.04540,
    ("K9", "cora", "float32", "8x8", True, "exact"): 0.005907,
    ("K9", "hub", "float32", "8x8", True, "exact"): 0.01902,
    ("K9", "large", "float32", "8x128", False, "exact"): 2.829,
    ("K9", "large", "float32", "8x128", True, "exact"): 2.952,
    ("K9", "large", "bfloat16", "8x128", False, "exact"): 2.486,
    ("K9", "cora", "float32", "8x256", True, "exact"): 0.05144,
    ("K9", "cora", "bfloat16", "8x256", True, "exact"): 0.04181,
    ("K9", "cora", "float32", "2x600", True, "exact"): 0.04717,
    ("K9", "cora", "bfloat16", "2x600", True, "exact"): 0.03876,
}
#: Attention dropout of the GAT path (and its keep rate in the checks).
GAT_DROPOUT = 0.6
#: Kernel vs plain version: |kernel - plain| <= rtol * |plain| + atol * S,
#: with S the row's sum of |values|. Both sum in float32 in different
#: orders (the plain version with atomics), which costs up to ~n * 2^-24 * S
#: for an n-edge row; atol = 1e-5 covers rows of ~100 edges at that worst
#: case, and K3's rows, which sum the nonzero slots of at most 6 tiles.
#: bf16: both round a float32 sum once, so they may also differ by one bf16
#: step (2^-7 of the value). Segment max and K7's neighbour max are exact.
TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 1e-5),
       "max": (0.0, 0.0)}
#: K4-K6 vs their plain versions: |kernel - plain| <= rtol * |plain| +
#: atol * max|plain| per output tensor. Both sum in float32 in other
#: orders (rows of up to ~4,000 edges at the hub shape; the backward's sums
#: cancel), worth ~1e-6 of the tensor's scale; 1e-4 leaves room for that
#: and still catches a wrong mask or a lost edge. Outputs in bfloat16 (out,
#: dx) are each rounded once from float32 sums that differ slightly, so
#: they may differ by one bfloat16 step (2^-7 of the value).
ATTEND_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 1e-4)}
#: Models card vs CPU (float32): the logits relative to the largest logit,
#: each parameter's gradient relative to its own largest entry. Two
#: summation orders of the same float32 math (COO against hybrid on the
#: CPU) differ by ~1e-6 of each gradient's scale; an attention gradient
#: that is wrong or missing misses by ~1.
PATH_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: int, ops: int, ops_peak: float = PEAK_F32_OPS_PER_S,
          exps: int = 0) -> tuple[float, str]:
    """The least time for the work, in ms: the largest of the bytes over
    the memory rate, the arithmetic over its unit's peak rate and the
    exponentials over the special-function rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_peak, exps / PEAK_EXP_PER_S) * 1e3
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


def _k2_case(graph, src, senders, label):
    """K2 on ``graph`` against its plain version, exactly: per-edge scores
    (``senders`` None; only the spanned edges count, as in K1) or a node
    table read at ``senders``. The bound counts the edges' scores, or the
    table rows that the edges name once and the senders, the spans and
    ``out``; the library call is ``scatter_reduce_`` on the per-edge
    scores (none for the gathered form: no single PyTorch call gathers and
    reduces)."""
    n, e = graph.n_nodes, graph.n_edges
    c = src.shape[1]
    rec = graph.receivers[:e]
    rows = src[:e] if senders is None else src[senders[:e].long()]
    out = k2.segment_max(graph, src, senders)
    ref = k2.segment_max_plain(rows, rec, n)
    torch.cuda.synchronize()
    form = "edges" if senders is None else "gather"
    err, rtol, atol = _check(f"K2 {label} C={c} {form}", out, ref, "max")
    if not torch.equal(out.isnan(), ref.isnan()):
        raise AssertionError(f"K2 {label}: NaN pattern differs")
    if senders is None:
        n_bytes = e * c * 4
        lib_out = torch.full((n, c), k2.EMPTY, device=DEVICE)
        idx = rec.long()[:, None].expand(-1, c)
        sc = src[:e]
        library_ms = time_ms(lambda: lib_out.scatter_reduce_(
            0, idx, sc, "amax", include_self=True))
        library = "scatter_reduce_"
    else:
        named = int(senders[:e].unique().numel())
        n_bytes = named * c * 4 + e * 4
        library_ms, library = None, "none: a gather and a reduce"
    n_bytes += (n + 1) * 4 + n * c * 4
    b_ms, b_by = bound(n_bytes, e * c)
    lay = k2.segmax_layout(c, graph.mean_row_edges, n, tile_walk.sm_count(
        torch.device(DEVICE).index or 0))
    return dict(
        kernel="K2", form=form, shape=[int(src.shape[0]), c], edges_read=e,
        dtype="float32", n_out=n, graph=label, max_abs_err=err, rtol=rtol,
        atol=atol, layout=dataclasses.asdict(lay),
        long_rows=int(graph.long_rows.numel()),
        kernel_ms=time_ms(lambda: k2.segment_max(graph, src, senders)),
        plain_ms=time_ms(lambda: k2.segment_max_plain(
            src[:e] if senders is None else src[senders[:e].long()], rec,
            n)),
        library_ms=library_ms, library=library, bound_ms=b_ms, bound_by=b_by,
        bytes=n_bytes)


def _hub_row_graph():
    """65,536 nodes with 4 random in-edges each, and node 0 with 32,768
    more: a hub row that K2 splits over a CTA."""
    rng = np.random.default_rng(2)
    n = 65536
    r = np.concatenate([np.repeat(np.arange(n), 4), np.zeros(32768, int)])
    s = rng.integers(0, n, r.shape[0])
    return build_graph(s, r, n, device=DEVICE)


def phase_kernels(cora, cora_hg, pubmed_hg, large) -> tuple[list, float]:
    """The launch floor, then K1 and K2 at the main path's shapes and
    larger. Cora's padding edges get random values too: the kernels must
    ignore them, as the plain versions do. Returns the cases and the
    launch floor in ms."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    floor_ms = time_ms(lambda: k2.launch_floor(torch.device(DEVICE)))
    emit({"phase": "kernels", "launch_floor_ms": floor_ms,
          "what": "an empty kernel on one warp, through the ctypes path"})
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
    # K2: GAT-COO's per-edge scores (8 heads, then 1), the 2M-edge graph
    # and a hub row; the gathered form on the remainders of SAGE-max's
    # Pubmed hybrid (its two layers' widths) and of the three-pass shift's
    # graphs (8 heads)
    recv = graphs["large"][0]
    large_g = build_graph(
        torch.randint(0, LARGE_NODES, (LARGE_EDGES,), generator=gen,
                      device=DEVICE).cpu().numpy(),
        recv.cpu().numpy(), LARGE_NODES, device=DEVICE)
    per_edge = [("cora", g, 8), ("cora", g, 1), ("large", large_g, 8),
                ("hub_row", _hub_row_graph(), 8)]
    gathered = [("pubmed_rem", pubmed_hg.rem, 500),
                ("pubmed_rem", pubmed_hg.rem, 128),
                ("cora_gat_rem", cora_hg.rem, 8),
                ("large_rem", large.rem, 8)]
    for label, graph, c in per_edge:
        scores = torch.randn(graph.n_edge_pad, c, device=DEVICE,
                             generator=gen)
        cases.append(_k2_case(graph, scores, None, label))
        emit({"phase": "kernels", **cases[-1]})
    for label, graph, c in gathered:
        table = torch.randn(graph.n_nodes, c, device=DEVICE, generator=gen)
        cases.append(_k2_case(graph, table, graph.senders, label))
        emit({"phase": "kernels", **cases[-1]})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "cases": len(cases)})
    return cases, floor_ms


def _community_graph(n, e, comm, seed=0):
    """``bench.py``'s community graph without its shuffle: ~90 % of the
    edges stay inside blocks of ``comm`` consecutive nodes."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    base = (s // comm) * comm
    r = np.where(intra, np.minimum(base + rng.integers(0, comm, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    return s[keep], r[keep]


def _hub_graph(seed=1):
    """4,096 nodes; row block 0 receives dense tiles from column blocks 1-8
    and ~2,600 scattered remainder edges (more than 8 chunks of 256): the
    TPU kernel's 2-D grid case. Every node also receives 4 random edges."""
    rng = np.random.default_rng(seed)
    n = 4096
    dense_s = np.concatenate([cb * COL_BLOCK + rng.integers(0, COL_BLOCK, 256)
                              for cb in range(1, 9)])
    bg_r = np.repeat(np.arange(n), 4)
    s = np.concatenate([dense_s, rng.integers(0, n, 3000),
                        rng.integers(0, n, bg_r.shape[0])])
    r = np.concatenate([rng.integers(0, ROW_BLOCK, dense_s.shape[0]),
                        rng.integers(0, ROW_BLOCK, 3000), bg_r])
    return s, r, n


def _with_tile_dtype(hg, dtype):
    """The same hybrid with its tile stores in ``dtype``."""
    bcsr = dataclasses.replace(hg.bcsr, tiles=hg.bcsr.tiles.to(dtype))
    bcsr_t = bcsr if hg.symmetric else dataclasses.replace(
        hg.bcsr_t, tiles=hg.bcsr_t.tiles.to(dtype))
    return dataclasses.replace(hg, bcsr=bcsr, bcsr_t=bcsr_t)


def _attend_err(name, out, ref, dtype):
    rtol, atol = ATTEND_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    if not bool((diff <= rtol * ref.float().abs() + atol * scale).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, rtol {rtol}, "
                             f"atol {atol} x {scale})")
    return err


def _held(kern, tag, checks):
    """Holds each (output, kernel's, plain's, ``ATTEND_TOL`` key) of one
    kernel; (the largest error, {output: [rtol, atol] applied})."""
    err = max(_attend_err(f"{kern} {name} {tag}", out, ref, key)
              for name, out, ref, key in checks)
    return err, {name: list(ATTEND_TOL[key]) for name, _, _, key in checks}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _attend_work(kern, hg, heads, hf, bits, by_col, by_row, whole):
    """(bytes, flops, exps) of one call on this run's data: every input
    that the function needs read once and every output written once; 2
    flops per (edge, column) per contraction over the edges the kernel
    visits (K4-K6 the nonzero tile slots and the remainder edges, K8 the
    remainder edges only, K9 and K10 the nonzero tile slots only; K6 two
    contractions, q and dx, the others one); one exp per (edge, head).
    The tiles count as the lesser of the dense store and what gives the
    same values: the row masks (16 bytes a tile row) and the nonzero
    slots' values.
    Of the [N, ...] operands, those of ``by_col`` count only at the nodes
    that the visited edges name as senders (columns) and those of
    ``by_row`` only at the rows that receive one; ``whole`` (the outputs,
    which cover every row, and K10's seeds) counts in full. K6 works in the
    transpose layout, where a row is a sender. Under dropout (``bits``
    given) the function needs one lattice word per nonzero tile slot (the
    other slots mask nothing), each remainder edge's multipliers, and for
    K6 the maps into the forward's masks."""
    bg, rem = (hg.bcsr_t, hg.rem_t) if kern == "K6" else (hg.bcsr, hg.rem)
    tiles, remainder = kern != "K8", kern not in ("K9", "K10")
    e = rem.n_edges if remainder else 0
    rows, cols = [], []
    if tiles:
        rows.append(bg.slot_edges[0])
        cols.append(bg.slot_edges[1])
    if remainder:
        rows.append(rem.receivers[:e].long())
        cols.append(rem.senders[:e].long())
    nnz = int(bg.slot_edges[0].numel()) if tiles else 0

    def named(ends, tensors):   # bytes of the rows that ``ends`` name
        per_row = sum(_nbytes(t) // t.shape[0] for t in tensors)
        return per_row * int(torch.cat(ends).unique().numel())

    nbytes = (named(cols, by_col) + named(rows, by_row) + _nbytes(*whole)
              + e * 8)
    if tiles:
        nbytes += (min(_nbytes(bg.tiles), _nbytes(bg.row_masks)
                       + nnz * bg.tiles.element_size())
                   + _nbytes(bg.col_ids, bg.tile_off, bg.tile_cnt))
    if remainder:
        nbytes += _nbytes(rem.row_ptr)
    if bits is not None:
        nbytes += nnz * 4 + e * heads * 4
        if kern == "K6":   # bits_tmap and rem_t_eperm
            nbytes += _nbytes(hg.bits_tmap) + e * 4
    contractions = 2 if kern == "K6" else 1
    return nbytes, 2 * contractions * (nnz + e) * hf, (nnz + e) * heads


def _timed_cases(calls, errs, label, hg, heads, feat, dtype, bits,
                 plain_reps, **meta):
    """One case per kernel of ``calls`` (kernel call, plain call, and the
    [N, ...] operands it reads by sender, by receiver and whole, as
    ``_attend_work`` takes them): its error and the tolerance each output
    was held to (``errs``, from ``_held``), its time and its plain
    version's, and its bound."""
    dname = str(dtype).replace("torch.", "")
    peak = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else \
        PEAK_F32_OPS_PER_S
    cases = []
    for kern, (kernel, plain, by_col, by_row, whole) in calls.items():
        nbytes, flops, exps = _attend_work(kern, hg, heads, heads * feat,
                                           bits, by_col, by_row, whole)
        b_ms, b_by = bound(nbytes, flops, peak, exps)
        err, tolerance = errs[kern]
        cases.append(dict(
            kernel=kern, graph=label, dtype=dname, dropout=bits is not None,
            **meta, shape=[hg.n_nodes, heads, feat], tiles=hg.bcsr.n_tiles,
            remainder_edges=hg.rem.n_edges, max_abs_err=err,
            tolerance=tolerance, kernel_ms=time_ms(kernel),
            plain_ms=time_ms(plain, *plain_reps), library_ms=None,
            library="none: no single PyTorch call computes it",
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
            exps=exps))
        emit({"phase": "kernels", **cases[-1]})
    return cases


def _attend_case(label, hg, heads, feat, dtype, dropping, gen, plain_reps):
    """K4, K5 and K6 on random operands of one shape against their plain
    versions, then timed. The backward's operands follow the forward's
    (m zeroed where den == 0, as the autograd function does). Then K8-K10
    on the same operands, with the three-pass attend's shift."""
    n, hf = hg.n_nodes, heads * feat
    dname = str(dtype).replace("torch.", "")

    def randn(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)

    x, gn = randn(n, hf).to(dtype), randn(n, hf).to(dtype)
    fs, fd, dden = randn(n, heads), randn(n, heads), randn(n, heads)
    keep_prob = 1.0 - GAT_DROPOUT if dropping else 1.0
    bits, keep_mul = (bcsr_attention.draw_dropout(hg, heads, keep_prob, gen)
                      if dropping else (None, None))
    fwd = (hg, x, fs, fd, bits, keep_mul, 0.2, keep_prob)
    out, den, m = k4.attend_online(*fwd)
    r_out, r_den, r_m = k4.attend_online_plain(*fwd)
    fdm3 = torch.cat([fd, torch.where(r_den > 0, r_m, 0.0), dden], 1)
    bwd = (hg, x, gn, fs, fdm3, bits, keep_mul, 0.2, keep_prob)
    dfd, r_dfd = k56.attend_bwd_a(*bwd), k56.attend_bwd_a_plain(*bwd)
    (dx, dfs), (r_dx, r_dfs) = (k56.attend_bwd_b(*bwd),
                                k56.attend_bwd_b_plain(*bwd))
    torch.cuda.synchronize()
    tag = f"{label} {dname} {heads}x{feat} dropout={dropping}"
    live = r_den > 0
    if not bool((m[~live] == k4.NEG).all()):
        raise AssertionError(f"K4 {tag}: m of an empty row is not NEG")
    errs = {
        "K4": _held("K4", tag, [("out", out, r_out, dname),
                                ("den", den, r_den, "float32"),
                                ("m", m[live], r_m[live], "float32")]),
        "K5": _held("K5", tag, [("dfd", dfd, r_dfd, "float32")]),
        "K6": _held("K6", tag, [("dx", dx, r_dx, dname),
                                ("dfs", dfs, r_dfs, "float32")]),
    }
    calls = {
        "K4": (lambda: k4.attend_online(*fwd),
               lambda: k4.attend_online_plain(*fwd),
               (x, fs), (fd,), (out, den, m)),
        "K5": (lambda: k56.attend_bwd_a(*bwd),
               lambda: k56.attend_bwd_a_plain(*bwd),
               (x, fs), (gn, fdm3), (dfd,)),
        # the transpose layout: a row is a sender, a column a receiver
        "K6": (lambda: k56.attend_bwd_b(*bwd),
               lambda: k56.attend_bwd_b_plain(*bwd),
               (gn, fdm3), (x, fs), (dx, dfs)),
    }
    cases = _timed_cases(calls, errs, label, hg, heads, feat, dtype, bits,
                         plain_reps)
    shift = bcsr_attention.three_pass_shift(hg, fs, fd, 0.2)
    return cases + _parts_cases(label, hg, x, fs, fd, shift, bits, keep_mul,
                                plain_reps, "exact")


def _parts_cases(label, hg, x, fs, fd, m, bits, keep_mul, plain_reps,
                 shift):
    """K8, K9 and K10 on one set of operands against their plain versions,
    then timed. K10 is seeded with the plain K8's partials, as the
    three-pass attend seeds it with K8's. ``shift`` names ``m``: "exact"
    (the three-pass attend's) or "zero" (the profiler's stand-in, where
    the exponent's clamp bites). All outputs are float32 and both sides
    multiply in float32, so they share the float32 tolerance."""
    heads = fs.shape[1]
    feat = x.shape[1] // heads
    keep_prob = 1.0 - GAT_DROPOUT if bits is not None else 1.0
    rem_args = (hg, x, fs, fd, m, keep_mul, 0.2)
    tile_args = (hg, x, fs, fd, m, bits, 0.2, keep_prob)
    num, den = k8.rem_attend(*rem_args)
    r_num, r_den = k8.rem_attend_plain(*rem_args)
    fused_args = (hg, x, fs, fd, m, r_num, r_den, bits, 0.2, keep_prob)
    t_num, t_den = k910.tile_parts(*tile_args)
    rt_num, rt_den = k910.tile_parts_plain(*tile_args)
    out, f_den = k910.attend_fused(*fused_args)
    r_out, rf_den = k910.attend_fused_plain(*fused_args)
    torch.cuda.synchronize()
    dname = str(x.dtype).replace("torch.", "")
    tag = (f"{label} {dname} {heads}x{feat} dropout={bits is not None} "
           f"m={shift}")
    errs = {
        "K8": _held("K8", tag, [("num", num, r_num, "float32"),
                                ("den", den, r_den, "float32")]),
        "K9": _held("K9", tag, [("num", t_num, rt_num, "float32"),
                                ("den", t_den, rt_den, "float32")]),
        "K10": _held("K10", tag, [("out", out, r_out, "float32"),
                                  ("den", f_den, rf_den, "float32")]),
    }
    # every row of K10's seeds is read: a row without tiles divides them
    calls = {
        "K8": (lambda: k8.rem_attend(*rem_args),
               lambda: k8.rem_attend_plain(*rem_args),
               (x, fs), (fd, m), (num, den)),
        "K9": (lambda: k910.tile_parts(*tile_args),
               lambda: k910.tile_parts_plain(*tile_args),
               (x, fs), (fd, m), (t_num, t_den)),
        "K10": (lambda: k910.attend_fused(*fused_args),
                lambda: k910.attend_fused_plain(*fused_args),
                (x, fs), (fd, m), (r_num, r_den, out, f_den)),
    }
    return _timed_cases(calls, errs, label, hg, heads, feat, x.dtype, bits,
                        plain_reps, shift=shift)


def _large_hybrid():
    """The attend and tile kernels' large shape: ``ATTEND_LARGE``'s
    community graph as a directed hybrid (its own transpose tiles)."""
    big = ATTEND_LARGE
    return build_hybrid(*_community_graph(big["n"], big["e"], big["comm"]),
                        big["n"], min_edges_per_tile=192, device=DEVICE)


def _hub_hybrid(transpose=False):
    """``_hub_graph`` as a hybrid on the card, its shape checked; with
    ``transpose``, its edges reversed, so that the hub's rows are senders
    (K6's long rows)."""
    hub_s, hub_r, hub_n = _hub_graph()
    if transpose:
        hub_s, hub_r = hub_r, hub_s
    hub = build_hybrid(hub_s, hub_r, hub_n, device=DEVICE)
    bg = hub.bcsr_t if transpose else hub.bcsr
    if not (int(bg.tile_cnt[0]) > 6 and (transpose or
                                          int(hub.rem_fine_cnt[0]) > 8)):
        raise AssertionError("hub graph: row block 0 holds "
                             f"{int(hub.rem_fine_cnt[0])} remainder chunks "
                             f"and {int(bg.tile_cnt[0])} tiles")
    if int(hub.long_rows[int(transpose)].numel()) == 0:
        raise AssertionError("hub graph: no row is split over a CTA")
    return hub


#: ``min_edges_per_tile`` that no tile of ``_hub_graph`` reaches
HUB_NO_TILES = 10 ** 6


def _rem_split_cases(gen) -> list[dict]:
    """K8 on ``_hub_graph`` with every edge left in the remainder (no tile
    reaches ``HUB_NO_TILES``), 8 x 8 float32, dropout off and on, against
    its plain version, then timed: the hub rows hold more than
    ``LONG_ROW_EDGES`` remainder edges, so K8 splits them over a CTA by its
    own rule (``HybridGraph.rem_long_rows``), which no graph of
    ``attend_shapes`` reaches (the hub's long rows there are long by their
    tile slots). The shift is the three-pass one, taken on the CPU."""
    hub_s, hub_r, hub_n = _hub_graph()
    hg = build_hybrid(hub_s, hub_r, hub_n, min_edges_per_tile=HUB_NO_TILES,
                      device=DEVICE)
    if hg.bcsr.n_edges or int(hg.rem_long_rows.numel()) == 0:
        raise AssertionError(
            f"hub graph without tiles: {hg.bcsr.n_edges} tiled edges, "
            f"{int(hg.rem_long_rows.numel())} rows long by the remainder")
    heads, feat = 8, 8
    n = hg.n_nodes
    x = torch.randn(n, heads * feat, device=DEVICE, generator=gen)
    fs = torch.randn(n, heads, device=DEVICE, generator=gen)
    fd = torch.randn(n, heads, device=DEVICE, generator=gen)
    m = bcsr_attention.three_pass_shift(hg.to("cpu"), fs.cpu(), fd.cpu(),
                                        0.2).to(DEVICE)
    cases = []
    for dropping in (False, True):
        bits, keep_mul = (bcsr_attention.draw_dropout(
            hg, heads, 1.0 - GAT_DROPOUT, gen) if dropping else (None, None))
        args = (hg, x, fs, fd, m, keep_mul, 0.2)
        num, den = k8.rem_attend(*args)
        r_num, r_den = k8.rem_attend_plain(*args)
        torch.cuda.synchronize()
        tag = f"hub_rem float32 {heads}x{feat} dropout={dropping} m=exact"
        errs = {"K8": _held("K8", tag, [("num", num, r_num, "float32"),
                                        ("den", den, r_den, "float32")])}
        calls = {"K8": (lambda a=args: k8.rem_attend(*a),
                        lambda a=args: k8.rem_attend_plain(*a),
                        (x, fs), (fd, m), (num, den))}
        cases += _timed_cases(calls, errs, "hub_rem", hg, heads, feat,
                              torch.float32, bits, (3, 5), shift="exact")
    return cases


def attend_shapes(cora_hybrid, hub, large):
    """(label, graph, heads, feat, plain reps) of the attend kernels'
    cases: the two GAT layers' widths at Cora, the hub graph (long rows
    split over a CTA in K4 and K5) and its reverse (in K6), and the large
    shape; then one head at widths that take the walk's other column
    layouts (``attend_common.attend_layout``): two and four 16-byte vectors
    a lane, two and four scalars, and heads wider than a warp holds, split
    into parts, on split rows; then heads wider than a lane group of 32
    columns a lane holds (8 x 256: slabs of 2 heads; 2 x 600: in parts on
    a multi-head row), 3 heads of 42 scalars (four a lane, a
    slab of a head count that is not a power of two) and one head of 301
    scalars (K5 in two parts of eight a lane, where one of 251 takes one
    part). The large shape is costly for the plain versions, so they run
    fewer times there."""
    big = ATTEND_LARGE
    hub_t = _hub_hybrid(transpose=True)
    return [("cora", cora_hybrid, 8, 8, (3, 5)),
            ("cora", cora_hybrid, 1, 7, (3, 5)),
            ("hub", hub, 8, 8, (3, 5)),
            ("hub_t", hub_t, 8, 8, (3, 5)),
            ("large", large, big["heads"], big["feat"], (2, 1)),
            ("cora", cora_hybrid, 1, 256, (3, 5)),
            ("cora", cora_hybrid, 1, 512, (3, 5)),
            ("cora", cora_hybrid, 1, 50, (3, 5)),
            ("hub", hub, 1, 1024, (3, 5)),
            ("hub_t", hub_t, 1, 251, (3, 5)),
            ("cora", cora_hybrid, 8, 256, (3, 5)),
            ("cora", cora_hybrid, 2, 600, (3, 5)),
            ("cora", cora_hybrid, 3, 42, (3, 5)),
            ("cora", cora_hybrid, 1, 301, (3, 5))]


def phase_attend_kernels(cora_hybrid, large) -> list[dict]:
    """K4-K6 and K8-K10 at the GAT path's Cora shapes, a large community
    graph and a hub graph; float32 and bfloat16 (x and tiles), dropout off
    and on; K8-K10 once more at Cora 8x8 with ``m = 0``; K8 on rows long
    by their remainder (``_rem_split_cases``)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    hub = _hub_hybrid()
    emit({"phase": "kernels", "graphs": {
        name: dict(nodes=g.n_nodes, tiles=g.bcsr.n_tiles,
                   tiled_edges=g.bcsr.n_edges, remainder_edges=g.rem.n_edges,
                   max_tiles=g.bcsr.max_tiles, rem_fine_max=g.rem_fine_max,
                   symmetric=g.symmetric)
        for name, g in (("cora", cora_hybrid), ("large", large),
                        ("hub", hub))},
        "seconds": time.perf_counter() - t0})
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, hg, heads, feat, plain_reps in attend_shapes(
                cora_hybrid, hub, large):
            hg = _with_tile_dtype(hg, dtype)
            for dropping in (False, True):
                cases += _attend_case(label, hg, heads, feat, dtype,
                                      dropping, gen, plain_reps)
    # K8-K10 with the profiler's stand-in m = 0: the exponent's clamp at 0
    # caps every term with a positive score at its weight
    n = cora_hybrid.n_nodes
    x = torch.randn(n, 64, device=DEVICE, generator=gen)
    fs = torch.randn(n, 8, device=DEVICE, generator=gen)
    fd = torch.randn(n, 8, device=DEVICE, generator=gen)
    cases += _parts_cases("cora", cora_hybrid, x, fs, fd, torch.zeros_like(fs),
                          None, None, (3, 5), "zero")
    cases += _rem_split_cases(gen)
    emit({"phase": "kernels", "attend_seconds": time.perf_counter() - t0,
          "cases": len(cases)})
    return cases


def _k3_library(bg, x, ref):
    """One PyTorch call for K3's function: ``torch.sparse.mm`` on a BSR
    tensor (blocksize 128) built once from the tiles, with ``x`` padded to
    ``n_node_pad`` rows. Returns the call and its max abs error against
    the plain version."""
    n_pad = bg.n_node_pad
    xp = torch.zeros(n_pad, x.shape[1], dtype=x.dtype, device=DEVICE)
    xp[:bg.n_nodes] = x
    crow = torch.cat([bg.tile_cnt.new_zeros(1), bg.tile_cnt.cumsum(0)])
    a = torch.sparse_bsr_tensor(crow.long(), bg.col_ids.long(),
                                bg.tiles.to(x.dtype), size=(n_pad, n_pad))

    def call():
        return torch.sparse.mm(a, xp)
    out = call()[:bg.n_nodes]
    return call, float((out.float() - ref.float()).abs().max())


def _tile_bytes(bg, x, out, values):
    """Bytes that K3 or K7 must move on this run's data: the tiles' ids and
    spans, the tile store where the function needs the values (K3: it holds
    the pattern too), else the nonzero masks, the smaller copy of the
    pattern (K7), the ``x`` rows that the nonzero slots name (once each)
    and ``out`` once."""
    named = int(bg.slot_edges[1].unique().numel())
    return (_nbytes(bg.col_ids, bg.tile_off, bg.tile_cnt, out,
                    *((bg.tiles,) if values else (bg.row_masks, bg.col_masks)))
            + named * x.shape[1] * x.element_size())


def _grid(bg, width, tile_size, mma):
    """The CTA shape the wrapper launches (``tile_walk.tile_grid``)."""
    rows, slab, ctas = tile_walk.tile_grid(
        bg.n_node_pad // ROW_BLOCK, width,
        tile_walk.sm_count(torch.device(DEVICE).index or 0), tile_size, mma)
    return dict(rows=rows, slab=slab, ctas=ctas)


def _k3_case(label, bg, f, dtype, gen, plain_reps):
    """K3 on random ``x`` [N, f] in ``dtype`` against its plain version,
    then timed. The bound counts ``_tile_bytes`` (the tile store, not the
    masks) and 2 flops per nonzero
    tile slot and column: the work this graph needs (the dense-tile count,
    2 * T * 128 * 128 * F, which bf16 ``x`` runs on the tensor cores, is
    reported beside it)."""
    dname = str(dtype).replace("torch.", "")
    x = torch.randn(bg.n_nodes, f, device=DEVICE, generator=gen).to(dtype)
    out = k3.bcsr_spmm(bg, x)
    ref = k3.bcsr_spmm_plain(bg, x)
    abs_bg = dataclasses.replace(bg, tiles=bg.tiles.to(dtype).float().abs())
    abs_sum = k3.bcsr_spmm_plain(abs_bg, x.float().abs())
    torch.cuda.synchronize()
    err, rtol, atol = _check(f"K3 {label} {dname} F={f}", out, ref, dname,
                             abs_sum)
    nnz = int(torch.count_nonzero(bg.tiles))
    n_bytes = _tile_bytes(bg, x, out, values=True)
    peak = (PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16
            else PEAK_F32_OPS_PER_S)
    b_ms, b_by = bound(n_bytes, 2 * nnz * f, peak)
    dense_ms, dense_by = bound(
        n_bytes, 2 * bg.n_tiles * ROW_BLOCK * COL_BLOCK * f, peak)
    lib, lib_err = _k3_library(bg, x, ref)
    return dict(
        kernel="K3", graph=label, dtype=dname, shape=[bg.n_nodes, f],
        tiles=bg.n_tiles, tile_dtype=str(bg.tiles.dtype).replace(
            "torch.", ""), nonzero_slots=nnz,
        **_grid(bg, f, bg.tiles.element_size(), dtype == torch.bfloat16),
        max_abs_err=err, rtol=rtol,
        atol=atol, kernel_ms=time_ms(lambda: k3.bcsr_spmm(bg, x)),
        plain_ms=time_ms(lambda: k3.bcsr_spmm_plain(bg, x), *plain_reps),
        library_ms=time_ms(lib),
        library="torch.sparse.mm (BSR, blocksize 128)",
        library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by,
        dense_tile_bound_ms=dense_ms, dense_tile_bound_by=dense_by,
        bytes=n_bytes, flops=2 * nnz * f)


def _k7_case(label, bg, c, gen, plain_reps):
    """K7 on random float32 ``v`` [N, c] against its plain version (exact),
    then timed. The bound counts ``_tile_bytes`` (the masks, not the tile
    values, which K7 never reads) and one comparison per nonzero tile slot
    and column (the dense-tile count, T * 128 * 128 * C,
    is reported beside it)."""
    v = torch.randn(bg.n_nodes, c, device=DEVICE, generator=gen)
    out = k7.neighbor_max(bg, v)
    ref = k7.neighbor_max_plain(bg, v)
    torch.cuda.synchronize()
    tile_dtype = str(bg.tiles.dtype).replace("torch.", "")
    err, rtol, atol = _check(f"K7 {label} C={c} {tile_dtype} tiles", out,
                             ref, "max")
    nnz = int(torch.count_nonzero(bg.tiles))
    n_bytes = _tile_bytes(bg, v, out, values=False)
    b_ms, b_by = bound(n_bytes, nnz * c)
    dense_ms, dense_by = bound(n_bytes,
                               bg.n_tiles * ROW_BLOCK * COL_BLOCK * c)
    return dict(
        kernel="K7", graph=label, dtype="float32", shape=[bg.n_nodes, c],
        tiles=bg.n_tiles, tile_dtype=tile_dtype, nonzero_slots=nnz,
        **_grid(bg, c, 0, False), max_abs_err=err, rtol=rtol, atol=atol,
        kernel_ms=time_ms(lambda: k7.neighbor_max(bg, v)),
        plain_ms=time_ms(lambda: k7.neighbor_max_plain(bg, v), *plain_reps),
        library_ms=None,
        library="none: no single PyTorch call computes a masked block max",
        bound_ms=b_ms, bound_by=b_by, dense_tile_bound_ms=dense_ms,
        dense_tile_bound_by=dense_by, bytes=n_bytes, flops=nnz * c)


def phase_tile_kernels(cora_gcn_hg, cora_gat_hg, pubmed_hg,
                       large) -> list[dict]:
    """K3 at GCN's Cora hybrid widths (128, 7) and SAGE's Pubmed widths
    (500, 128, 1), and on the large community graph's tiles and transpose
    tiles at 128, with float32 and bfloat16 ``x`` (the large graph's tiles
    in ``x``'s type, the path graphs' in float32, as the loaders build
    them); K7 at SAGE's Pubmed widths (500, 128), on the large tiles (128)
    and at the three-pass shift's 8 heads on the Cora GAT hybrid and the
    large graph's bfloat16 tiles."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    emit({"phase": "kernels", "tile_graphs": {
        name: dict(nodes=bg.n_nodes, tiles=bg.n_tiles,
                   tiled_edges=bg.n_edges, max_tiles=bg.max_tiles)
        for name, bg in (("cora_gcn", cora_gcn_hg.bcsr),
                         ("cora_gat", cora_gat_hg.bcsr),
                         ("pubmed", pubmed_hg.bcsr), ("large", large.bcsr),
                         ("large_t", large.bcsr_t))}})
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        big = _with_tile_dtype(large, dtype)
        shapes = ([("cora_gcn", cora_gcn_hg.bcsr, f, (7, 20))
                   for f in (128, 7)]
                  + [("pubmed", pubmed_hg.bcsr, f, (7, 20))
                     for f in (500, 128, 1)]
                  + [("large", big.bcsr, 128, (3, 2)),
                     ("large_t", big.bcsr_t, 128, (3, 2))])
        for label, bg, f, plain_reps in shapes:
            cases.append(_k3_case(label, bg, f, dtype, gen, plain_reps))
            emit({"phase": "kernels", **cases[-1]})
    big_bf16 = _with_tile_dtype(large, torch.bfloat16).bcsr
    for label, bg, c, plain_reps in (("pubmed", pubmed_hg.bcsr, 500, (7, 20)),
                                     ("pubmed", pubmed_hg.bcsr, 128, (7, 20)),
                                     ("large", large.bcsr, 128, (3, 2)),
                                     ("cora_gat", cora_gat_hg.bcsr, 8,
                                      (7, 20)),
                                     ("large", big_bf16, 8, (3, 2))):
        cases.append(_k7_case(label, bg, c, gen, plain_reps))
        emit({"phase": "kernels", **cases[-1]})
    emit({"phase": "kernels", "tile_seconds": time.perf_counter() - t0,
          "cases": len(cases)})
    return cases


def _card_vs_cpu(make, cpu_graph, dev_graph, data, dropout_ops=None):
    """One model on the CPU (plain versions) and a copy with the same
    weights on the card (kernels): (logits error relative to the largest
    logit, {parameter: gradient error relative to that gradient's largest
    entry}). With
    ``dropout_ops`` the models run in training mode with feature dropout
    off, and every GAT layer's attention dropout takes the next
    (bits, keep_mul) of that list, on both sides."""
    ref, dev = make(), make()
    ref.reset_parameters(torch.Generator().manual_seed(1))
    dev.load_state_dict(ref.state_dict())
    dev.to(DEVICE)
    idx = torch.arange(140)
    draw = bcsr_attention.draw_dropout
    outs = []
    try:
        for model, graph, x, y in ((ref, cpu_graph, data.features.cpu(),
                                    data.labels.cpu()),
                                   (dev, dev_graph, data.features,
                                    data.labels)):
            if dropout_ops is None:
                model.eval()
            else:
                model.train()
                model.dropout = 0.0
                queue = [(b.to(x.device), k.to(x.device))
                         for b, k in dropout_ops]
                bcsr_attention.draw_dropout = (
                    lambda hg, heads, keep_prob, gen, q=queue: q.pop(0))
            logits = model(graph, x)
            masked_softmax_cross_entropy(logits[idx.to(x.device)],
                                         y[idx.to(x.device)]).backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.cpu() for k, p in
                          model.named_parameters()}))
    finally:
        bcsr_attention.draw_dropout = draw
    (lr, gr), (ld, gd) = outs
    if not torch.isfinite(ld).all() or ld.shape != lr.shape:
        raise AssertionError("bad logits on the card")
    err = float((ld - lr).abs().max()) / float(lr.abs().max())
    # each gradient against its own scale: the attention vectors' gradients
    # (K5's dfd and K6's dfs) are ~1e-3 of the linear weights'
    gerr = {k: float((gd[k] - g).abs().max()) / float(g.abs().max())
            for k, g in gr.items()}
    return err, gerr


def phase_path(cora, cora_h, cora_hg, cora_g, pubmed) -> None:
    """The models with the kernels (card) against the plain versions (CPU),
    same weights, float32: GCN and GAT on the Cora COO graph, GAT on the
    hybrid layout without and with attention dropout (the same masks,
    drawn on the CPU, on both sides), GCN on the Cora hybrid (``cora_g``,
    K3 + K1) and GraphSAGE mean (K3 + K1) and max (K7 + K2) on the Pubmed
    hybrid."""
    t0 = time.perf_counter()
    n_feats, n_cls = cora.features.shape[1], cora.num_classes

    def gat():
        return GAT(n_feats, hidden=8, num_heads=8, num_classes=n_cls)

    hg_cpu = cora_hg.to("cpu")
    gen = torch.Generator().manual_seed(2)
    masks = [bcsr_attention.draw_dropout(hg_cpu, heads, 1.0 - GAT_DROPOUT,
                                         gen) for heads in (8, 1)]
    runs = {
        "gcn": (lambda: GCN(n_feats, hidden=128, num_classes=n_cls),
                cora.graph, cora, None),
        "gat": (gat, cora.graph, cora, None),
        "gat_hybrid": (gat, cora_hg, cora_h, None),
        "gat_hybrid_dropout": (gat, cora_hg, cora_h, masks),
        "gcn_hybrid": (lambda: GCN(n_feats, hidden=128, num_classes=n_cls),
                       cora_g.graph, cora_g, None),
    }
    for agg in ("mean", "max"):
        runs[f"graphsage_hybrid_{agg}"] = (
            lambda agg=agg: GraphSAGE(
                pubmed.features.shape[1], hidden_dims=(128,),
                num_classes=pubmed.num_classes, aggregator=agg),
            pubmed.graph, pubmed, None)
    report = {}
    for name, (make, graph, data, ops) in runs.items():
        err, gerr = _card_vs_cpu(make, graph.to("cpu"), graph, data, ops)
        if err > PATH_TOL or max(gerr.values()) > PATH_TOL:
            raise AssertionError(f"{name}: card vs CPU logits rel err {err}, "
                                 f"grad rel errs {gerr}")
        report[name] = dict(logits_rel_err=err, grad_rel_err=gerr)
    emit({"phase": "path", "seconds": time.perf_counter() - t0,
          "tolerance": PATH_TOL, **report})


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.cpu() - b.cpu()).abs().max()) / float(b.abs().max())


def phase_three_pass(cora_hg) -> dict:
    """``gat_tiled_attend_parts`` at the GAT layers' Cora widths (8 x 8 with
    attention dropout, then 1 x 7), forward and backward, on random
    float32 operands: on the card against the CPU (PATH_TOL of each
    tensor's scale), and on the card against ``gat_tiled_attend`` (K4-K6),
    the same function (ATTEND_TOL). The launch counts are set to 0 just
    before the card's three-pass run and read just after: one K7, K2, K8
    and K10 each per call, no other kernel (the backward is plain
    PyTorch)."""
    t0 = time.perf_counter()
    hg_cpu = cora_hg.to("cpu")
    gen = torch.Generator().manual_seed(4)
    n = cora_hg.n_nodes
    launches = dict.fromkeys(COUNTERS, 0)
    report = {}
    for heads, feat, dropout in ((8, 8, GAT_DROPOUT), (1, 7, 0.0)):
        ops = [torch.randn(*shape, generator=gen) for shape in
               ((n, heads, feat), (n, heads), (n, heads), (n, heads, feat))]
        masks = (bcsr_attention.draw_dropout(hg_cpu, heads, 1.0 - dropout,
                                             gen) if dropout else None)

        def run(fn, hg, count=False):
            dev = hg.device
            x, fs, fd, g = (a.to(dev, copy=True) for a in ops)
            ins = [a.requires_grad_() for a in (x, fs, fd)]
            kw = {}
            if masks is not None:
                kw = dict(attn_dropout=dropout, bits=masks[0].to(dev),
                          keep_mul=masks[1].to(dev))
            if count:
                reset_launches()
            out = fn(hg, *ins, **kw)
            (out * g).sum().backward()
            if count:
                torch.cuda.synchronize()
                for k, v in read_launches().items():
                    launches[k] += v
            return [out.detach()] + [a.grad for a in ins]

        card = run(bcsr_attention.gat_tiled_attend_parts, cora_hg, True)
        cpu = run(bcsr_attention.gat_tiled_attend_parts, hg_cpu)
        online = run(bcsr_attention.gat_tiled_attend, cora_hg)
        torch.cuda.synchronize()
        names = ("out", "dx", "dfs", "dfd")
        vs_cpu = {k: _rel_err(a, b) for k, a, b in zip(names, card, cpu)}
        if max(vs_cpu.values()) > PATH_TOL:
            raise AssertionError(f"three-pass {heads}x{feat}: card vs CPU "
                                 f"rel errs {vs_cpu}")
        vs_online = {k: _attend_err(f"three-pass vs K4-K6 {k} {heads}x{feat}",
                                    a, b, "float32")
                     for k, a, b in zip(names, card, online)}
        report[f"{heads}x{feat}"] = dict(dropout=dropout,
                                         card_vs_cpu_rel_err=vs_cpu,
                                         vs_online_max_abs_err=vs_online)
    want = {"K7": 2, "K2": 2, "K8": 2, "K10": 2}
    if launches != {k: want.get(k, 0) for k in COUNTERS}:
        raise AssertionError(f"three-pass launches {launches}, expected "
                             f"{want} and no other kernel")
    emit({"phase": "three_pass", "seconds": time.perf_counter() - t0,
          "path_tolerance": PATH_TOL, "attend_tolerance": ATTEND_TOL,
          **report, "launches": launches})
    return launches


#: The stage profiler's arguments (its defaults: the JAX tool's shape).
PROFILE_ARGV: list[str] = []
#: The kernels each of its stages launches per call; no other kernel.
PROFILE_LAUNCHES = {
    "nmax_tiles": {"K7": 1}, "nmax_rem": {"K2": 1}, "tile_parts": {"K9": 1},
    "rem_parts": {"K8": 1}, "fused": {"K10": 1}, "epilogue": {},
    "three_pass": {"K7": 1, "K2": 1, "K8": 1, "K10": 1}, "full": {"K4": 1}}


def phase_profile_attend() -> dict:
    """``tools/profile_attend.py``'s ``main`` at its defaults (131,072
    nodes, 2,097,152 edges, communities of 256, 8 heads x 128), in bfloat16
    and then float32: every stage with its exact launches per call. The
    launch counts are set to 0 before each run and read after it."""
    launches = dict.fromkeys(COUNTERS, 0)
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        reset_launches()
        res = profile_attend.main(PROFILE_ARGV + ["--dtype", dtype,
                                                  "--device", DEVICE])
        for k, v in read_launches().items():
            launches[k] += v
        per_call = {name: e["launches"] for name, e in res["stages"].items()}
        if per_call != PROFILE_LAUNCHES:
            raise AssertionError(f"profile_attend {dtype}: launches per "
                                 f"call {per_call}, expected "
                                 f"{PROFILE_LAUNCHES}")
        emit({"phase": "profile_attend", "dtype": dtype,
              "seconds": time.perf_counter() - t0, "graph": res["graph"],
              "ms": {name: e["ms"] for name, e in res["stages"].items()},
              "launches_per_call": per_call})
    emit({"phase": "profile_attend", "launches": launches})
    return launches


#: The captured block against the eager one: epochs of one block, and the
#: first epochs also held against the CPU's eager loop (all of them with
#: SGD, whose schedule then runs to its end).
CAPTURE_EPOCHS, CPU_EPOCHS = 20, 5


def cli_configs(cora, cora_h, cora_h16, cora_g, pubmed) -> dict:
    """The CLI's eight training configurations as ``cli.py`` builds them,
    by phase name: (data, model of a dropout rate, optimizer, compute
    dtype, the CLI's dropout rate or None where the model has none)."""
    f, c = cora.features.shape[1], cora.num_classes
    bf16 = torch.bfloat16

    def gcn(dtype=None):
        return lambda p: GCN(f, hidden=128, num_classes=c, dropout=p,
                             dtype=dtype)

    def gat(dtype=None):
        return lambda p: GAT(f, hidden=8, num_heads=8, num_classes=c,
                             dropout=p, dtype=dtype)

    def sage(agg):
        return lambda p: GraphSAGE(pubmed.features.shape[1],
                                   hidden_dims=(128,),
                                   num_classes=pubmed.num_classes,
                                   aggregator=agg)

    gcn_opt = make_optimizer("adamw", 2e-3, weight_decay=5e-4)
    gat_opt = make_optimizer("adamw", 1e-2, weight_decay=5e-4)
    sage_opt = make_optimizer("adamw", 1e-2, weight_decay=1e-4)
    return {
        "gcn": (cora, gcn(), gcn_opt, "float32", 0.5),
        "gat": (cora, gat(), gat_opt, "float32", 0.6),
        "gat_hybrid": (cora_h, gat(), gat_opt, "float32", 0.6),
        "gat_hybrid_bf16": (cora_h16, gat(bf16), gat_opt, "bfloat16", 0.6),
        "gcn_hybrid": (cora_g, gcn(), gcn_opt, "float32", 0.5),
        "gcn_hybrid_bf16": (cora_g, gcn(bf16), gcn_opt, "bfloat16", 0.5),
        "graphsage_hybrid": (pubmed, sage("mean"), sage_opt, "float32",
                             None),
        "graphsage_hybrid_max": (pubmed, sage("max"), sage_opt, "float32",
                                 None),
    }


def _on_cpu(data):
    return dataclasses.replace(
        data, graph=data.graph.to("cpu"), features=data.features.cpu(),
        labels=data.labels.cpu(), train_idx=data.train_idx.cpu(),
        val_idx=data.val_idx.cpu(), test_idx=data.test_idx.cpu(),
        device=torch.device("cpu"))


def _timed(block) -> tuple[np.ndarray, float]:
    """A block's rows and its wall ms per epoch (the block ends in its
    host read, which waits for the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = block()
    return rows, (time.perf_counter() - t0) * 1e3 / len(rows)


def _rows_err(got, want, tol) -> float:
    """The largest ``|got - want|`` over ``rtol |want| + atol``; at most 1
    where they agree within ``tol`` = (rtol, atol)."""
    rtol, atol = tol
    return float(np.max(np.abs(got - want) / (rtol * np.abs(want) + atol)))


def _captured_vs_eager(data, make, opt, dtype, cpu_epochs,
                       check=None) -> dict:
    """(a) and (c): models without dropout, from one seed: a captured block
    of ``CAPTURE_EPOCHS`` against ``run_epochs`` on a twin state, each
    epoch's row within ``TOL[dtype]``; in float32 the first ``cpu_epochs``
    rows also against the CPU's eager loop within ``PATH_TOL`` (the rows
    are O(1)), and ``check(captured state, CPU state)`` adds its report.
    Then one more block each, timed."""
    states = [create_train_state(make(0.0), data, 0, opt) for _ in range(2)]
    cap, eag = states
    run = make_scanned_node_classification_run(cap.model, CAPTURE_EPOCHS)
    evaluate = make_eval_fn(eag.model)
    rows, first_ms = _timed(lambda: run(cap, data))
    ref = run_epochs(eag, data, evaluate, CAPTURE_EPOCHS)
    if rows.shape != (CAPTURE_EPOCHS, 4) or not np.isfinite(rows).all():
        raise AssertionError(f"captured rows {rows}")
    err = _rows_err(rows, ref, TOL[dtype])
    if err > 1.0:
        raise AssertionError(f"captured vs eager rows: {rows} against {ref} "
                             f"(error {err} of TOL[{dtype}])")
    out = {"captured_vs_eager_err_of_tol": err}
    if dtype == "float32":
        cpu_data = _on_cpu(data)
        cpu = create_train_state(make(0.0), cpu_data, 0, opt)
        cpu_rows = run_epochs(cpu, cpu_data, make_eval_fn(cpu.model),
                              cpu_epochs)
        cpu_err = float(np.abs(rows[:cpu_epochs] - cpu_rows).max())
        if cpu_err > PATH_TOL:
            raise AssertionError(f"captured vs CPU rows: {rows[:cpu_epochs]} "
                                 f"against {cpu_rows}")
        out.update(cpu_epochs=cpu_epochs, captured_vs_cpu_abs_err=cpu_err)
        if check is not None:
            out.update(check(cap, cpu))
    _, captured_ms = _timed(lambda: run(cap, data))
    _, eager_ms = _timed(lambda: run_epochs(eag, data, evaluate,
                                            CAPTURE_EPOCHS))
    out.update(first_block_ms_per_epoch=first_ms,
               captured_ms_per_epoch=captured_ms, eager_ms_per_epoch=eager_ms)
    return out


def _sgd_schedule(cap, cpu) -> dict:
    """The captured SGD block's schedule: its device count at
    ``CAPTURE_EPOCHS`` steps, its table ``warmup_poly_factor`` at every
    step, and its parameters, each relative to its largest entry, within
    ``PATH_TOL`` of the CPU's (``torch.optim.SGD`` + ``LambdaLR``) after
    the same steps."""
    table = [warmup_poly_factor(t, CAPTURE_EPOCHS, 1)
             for t in range(CAPTURE_EPOCHS + 1)]
    sched = cap.scheduler
    if (int(sched.count) != CAPTURE_EPOCHS
            or sched.factors.cpu().tolist() != table):
        raise AssertionError(f"SGD schedule: count {sched.count}, table "
                             f"{sched.factors}")
    errs = {k: _rel_err(p, q) for (k, p), q in
            zip(cap.model.state_dict().items(),
                cpu.model.state_dict().values())}
    if max(errs.values()) > PATH_TOL:
        raise AssertionError(f"SGD parameters captured vs CPU: {errs}")
    return {"schedule_count": int(sched.count), "params_vs_cpu_rel_err": errs}


def _recording_sites(records):
    """Stand-ins for the dropout sites that append what each call drew to
    ``records`` (clones: under capture, static outputs that each replay
    rewrites): ``dropout``'s keep mask beside its input's support (the
    mask shows only where the input is nonzero), ``draw_dropout``'s
    ``bits`` and ``keep_mul``."""
    drop, draw = nn_conv.dropout, bcsr_attention.draw_dropout

    def dropout_at(site):
        def recorded(x, rate, generator):
            out = drop(x, rate, generator)
            records.append((site, torch.stack([out != 0, x != 0])))
            return out
        return recorded

    def draw_dropout(hg, heads, keep_prob, generator=None):
        bits, keep_mul = draw(hg, heads, keep_prob, generator)
        records.append(("draw_dropout", (bits.clone(), keep_mul.clone())))
        return bits, keep_mul

    return {(nn_models, "dropout"): dropout_at("dropout (features)"),
            (nn_conv, "dropout"): dropout_at("dropout (attention)"),
            (bcsr_attention, "draw_dropout"): draw_dropout}


def _drawn(record) -> tuple:
    site, drawn = record
    return site, tuple(t.to("cpu", copy=True) for t in
                       (drawn if isinstance(drawn, tuple) else (drawn,)))


def _same_draw(a, b) -> bool:
    """Whether two records drew the same: ``dropout``'s masks where both
    inputs are nonzero, ``draw_dropout``'s operands bit for bit."""
    if a[0].startswith("dropout"):
        (ma,), (mb,) = a[1], b[1]
        both = ma[1] & mb[1]
        return bool(torch.equal(ma[0] & both, mb[0] & both))
    return all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def _fresh_draws(data, make, opt, rate) -> dict:
    """(b): the model with the CLI's dropout ``rate``, as a captured block
    of one epoch (the warm-up, then the capture) replayed twice: each
    dropout site must draw other masks in the two replays. Also reports
    whether each replay drew bit for bit what the eager loop draws in the
    same epoch from the same seed (epochs 2 and 3)."""
    records: list = []
    patched = _recording_sites(records)
    saved = {key: getattr(*key) for key in patched}
    try:
        for (module, name), fn in patched.items():
            setattr(module, name, fn)
        st = create_train_state(make(rate), data, 0, opt)
        run = make_scanned_node_classification_run(st.model, 1)
        run(st, data)
        n = len(records) // 2
        captured = records[n:]
        replays = []
        for _ in range(2):
            run(st, data)
            replays.append([_drawn(r) for r in captured])
        records.clear()
        eag = create_train_state(make(rate), data, 0, opt)
        run_epochs(eag, data, make_eval_fn(eag.model), 3)
        eager = [[_drawn(r) for r in records[i * n:(i + 1) * n]]
                 for i in (1, 2)]
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    if n == 0 or len(records) != 3 * n:
        raise AssertionError(f"dropout sites drew {n} times an epoch "
                             f"captured, {len(records)} in 3 eager epochs")
    sites = {}
    for i, (r1, r2) in enumerate(zip(*replays)):
        key = f"{r1[0]} #{i}"
        sites[key] = {
            "fresh": not _same_draw(r1, r2),
            "eager_bit_equal": all(_same_draw(replays[j][i], eager[j][i])
                                   for j in (0, 1))}
        if not sites[key]["fresh"]:
            raise AssertionError(f"{key}: two replays drew the same masks")
    return sites


def phase_capture(configs) -> None:
    """The captured epoch block (``train/scan_loop.py``) for each of the
    CLI's configurations: (a) captured against eager and the CPU without
    dropout, (b) fresh dropout draws in every replay, (c) wall ms per
    epoch, captured and eager; then (a) for GCN with SGD + warmup-poly,
    whose learning rate must follow ``warmup_poly_factor`` step for step:
    all ``CAPTURE_EPOCHS`` rows and the final parameters against the CPU's
    ``LambdaLR``, and the device count and table read back."""
    t0 = time.perf_counter()
    for phase, (data, make, opt, dtype, rate) in configs.items():
        res = _captured_vs_eager(data, make, opt, dtype, CPU_EPOCHS)
        res["dropout"] = ("no dropout" if rate is None
                          else _fresh_draws(data, make, opt, rate))
        emit({"phase": "capture", "config": phase, "dtype": dtype,
              "epochs": CAPTURE_EPOCHS, **res})
    data, make = configs["gcn"][:2]
    sgd = make_optimizer("sgd", 2e-3, weight_decay=5e-4,
                         total_steps=CAPTURE_EPOCHS, warmup_steps=1,
                         momentum=0.9)
    res = _captured_vs_eager(data, make, sgd, "float32", CAPTURE_EPOCHS,
                             check=_sgd_schedule)
    emit({"phase": "capture", "config": "gcn_sgd", "dtype": "float32",
          "epochs": CAPTURE_EPOCHS, **res})
    emit({"phase": "capture", "seconds": time.perf_counter() - t0})


def _drive(phase, argv, expect):
    """Run the CLI with the launch counts set to 0 just before and read
    just after; ``expect`` maps each kernel to its launches per epoch and
    per evaluation (a kernel it leaves out must not launch)."""
    reset_launches()
    t0 = time.perf_counter()
    res = cli_main(argv)
    launches = read_launches()
    seconds = time.perf_counter() - t0
    epochs = res["epochs"]
    for kern in COUNTERS:
        per_epoch, per_eval = expect.get(kern, (0, 0))
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


def _width(graph, width):
    return lambda c: c["graph"] == graph and c["shape"][1] == width


def _cora_gat_train(c):
    """The attend kernels' timed case: the first GAT layer (8 x 8) of a
    training step, with attention dropout (K8-K10: with the exact
    shift)."""
    return (c["graph"] == "cora" and c["shape"][1:] == [8, 8]
            and c["dropout"] and c.get("shift", "exact") == "exact")


#: The row-sum probe (``tools/bench_dma.py``'s kernels): its small shape
#: beside the tool's 1 GiB one, and the longest one kernel call with its
#: synchronisation may take before the run dumps its stacks and exits 1 (a
#: hung TMA ring waits forever rather than failing).
ROW_SUM_SMALL = (4096, 128)
ROW_SUM_CALL_LIMIT = 120.0
#: Calls of each variant in one run of the tool: its check, then
#: ``time_ms``'s 3 warm-up calls and 7 batches of 20.
ROW_SUM_TOOL_CALLS = 1 + 3 + 7 * 20


def _limited(fn, what: str):
    """``fn()`` and a synchronisation, under ``ROW_SUM_CALL_LIMIT``."""
    faulthandler.dump_traceback_later(ROW_SUM_CALL_LIMIT, exit=True)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        faulthandler.cancel_dump_traceback_later()
    return out


def _row_sum_calls():
    """name -> (kernel wrapper call, kernel kind, slots)."""
    calls = {"row_sum_stream": (k_rs.row_sum_stream, "stream", 2)}
    for n in k_rs.SLOTS:
        calls[f"row_sum_ring_x{n}"] = (
            lambda x, n=n: k_rs.row_sum_ring(x, n), "ring", n)
    return calls


def phase_row_sum() -> tuple[dict, dict]:
    """The read-bandwidth probe. First its main path, the tool's entry
    point (``python -m graphneuralnetwork_tpu_torch.tools.bench_dma``) at
    its 1 GiB shape, with the launch counts set to 0 just before and read
    just after: each of its variants checked once against the float64 sum
    and timed (ms, GB/s, share of ``PEAK_BYTES_PER_S``; exact launches).
    Then both kernels, the ring at 2, 4 and 8 slots, on the 1 GiB shape and
    on ``ROW_SUM_SMALL``: normal data within the float32 summation bound of
    the float64 sum (γ(chain)·Σ|x|, ``row_sum_kernel.sum_tolerance``, the
    chain from each kernel's launch) and of the plain version (the two
    bounds added, the plain version's chain taken as the row count: its
    order is PyTorch's), and integer data in [-4, 4] (every partial sum
    exact in float32) equal to the float64 sum and to the plain version
    bit for bit; then one ``torch.sum(x, 0)`` timed as the library call.
    Each kernel call runs under ``ROW_SUM_CALL_LIMIT``."""
    t0 = time.perf_counter()
    reset_launches()
    faulthandler.dump_traceback_later(ROW_SUM_CALL_LIMIT, exit=True)
    try:
        tool = bench_dma.main(["--device", DEVICE])
    finally:
        faulthandler.cancel_dump_traceback_later()
    launches = read_launches()
    want = {**dict.fromkeys(COUNTERS, 0),
            "row_sum_stream": ROW_SUM_TOOL_CALLS,
            "row_sum_ring": len(k_rs.SLOTS) * ROW_SUM_TOOL_CALLS}
    if launches != want:
        raise AssertionError(f"bench_dma: launches {launches}, expected "
                             f"{want}")
    emit({"phase": "row_sum", "run": "tools.bench_dma", **tool,
          "launches": {k: launches[k] for k in ("row_sum_stream",
                                                "row_sum_ring")}})
    sms = tile_walk.sm_count(0)
    checks = {name: [] for name in _row_sum_calls()}
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for m, f in ((bench_dma.ROWS, bench_dma.WIDTH), ROW_SUM_SMALL):
        x = torch.randn(m, f, device=DEVICE, generator=gen)
        xi = torch.randint(-4, 5, (m, f), device=DEVICE,
                           generator=gen).float()
        ref = x.sum(0, dtype=torch.float64)
        ref_i = xi.sum(0, dtype=torch.float64)
        abs_sum = x.abs().sum(0, dtype=torch.float64)
        plain = k_rs.row_sum_plain(x)[0].double()
        plain_i = k_rs.row_sum_plain(xi)
        if not bool((plain_i.double() == ref_i).all()):
            raise AssertionError(f"row_sum_plain at {m}x{f}: integer data "
                                 "differ from the exact sum")
        plain_tol = k_rs.sum_tolerance(m, abs_sum)
        for name, (call, kind, slots) in _row_sum_calls().items():
            chain = k_rs.chain_length(kind, m, f, sms, slots)
            tol = k_rs.sum_tolerance(chain, abs_sum)
            out = _limited(lambda: call(x), name)
            err = bench_dma.check(name, out, ref, tol)
            vs_plain = (out[0].double() - plain).abs()
            if not bool((vs_plain <= tol + plain_tol).all()):
                raise AssertionError(f"{name} at {m}x{f}: off the plain "
                                     f"version by {float(vs_plain.max())}")
            exact = _limited(lambda: call(xi), name)
            if not (bool((exact.double() == ref_i).all())
                    and torch.equal(exact, plain_i)):
                raise AssertionError(f"{name} at {m}x{f}: integer data "
                                     "differ from the exact sum")
            checks[name].append({"shape": [m, f], "chain": chain,
                                 "max_abs_err": err,
                                 "tolerance_min": float(tol.min()),
                                 "vs_plain_max_abs_err": float(
                                     vs_plain.max()),
                                 "integer_exact": True})
        if (m, f) == (bench_dma.ROWS, bench_dma.WIDTH):
            library_ms = time_ms(lambda: torch.sum(x, 0))
        del x, xi, out, exact
    torch.cuda.empty_cache()
    emit({"phase": "row_sum", "checks": checks, "library_ms": library_ms,
          "call_limit_s": ROW_SUM_CALL_LIMIT,
          "seconds": time.perf_counter() - t0})
    return {"tool": tool, "checks": checks, "library_ms": library_ms}, \
        launches


def row_sum_rows(res: dict, launches: dict) -> list[dict]:
    """The ``kernels`` line's rows of the two row-sum kernels: the tool's
    times (the ring's timed case at 2 slots, every slot count in
    ``cases``), its bound, plain and library times, and the largest error
    of this run's checks against the plain version and against the
    float64 sum."""
    tool, var = res["tool"], res["tool"]["variants"]
    rows = []
    for name, replaces, timed, names in (
            ("row_sum_stream", "tools/bench_dma.py:31", "stream",
             ["stream"]),
            ("row_sum_ring", "tools/bench_dma.py:50", "ring_x2",
             [f"ring_x{n}" for n in k_rs.SLOTS])):
        mine = [c for key, cs in res["checks"].items()
                if key.startswith(name) for c in cs]
        rows.append({
            "name": name, "route": "cuda",
            "source": "graphneuralnetwork_tpu_torch/csrc/row_sum_kernel.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["vs_plain_max_abs_err"] for c in mine),
            "max_abs_err_vs_float64": max(c["max_abs_err"] for c in mine),
            "ms": var[timed]["ms"],
            "plain_ms": var["plain"]["ms"], "bound_ms": tool["bound_ms"],
            "bound_by": "bytes", "library_ms": res["library_ms"],
            "timed_case": f"float32 [{tool['rows']}, {tool['width']}]"
                          + (", 2 slots" if timed != "stream" else ""),
            "cases": [{"case": v, "ms": var[v]["ms"],
                       "gb_per_s": var[v]["gb_per_s"],
                       "peak_share": var[v]["peak_share"]} for v in names],
        })
    return rows


#: The sampled GraphSAGE pipeline's CLI runs: argv, the criterion's key
#: and its REPRO.md bound.
SAGE_RUNS = {
    "graphsage_sampled": (["--model", "graphsage"], "test_acc", 0.80),
    "graphsage_device_sampling": (
        ["--model", "graphsage", "--set", "device_sampling=true"],
        "test_acc", 0.80),
    "graphsage_unsup": (["--model", "graphsage_unsup"], "binary_acc", 0.75),
}


class _SageTimes:
    """Wall and device time of a sampled GraphSAGE run, by part: the host
    samplers (walks, negatives, hops), the hop ids' copy to the card (a
    synchronisation first, its wait kept apart), each training step's and
    evaluation batch's host call (gather, forward, backward, update
    launched) and the span of its work on the card (CUDA events around
    the call, which include the card's idle gaps while the host launches),
    and the device sampler's span. Sampling and copies are charged to the
    step or evaluation batch that follows them. ``report`` adds the device
    time of one step and one evaluation batch (and one device draw of
    hops): the last one's call replayed back to back behind a sleep
    kernel (``time_ms``, one call a batch), so no host gap counts."""

    def __init__(self):
        self.pending = {"sampling": 0.0, "wait": 0.0, "copy": 0.0}
        self.parts = {kind: {"batches": 0, "sampling": 0.0, "wait": 0.0,
                             "copy": 0.0, "host_call": 0.0, "wall": 0.0,
                             "events": [], "device_sampling": []}
                      for kind in ("train", "eval")}
        self.last = None
        self.dev_sampling = []
        self.calls = {}

    def sampler(self, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            self.pending["sampling"] += time.perf_counter() - t
            return out
        return timed

    def device_sampler(self, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.dev_sampling.append((start, end))
            self.calls["device_sampling"] = (fn, args, kw)
            return out
        return timed

    def copy(self, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kw)
            self.pending["wait"] += t1 - t
            self.pending["copy"] += time.perf_counter() - t1
            return out
        return timed

    def step(self, fn, kind):
        def timed(*args, **kw):
            t = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            done = time.perf_counter()
            part = self.parts[kind]
            part["batches"] += 1
            part["host_call"] += done - t
            # from the end of the batch before (the first: its own parts)
            part["wall"] += (done - self.last if self.last is not None
                             else done - t + sum(self.pending.values()))
            part["events"].append((start, end))
            part["device_sampling"] += self.dev_sampling
            self.dev_sampling = []
            for k, v in self.pending.items():
                part[k] += v
                self.pending[k] = 0.0
            self.last = done
            self.calls[kind] = (fn, args, kw)
            return out
        return timed

    def report(self) -> dict:
        """ms per batch of each part (0 for a part without batches)."""
        torch.cuda.synchronize()
        replay = {name: time_ms(lambda c=c: c[0](*c[1], **c[2]), reps=5,
                                batch=1)
                  for name, c in self.calls.items()}
        out = {}
        for kind, part in self.parts.items():
            n = max(part["batches"], 1)
            out[kind] = {
                "batches": part["batches"],
                "wall_ms": part["wall"] * 1e3 / n,
                "host_sampling_ms": part["sampling"] * 1e3 / n,
                "wait_ms": part["wait"] * 1e3 / n,
                "copy_ms": part["copy"] * 1e3 / n,
                "host_call_ms": part["host_call"] * 1e3 / n,
                "device_span_ms": sum(s.elapsed_time(e)
                                      for s, e in part["events"]) / n,
                "device_ms": replay.get(kind),
                "device_sampling_span_ms": sum(
                    s.elapsed_time(e)
                    for s, e in part["device_sampling"]) / n}
        out["device_sampling_ms"] = replay.get("device_sampling")
        return out


def _sage_split(argv) -> dict:
    """One instrumented CLI run: the ms of each part per training step and
    per evaluation batch (``_SageTimes``)."""
    from graphneuralnetwork_tpu_torch.sampling import device_neighbor

    times = _SageTimes()
    patches = [
        (sage_loop, "multihop_sampling",
         times.sampler(sage_loop.multihop_sampling)),
        (sage_loop, "uniform_walks", times.sampler(sage_loop.uniform_walks)),
        (sage_loop.NegativeSampler, "draw",
         times.sampler(sage_loop.NegativeSampler.draw)),
        (sage_loop, "_hops_to_device", times.copy(sage_loop._hops_to_device)),
        (sage_loop, "_supervised_step",
         times.step(sage_loop._supervised_step, "train")),
        (sage_loop, "_unsupervised_step",
         times.step(sage_loop._unsupervised_step, "train")),
        (sage_loop, "_infer", times.step(sage_loop._infer, "eval")),
        (device_neighbor, "device_multihop_sampling",
         times.device_sampler(device_neighbor.device_multihop_sampling)),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        res = cli_main(argv)
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
    return {"epochs_per_s": res["epochs_per_s"], **times.report()}


def phase_sage_sampled() -> dict:
    """The sampled GraphSAGE pipeline (no kernel, as in JAX). First
    ``SampledGraphSAGE`` at full width (the Pubmed synthetic's 500
    features, hidden 128, 3 classes, fanouts 10,10, a batch of 64) on the
    card against the same model on the CPU, on the same hops, for each
    aggregator: logits and gradients within ``PATH_TOL``. Then the CLI's
    three runs (``SAGE_RUNS``) with the launch counts set to 0 before each
    and read after: no kernel may launch, and each must reach its
    REPRO.md criterion; epochs/s. Then each run once more, instrumented:
    wall ms per training step (and evaluation batch) split into host
    sampling, the wait for the card and the copy of the hop ids, the
    step's host call, the span of its work on the card and its device time
    (``_SageTimes``)."""
    t0 = time.perf_counter()
    data = load_pubmed(seed=0)
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers,
                                        data.features.shape[0])
    hops = multihop_sampling(data.train_idx[:64], (10, 10), indptr, indices,
                             np.random.default_rng(0))
    feats = torch.from_numpy(data.features)
    labels = torch.from_numpy(data.labels.astype(np.int64))[hops[0]]
    path = {}
    for agg in ("mean", "sum", "max"):
        outs = []
        ref = SampledGraphSAGE(feats.shape[1], (128, data.num_classes),
                               (10, 10), aggregator=agg)
        ref.reset_parameters(torch.Generator().manual_seed(1))
        dev = SampledGraphSAGE(feats.shape[1], (128, data.num_classes),
                               (10, 10), aggregator=agg)
        dev.load_state_dict(ref.state_dict())
        dev.to(DEVICE)
        for model, device in ((ref, "cpu"), (dev, DEVICE)):
            f, y = feats.to(device), labels.to(device)
            logits = model([f[torch.from_numpy(h).long().to(device)]
                            for h in hops])
            masked_softmax_cross_entropy(logits, y).backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.cpu()
                          for k, p in model.named_parameters()}))
        (lr, gr), (ld, gd) = outs
        if not torch.isfinite(ld).all() or ld.shape != (64, 3):
            raise AssertionError(f"sage_sampled {agg}: bad logits")
        err = _rel_err(ld, lr)
        gerr = {k: _rel_err(gd[k], g) for k, g in gr.items()}
        if err > PATH_TOL or max(gerr.values()) > PATH_TOL:
            raise AssertionError(f"sage_sampled {agg}: card vs CPU logits "
                                 f"{err}, gradients {gerr}")
        path[agg] = {"logits_rel_err": err, "grad_rel_err": gerr}
    emit({"phase": "sage_sampled", "model": "card vs CPU",
          "tolerance": PATH_TOL, **path})
    runs = {}
    for name, (argv, key, bound_) in SAGE_RUNS.items():
        argv = argv + ["--device", DEVICE, "--quiet"]
        reset_launches()
        res = cli_main(argv)
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"{name}: kernels launched {launches}, "
                                 "expected none")
        if not res[key] >= bound_:
            raise AssertionError(f"{name}: {key} {res[key]} below the "
                                 f"REPRO criterion {bound_}")
        runs[name] = {"argv": argv, key: res[key],
                      "epochs": res["epochs"],
                      "epochs_per_s": res["epochs_per_s"],
                      "seconds": res["seconds"], "launches": 0}
        emit({"phase": "sage_sampled", "run": name, **runs[name]})
    for name, (argv, _, _) in SAGE_RUNS.items():
        split = _sage_split(argv + ["--device", DEVICE, "--quiet"])
        runs[name]["split"] = split
        emit({"phase": "sage_sampled", "run": name, "split": split})
    emit({"phase": "sage_sampled", "seconds": time.perf_counter() - t0})
    return runs


#: name, source, TPU kernel replaced, and which float32 case the summary
#: times (GCN's first layer for K1 and for K3 on the Cora hybrid; GAT's 8
#: heads for K2; the first GAT layer of a training step for K4-K6 and
#: K8-K10; SAGE's first layer on the Pubmed hybrid for K7)
KERNELS = {
    "K1": ("segment_sum", "graphneuralnetwork_tpu_torch/csrc/spmm_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py:94",
           _width("cora", 128)),
    "K2": ("segment_max",
           "graphneuralnetwork_tpu_torch/csrc/segment_max_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/segment_max_kernel.py:28",
           _width("cora", 8)),
    "K3": ("bcsr_spmm",
           "graphneuralnetwork_tpu_torch/csrc/bcsr_spmm_kernel.cu",
           "graphneuralnetwork_tpu/ops/bcsr_spmm.py:63",
           _width("cora_gcn", 128)),
    "K4": ("attend_online",
           "graphneuralnetwork_tpu_torch/csrc/attend_online_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/attend_online_kernel.py:198",
           _cora_gat_train),
    "K5": ("attend_bwd_a",
           "graphneuralnetwork_tpu_torch/csrc/attend_bwd_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/attend_bwd_kernel.py:68",
           _cora_gat_train),
    "K6": ("attend_bwd_b",
           "graphneuralnetwork_tpu_torch/csrc/attend_bwd_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/attend_bwd_kernel.py:251",
           _cora_gat_train),
    "K7": ("neighbor_max",
           "graphneuralnetwork_tpu_torch/csrc/neighbor_max_kernel.cu",
           "graphneuralnetwork_tpu/ops/bcsr_attention.py:131",
           _width("pubmed", 500)),
    "K8": ("rem_attend",
           "graphneuralnetwork_tpu_torch/csrc/attend_fused_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/rem_attend_kernel.py:48",
           _cora_gat_train),
    "K9": ("tile_parts",
           "graphneuralnetwork_tpu_torch/csrc/attend_fused_kernel.cu",
           "graphneuralnetwork_tpu/ops/bcsr_attention.py:417",
           _cora_gat_train),
    "K10": ("attend_fused",
            "graphneuralnetwork_tpu_torch/csrc/attend_fused_kernel.cu",
            "graphneuralnetwork_tpu/ops/bcsr_attention.py:440",
            _cora_gat_train),
}


def summary(cases, launches, floor_ms) -> dict:
    """The ``kernels`` line: each kernel's timed case, and the launch
    floor (an empty kernel through the same ctypes path) beside them."""
    rows = []
    for kern, (name, source, replaces, pick) in KERNELS.items():
        f32 = [c for c in cases
               if c["kernel"] == kern and c["dtype"] == "float32"]
        c = next(c for c in f32 if pick(c))
        rows.append({
            "name": f"{kern} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": max(x["max_abs_err"] for x in f32),
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "timed_case": f"float32 {c['shape']} on {c['graph']}"
                          + (" with dropout" if c.get("dropout") else ""),
        })
        if kern in ("K2", "K3", "K7"):   # every case of this run
            rows[-1]["cases"] = [
                {"case": _case_name(x), "ms": x["kernel_ms"],
                 "bound_ms": x["bound_ms"]}
                for x in cases if x["kernel"] == kern]
    return {"kernels": rows, "launch_floor_ms": floor_ms}


def _tile_case(c) -> str:
    return (f"{c['dtype']} {c['shape']} on {c['graph']}, {c['tile_dtype']} "
            "tiles")


def _case_name(c) -> str:
    if c["kernel"] == "K2":
        return f"{c['form']} {c['shape']} on {c['graph']}"
    return _tile_case(c)


def _attend_key(c) -> tuple:
    """An attend case's key; K8-K10's also name the shift."""
    key = (c["kernel"], c["graph"], c["dtype"],
           f"{c['shape'][1]}x{c['shape'][2]}", c["dropout"])
    return key + ((c["shift"],) if "shift" in c else ())


def previous_design(cases) -> dict:
    """Each K2-K10 case's time in this run beside its previous design's,
    which ``PREVIOUS_DESIGN_MS`` holds as recorded (None where it holds
    none), not measured here."""
    rows = []
    for c in cases:
        if c["kernel"] == "K2":
            case = _case_name(c)
            key = ("K2", c["graph"], c["shape"][1])
        elif c["kernel"] in ("K3", "K7"):
            case = _tile_case(c)
            key = (c["kernel"], c["graph"], c["dtype"], c["shape"][1])
        elif c["kernel"] in ("K4", "K5", "K6", "K8", "K9", "K10"):
            key = _attend_key(c)
            case = (f"{c['dtype']} {key[3]} on {c['graph']}"
                    + (" with dropout" if c["dropout"] else "")
                    + (f", m {c['shift']}" if "shift" in c else ""))
        else:
            continue
        rows.append({"kernel": c["kernel"], "case": case,
                     "ms": c["kernel_ms"], "bound_ms": c["bound_ms"],
                     "recorded_previous_design_ms":
                         PREVIOUS_DESIGN_MS.get(key)})
    return {"previous_design": {
        "recorded_ms_from": "PERF.md (NVIDIA H100 80GB HBM3, 700.00 W); "
                            "not measured in this run",
        "cases": rows}}


def main() -> None:
    phase_device()
    phase_build()
    cora = load_cora(seed=0, layout="coo", device=DEVICE)
    # the GAT data as the CLI loads them: auto layout -> hybrid, clustered,
    # unit weights
    cora_h = load_cora(seed=0, layout="auto", layout_objective="attention",
                       device=DEVICE, model="gat")
    cora_hg = cora_h.graph
    if not hasattr(cora_hg, "bcsr"):
        raise AssertionError("GAT on Cora did not choose the hybrid layout")
    # GCN's and SAGE's hybrids as the CLI loads them
    cora_g = load_cora(seed=0, layout="hybrid", device=DEVICE)
    pubmed = load_pubmed_fullbatch(seed=0, layout="hybrid", device=DEVICE)
    large = _large_hybrid()
    cases, floor_ms = phase_kernels(cora, cora_hg, pubmed.graph, large)
    cases += (phase_attend_kernels(cora_hg, large)
              + phase_tile_kernels(cora_g.graph, cora_hg, pubmed.graph,
                                   large))
    del large
    phase_path(cora, cora_h, cora_hg, cora_g, pubmed)
    # the three-pass attend and its stage profiler: the only paths that
    # reach K8-K10 (no CLI run does)
    runs = [phase_three_pass(cora_hg), phase_profile_attend()]
    cora_h16 = load_cora(seed=0, layout="auto", layout_objective="attention",
                         device=DEVICE, model="gat", tile_dtype=torch.bfloat16)
    phase_capture(cli_configs(cora, cora_h, cora_h16, cora_g, pubmed))
    del cora_h16
    runs += [
        _drive("gcn", ["--model", "gcn", "--epochs", str(GCN_EPOCHS),
                       "--device", DEVICE, "--quiet"], {"K1": (4, 2)}),
        _drive("gat", ["--model", "gat", "--layout", "coo", "--epochs",
                       str(GAT_EPOCHS), "--device", DEVICE, "--quiet"],
               {"K1": (8, 4), "K2": (4, 2)}),
    ]
    # per epoch: 2 layers x (train + val forward) K4, 2 layers x backward
    # K5 and K6; the final test evaluation adds one forward
    hybrid = {"K4": (4, 2), "K5": (2, 0), "K6": (2, 0)}
    for dtype in ("float32", "bfloat16"):
        runs.append(_drive(
            "gat_hybrid" + ("_bf16" if dtype == "bfloat16" else ""),
            ["--model", "gat", "--epochs", str(GAT_EPOCHS), "--dtype", dtype,
             "--device", DEVICE, "--quiet"], hybrid))
    # GCN hybrid per epoch: 2 layers x (train + val forward) K3 on the
    # tiles and K1 on the remainder, 2 K3 in the backward (the transpose
    # tiles for d support of both layers; the remainder's is a gather)
    for dtype in ("float32", "bfloat16"):
        runs.append(_drive(
            "gcn_hybrid" + ("_bf16" if dtype == "bfloat16" else ""),
            ["--model", "gcn", "--layout", "hybrid", "--epochs",
             str(GCN_EPOCHS), "--dtype", dtype, "--device", DEVICE,
             "--quiet"], {"K3": (6, 2), "K1": (4, 2)}))
    # SAGE mean per forward: 2 layers x (counts + sum) K3 and K1; the
    # backward needs d input of sage_out only (sage0's input is the
    # features): 1 K3. Max per forward: 2 layers x (K7 + K2), backward in
    # plain PyTorch.
    sage = ["--model", "graphsage", "--layout", "hybrid", "--epochs",
            str(SAGE_EPOCHS), "--device", DEVICE, "--quiet"]
    runs.append(_drive("graphsage_hybrid", sage,
                       {"K3": (9, 4), "K1": (8, 4)}))
    runs.append(_drive("graphsage_hybrid_max",
                       sage + ["--set", "aggregator=max"],
                       {"K7": (4, 2), "K2": (4, 2)}))
    row_sum, row_sum_launches = phase_row_sum()
    runs.append(row_sum_launches)
    phase_sage_sampled()
    emit(previous_design(cases))
    launches = {k: sum(run[k] for run in runs) for k in COUNTERS}
    line = summary(cases, launches, floor_ms)
    line["kernels"] += row_sum_rows(row_sum, launches)
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
