#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphneuralnetwork_tpu_torch) on one
NVIDIA Hopper card. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — needs a CUDA device; prints the card's name and power limit
               as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
  2. build   — compiles every kernel of ``csrc/`` with nvcc, in parallel;
  2b. native — builds the C++ host engine of ``native/`` (g++, OpenMP) and
               reports its build seconds, thread count and the host CPU
               beside the card; times each of its entry points against
               its numpy path on the card's host at the sizes the CLI and
               the kernel phases give it (``build_graph``'s arrays and
               ``sym_normalize_weights`` on the 2M-edge community graph,
               byte-equal and within 1e-6; DeepWalk's walks at 2,405
               nodes; ``multihop_sampling`` at the ``SageConfig``
               defaults; Struc2Vec's distances at 500 nodes, within 1e-9
               with the same layer counts; ``read_edgelist`` on a numeric
               edge list of 2,405 nodes, the same ids and vocabulary),
               checks that its walks and draws follow edges and repeat for
               a seed, and trains ``--model metapath2vec --dataset`` on an
               empty directory (the JData loader's synthetic actions):
               no launch, a falling loss. Every later phase's host
               samplers and graph builds of 16,384 edges or more take
               this engine, as JAX's do;
  3. kernels — holds each kernel against its plain PyTorch version, on the
               card, at the shapes the main path gives it and at larger
               shapes, and times kernel, plain version and, where one
               exists, one library call (CUDA events, warmed, median):
               the launch floor (an empty kernel through the same ctypes
               path); K1/K2 on the Cora COO graph and a 2M-edge graph, K1
               also in its gathered form (the sender gather read in the
               kernel) at GCN's F=128 with the edge weights and at
               GAT-COO's 8 heads x 8 with [E, 8] weights, and in its
               transposed forms (the gathered form's d x over the graph's
               sender-sorted transpose, and a sender gather's backward:
               per-edge values read at the edge ids) at the same shapes;
               K2 also on a graph with a hub row and in its gathered form on
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
               hybrid and the community graph's bfloat16 tiles; and
               at HAN's shapes (``phase_han_kernels``) K4, K5 and K6 at 4
               heads x 8 on the PAP metapath graph of the 600-paper
               synthetic ACM (an empty remainder) and of the 3,025-paper
               one (a remainder of ~12,000 edges), x in float32 and in
               bfloat16 over float32 tiles, without and with dropout;
               and at GTN's shapes (``phase_gtn_kernels``) K1 on the
               final convolution of the wedge plan of the 920-node ACM
               stack (C x hidden = 128, float32 and bfloat16) and of the
               3,025-paper stack (float32), per edge and in the gathered
               form the model runs (x [N, 2 x 64], weights [E, 2]), and
               on the 920-node plan's second composition (its 2 channels,
               over rows of (output slot, edge type)), per edge and in
               the gathered form the model runs, forward and backward,
               these GTN cases also with the L2 flushed before each call;
               K1's library call is ``index_add_`` per edge and
               ``torch.sparse.mm`` on a CSR matrix in the gathered form
               with [E] weights, and beside every gathered case one
               ``index_add_`` of its products gathered beforehand;
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
 13. han     — HAN through the CLI, 100 epochs each: ``--model han`` (auto
               -> hybrid on the 600-paper ACM, empty remainders) in
               float32 and bfloat16, ``--set n_papers=3025`` (hybrid with
               remainders) and ``--layout coo --set n_papers=3025`` (K1 and
               K2), each in 20-epoch chunks of one captured epoch, and
               ``--model han_batch`` (dense node minibatches, no kernel):
               test_acc >= 0.80 and exact launch counts (``HAN_RUNS``);
               each full-batch configuration's chunk timed (wall ms per
               epoch captured and eager, device ms per epoch); HAN card vs
               CPU (``HAN_TOL``) on the CLI's 600-paper hybrid in float32
               and bfloat16, the 3,025-paper hybrid and its COO graphs.
 14. row_sum — the read-bandwidth probe, the port of ``tools/bench_dma.py``:
               its entry point (``tools/bench_dma.py`` of the port) at the
               1 GiB shape with exact launch counts, every variant's ms,
               GB/s and share of ``PEAK_BYTES_PER_S``; both kernels (the
               ring at 2, 4 and 8 slots) at that shape and a small one
               against the float64 sum and the plain version (normal
               data within the float32 summation bound, integer data
               exactly), each call under a time limit; ``torch.sum``
               timed as the library call;
 15. sage_sampled — the sampled GraphSAGE pipeline (no kernel):
               ``SampledGraphSAGE`` at full width card vs CPU; ``--model
               graphsage`` (test_acc >= 0.80), with ``--set
               device_sampling=true`` (>= 0.80) and ``--model
               graphsage_unsup`` (binary_acc >= 0.75), no kernel launched;
               epochs/s, then each run instrumented: wall ms per training
               step split into host sampling, copy, host call and device
               time.
 16. gtn     — GTN through the CLI, 40 epochs each in 10-epoch chunks of
               one captured epoch: ``--model gtn`` (dense, no kernel) and
               ``--layout sparse`` (K1), each in float32 and bfloat16:
               test_acc >= 0.80 and exact launch counts (``GTN_RUNS``);
               GTN card vs CPU (``GTN_TOL``) at 920 nodes, dense and
               sparse, float32 and bfloat16; the captured chunk bit-equal
               to eager epochs from a twin state (dense float32 and
               bfloat16, sparse float32 at 920 nodes; dense and sparse
               float32 at 4,637), with the wall ms per epoch of both, the
               device ms per epoch, the first chunk's ms and a replay's
               costliest kernels (``torch.profiler``); the sparse
               model's logits within ``GTN_DENSE_SPARSE`` of the dense
               model's at 4,637 nodes.
 17. embed   — the walk embedders (no kernel, as in JAX): the nine CLI
               runs of ``EMBED_RUNS`` at the reference's defaults (DeepWalk,
               Node2vec and MetaPath2Vec also with ``device_walks=true``,
               Struc2Vec, LINE, SDNE) with the launch counts set to 0
               before each and read after: no kernel may launch, the loss
               must fall and the embedding be [V, 128]; each run's host
               seconds (walks, Struc2Vec layers, corpus), steps/s and
               epochs/s, and ms per step of its device loop captured and
               eager (wall, replays behind a sleep kernel, profiler kernel
               time); one step of SkipGram, LINE and SDNE card vs CPU
               (the loss, every gradient and every parameter after the
               step within ``EMBED_TOL``); DeepWalk's and SDNE's captured
               epochs bit-equal to eager ones; DeepWalk, LINE and SDNE at
               2,405 nodes (``WIKI_NODES``) through the ``run_*`` API.
 18. linkpred — GATNE, BiNE and the centrality toolkit (no kernel, as in
               JAX), the counts set to 0 before each run and read after:
               ``--model gatne`` at its defaults (5 epochs of 714 steps,
               test F1 >= 0.60 and AUC >= 0.75, REPRO.md:20), with ``--set
               loss=masked_bce``, ``aggregator=sum`` and ``inductive=true``
               (the loss falls, finite metrics), each with the host
               seconds of its neighbour tables, walks, pairs and draws, the
               first epoch's ms, steady steps/s and epochs/s and the
               evaluation's ms an epoch, and for the defaults and
               ``masked_bce`` the ms per step of the device loop (captured
               and eager; wall, replays behind a sleep kernel, profiler
               kernel time); two captured GATNE epochs of each loss
               bit-equal to eager ones; one step of each GATNE loss and of
               BiNE card vs CPU (``EMBED_TOL``); ``--model bine`` at its
               defaults (F1 >= 0.60 and AUC >= 0.75, REPRO.md:21) with the
               host seconds of HITS, walks and side corpora and its eager
               ms per step split into host and device; ``--model basis``
               on the card against the CPU (``BASIS_TOL``; components,
               degrees and diameter equal).
 19. parallel — data, graph and tensor parallelism on
               ``torch.distributed`` (``parallel/``): (a)
               ``initialize_distributed`` at world 1 on NCCL (a TCP store
               on a free local port, rank 0); (b) the dry run's ten
               phases (``parallel/dryrun.py``: GCN on a tiled halo
               partition, GAT on it, HAN on halo metapath graphs,
               device-sampled SAGE, DP skip-gram, DP node2vec walks,
               dp x tp GCN and GAT on the 1 x 1 mesh, the dense GTN on
               its stack's rows, the wedge-plan GTN on a sharded plan) at
               the Cora width (GTN: the CLI's 920-node ACM stack, 2
               channels, hidden 64), each step's logits, loss and
               gradients within ``PATH_TOL`` of the single-device model on
               the same weights, K1 (and K2, K3, K7) launched exactly
               ``PARALLEL_LAUNCHES`` times a step, each step's ms and the
               collectives' host ms and NCCL kernels' device ms in one
               more step (``torch.profiler``), and the halo GCN trained
               200 epochs at the CLI's recipe to test_acc >= 0.80; (c) a
               4-way tiled halo partition of the same graph: each rank's
               local step on the card, its halo slab built here from the
               whole array, the four ranks' rows against the
               single-device ``spmm``, ``segment_max`` and edge-softmax
               attention; (d) a 2 x 2 dp x tp layout of GCN and GAT split
               by hand (``_tp_by_hand``: K1, K2, K3 and K7 at the sharded
               widths), the ranks' logits, loss and gradients against the
               single-device model; (e) run after phase 16 on its plans:
               the 920- and 4,637-node wedge plans sharded 4 ways, each
               rank's compose and ``dh`` (K1 over its orders) held against
               the plain version and timed beside its bound, the ranks'
               parts against the single-device composition
               (``phase_gtn_sharded``); (f) ``tools/bench_scaling.py`` at
               world 1 at its default sizes, edges/s beside the card's
               name and power limit; (g) the process group destroyed.
Then a ``previous_design`` line (every K1-K10 case beside its previous
design's time where ``PREVIOUS_DESIGN_MS`` records one, not measured
here), a ``kernels`` summary line (K1-K10 and the two row-sum kernels,
with the launch floor) and, last,
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without the last line.
"""

from __future__ import annotations

import collections
import dataclasses
import faulthandler
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from graphneuralnetwork_tpu_torch.cli import main as cli_main
from graphneuralnetwork_tpu_torch.core.bcsr import (COL_BLOCK, ROW_BLOCK,
                                                    build_hybrid)
from graphneuralnetwork_tpu_torch.core.graph import build_graph
from graphneuralnetwork_tpu_torch.data import acm as acm_data
from graphneuralnetwork_tpu_torch.data import (load_acm_gtn, load_acm_han,
                                               load_cora, synthetic_acm,
                                               load_pubmed,
                                               load_pubmed_fullbatch)
from graphneuralnetwork_tpu_torch.nn import GAT, GCN, HAN, GraphSAGE
from graphneuralnetwork_tpu_torch.nn.gtn import GTN
from graphneuralnetwork_tpu_torch.nn.gtn_sparse import (SparseGTN,
                                                        build_gtn_plan,
                                                        stacked_adj_to_sparse)
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
from graphneuralnetwork_tpu_torch.tools.timing import kernel_ms, time_ms
from graphneuralnetwork_tpu_torch.data.edgelist import (load_edgelist,
                                                        load_multiplex,
                                                        synthetic_smallworld)
from graphneuralnetwork_tpu_torch.analysis.demo import basis_demo
from graphneuralnetwork_tpu_torch.models import bine, embedding, gatne
from graphneuralnetwork_tpu_torch.nn.embed import LINE, SkipGram
from graphneuralnetwork_tpu_torch.train import embed_loop
from graphneuralnetwork_tpu_torch.train import sage_loop
from graphneuralnetwork_tpu_torch.train.gtn_loop import (GTNBlock,
                                                         create_gtn_state,
                                                         run_gtn_epochs)
from graphneuralnetwork_tpu_torch.train.han_loop import (HANBlock,
                                                         run_han_epochs)
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
#: 700.00 W", PERF.md): K1 (a thread per row and 16-byte column vector;
#: its per-edge cases as this script last timed them, PERF.md §6) keyed
#: by (kernel, graph, dtype, width);
#: K2 (a thread per row and column) keyed by (kernel, graph, width); K3
#: and K7 (a CTA per quarter row block and
#: 32-column slab) by (kernel, graph, x dtype, width); K4, K5 and K6
#: (a warp per row, a lane group per head, two passes in K4) by (kernel,
#: graph, x dtype, "HxF", dropout); K8, K9 and K10 (a warp per row, a
#: lane group per head) by the same and the shift. Recorded, not measured
#: by this script: ``previous_design`` prints them on a line of their own
#: beside this run's times.
PREVIOUS_DESIGN_MS = {
    ("K1", "cora", "float32", 128): 0.003965,
    ("K1", "cora", "float32", 7): 0.003651,
    ("K1", "cora", "float32", 64): 0.003962,
    ("K1", "cora", "float32", 8): 0.004571,
    ("K1", "cora", "float32", 1): 0.003320,
    ("K1", "large", "float32", 128): 0.3677,
    ("K1", "cora", "bfloat16", 128): 0.005018,
    ("K1", "cora", "bfloat16", 7): 0.003302,
    ("K1", "cora", "bfloat16", 64): 0.005437,
    ("K1", "cora", "bfloat16", 8): 0.004651,
    ("K1", "cora", "bfloat16", 1): 0.003021,
    ("K1", "large", "bfloat16", 128): 0.1930,
    ("K1", "cora_padded_spans", "float32", 128): 0.05655,
    ("K1", "gtn_final", "float32", 128): 0.06681,
    ("K1", "gtn_final", "bfloat16", 128): 0.06511,
    ("K1", "gtn3025_final", "float32", 128): 0.1814,
    ("K1", "gtn_compose1", "float32", 2): 0.006530,
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


def _ptxas_by_function(log: str) -> dict:
    """ptxas's registers and spills of each kernel function in ``log``,
    by its demangled name (the mangled one where ``c++filt`` is absent)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return out
    return dict(zip(names, out.values())) if len(names) == len(out) else out


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": build.kernel_names(), "ptxas": ptxas,
          "k1_ptxas": _ptxas_by_function(logs.get("spmm_kernel", ""))})


def _host_s(fn, reps: int = 3):
    """(the last result, the median host seconds) of ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _follows_edges(indptr, indices, src, dst) -> bool:
    """Whether every step ``src[i] -> dst[i]`` is an edge of the CSR, or
    stays at a node without neighbours."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    n = len(indptr) - 1
    senders = np.repeat(np.arange(n), np.diff(indptr))
    deg = np.diff(indptr)[src]
    on_edge = np.isin(src * n + dst, senders * n + indices)
    return bool(np.all(np.where(deg > 0, on_edge, dst == src)))


def _engine_row(entry, engine, numpy_path, size, **checks) -> dict:
    """Time ``engine`` against ``numpy_path`` (host seconds, median of
    three); returns both results and the row emitted."""
    got, engine_s = _host_s(engine)
    want, numpy_s = _host_s(numpy_path)
    row = {"phase": "native", "entry": entry, "size": size,
           "engine_s": engine_s, "numpy_s": numpy_s,
           "numpy_over_engine": numpy_s / engine_s, **checks}
    return got, want, row


def phase_native(card: str) -> None:
    """The C++ host engine (``sampling/native.py``), built here from the
    checkout's ``native/*.cpp``, on the card's host: its build seconds,
    thread count and the host CPU beside the card; each entry point timed
    against its numpy path at the sizes the CLI and the kernel phases give
    it, with its result checked against that path; the engine's walks and
    neighbour draws checked to follow edges and to repeat for a seed; and
    the JData pipeline (``--model metapath2vec --dataset`` on an empty
    directory: the loader's synthetic action table) through the CLI."""
    from graphneuralnetwork_tpu_torch.core import graph as core_graph
    from graphneuralnetwork_tpu_torch.data import edgelist
    from graphneuralnetwork_tpu_torch.sampling import native, struc2vec
    from graphneuralnetwork_tpu_torch.sampling.neighbor import (
        sample_neighbors)
    from graphneuralnetwork_tpu_torch.sampling.walks import uniform_walks

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    log = native.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "native", "card": card, "build_s": build_s,
          "compiled_now": log is not None,
          "library": str(native.library_path().name),
          "num_threads": native.num_threads(),
          "host_cpu": native.host_cpu()[0],
          "host_isa": [f for f in ("avx2", "avx512f", "avx512_bf16",
                                   "amx_tile")
                       if f in native.host_cpu()[1].split()],
          "host_cores": len(os.sched_getaffinity(0))})
    rows = []

    # the graph build and GCN's normalisation at the kernels' 2M-edge size
    big = ATTEND_LARGE
    s, r = _community_graph(big["n"], big["e"], big["comm"])
    n = big["n"]
    w = np.random.default_rng(1).random(len(s)).astype(np.float32)
    e_pad = -(-len(s) // core_graph.EDGE_BLOCK) * core_graph.EDGE_BLOCK
    s32, r32 = s.astype(np.int32), r.astype(np.int32)
    got, want, row = _engine_row(
        "build_graph", lambda: native.build_graph_native(
            s32, r32, w, n, e_pad, core_graph.ROW_BLOCK,
            core_graph.EDGE_BLOCK),
        lambda: core_graph._build_arrays(s32, r32, w, n, e_pad),
        {"nodes": n, "edges": len(s)})
    if not (all(np.array_equal(a, b) for a, b in zip(got[:5], want[:5]))
            and got[5] == want[5]):
        raise AssertionError("native build differs from the numpy build")
    rows.append({**row, "byte_equal": True})
    got, want, row = _engine_row(
        "sym_normalize_weights",
        lambda: core_graph.sym_normalize_weights(s32, r32, n, w),
        lambda: core_graph._normalized(s32, r32, w, n, "sym"),
        {"nodes": n, "edges": len(s)})
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-30)))
    if err > 1e-6:
        raise AssertionError(f"native sym weights off by rtol {err}")
    rows.append({**row, "max_rel_err": err, "rtol": 1e-6})
    del s, r, s32, r32, w, got, want

    # DeepWalk's walks at the Wiki edge list's size: 80 walks of 10 a node
    wiki = synthetic_smallworld(n_nodes=WIKI_NODES, k=WIKI_K, seed=0)
    indptr, indices, _ = csr_from_edges(wiki.senders, wiki.receivers,
                                        WIKI_NODES)
    starts = np.tile(np.arange(WIKI_NODES), 80)
    walks, numpy_walks, row = _engine_row(
        "uniform_walks",
        lambda: uniform_walks(indptr, indices, starts, 10,
                              np.random.default_rng(0)),
        lambda: uniform_walks(indptr, indices, starts, 10,
                              np.random.default_rng(0), use_native=False),
        {"walks": len(starts), "length": 10, "nodes": WIKI_NODES})
    again = uniform_walks(indptr, indices, starts, 10,
                          np.random.default_rng(0))
    follows = _follows_edges(indptr, indices, walks[:, :-1].ravel(),
                             walks[:, 1:].ravel())
    if not (follows and np.array_equal(walks, again)
            and walks.shape == numpy_walks.shape):
        raise AssertionError(f"native walks: follow edges {follows}, "
                             "repeat for a seed "
                             f"{np.array_equal(walks, again)}")
    rows.append({**row, "follow_edges": True, "same_seed_same_walks": True})

    # multihop_sampling at the SageConfig defaults on the Pubmed synthetic
    data = load_pubmed(seed=0)
    n_p = data.features.shape[0]
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, n_p)
    batch = data.train_idx[:64]

    def numpy_hops():
        rng, hops = np.random.default_rng(0), [batch.astype(np.int32)]
        for f in (10, 10):
            hops.append(sample_neighbors(hops[-1], f, indptr, indices, rng,
                                         use_native=False))
        return hops

    hops, want, row = _engine_row(
        "multihop_sampling",
        lambda: multihop_sampling(batch, (10, 10), indptr, indices,
                                  np.random.default_rng(0)),
        numpy_hops, {"batch": 64, "fanouts": [10, 10], "nodes": n_p})
    again = multihop_sampling(batch, (10, 10), indptr, indices,
                              np.random.default_rng(0))
    follows = all(_follows_edges(indptr, indices, np.repeat(a, 10), b)
                  for a, b in zip(hops[:-1], hops[1:]))
    if not (follows and all(np.array_equal(a, b)
                            for a, b in zip(hops, again))
            and [len(h) for h in hops] == [len(h) for h in want]):
        raise AssertionError("native neighbour draws: follow edges "
                             f"{follows}")
    rows.append({**row, "follow_edges": True, "same_seed_same_hops": True})

    # Struc2Vec's distances at the CLI's 500-node graph
    g500 = load_edgelist(seed=0)
    indptr, indices, _ = csr_from_edges(g500.senders, g500.receivers,
                                        g500.n_nodes)
    pairs = struc2vec.candidate_pairs(indptr, g500.n_nodes)[1]
    args = (indptr, indices, g500.n_nodes, 3, pairs[:, 0], pairs[:, 1])
    (f, nl), (f_np, nl_np), row = _engine_row(
        "struc2vec_distances",
        lambda: native.struc2vec_distances_native(*args),
        lambda: struc2vec._numpy_distances(*args),
        {"pairs": len(pairs), "nodes": g500.n_nodes, "k_max": 3})
    err = float(np.max(np.abs(f - f_np) / np.maximum(np.abs(f_np), 1e-30)))
    if not (np.array_equal(nl, nl_np) and err <= 1e-9):
        raise AssertionError(f"native Struc2Vec distances: layers equal "
                             f"{np.array_equal(nl, nl_np)}, rtol {err}")
    rows.append({**row, "max_rel_err": err, "rtol": 1e-9,
                 "same_layers": True})

    with tempfile.TemporaryDirectory() as tmp:
        # read_edgelist on the 2,405-node graph as a numeric edge list
        path = f"{tmp}/wiki.edgelist"
        half = len(wiki.senders) // 2
        with open(path, "w") as fh:
            fh.writelines(f"{a} {b}\n" for a, b in
                          zip(wiki.senders[:half], wiki.receivers[:half]))
        got, (vocab, s_py, r_py, _), row = _engine_row(
            "read_edgelist", lambda: edgelist.read_edgelist(
                path, directed=True),
            lambda: edgelist._read_tokens(path, False),
            {"edges": half, "nodes": WIKI_NODES})
        if not (np.array_equal(got.senders, s_py)
                and np.array_equal(got.receivers, r_py)
                and got.vocab.idx_to_token == vocab.idx_to_token):
            raise AssertionError("native edge-list parse differs from the "
                                 "Python reader")
        rows.append({**row, "same_ids_and_vocab": True})
        for row in rows:
            emit(row)

        # the JData pipeline on the loader's synthetic action table
        reset_launches()
        res = cli_main(["--model", "metapath2vec", "--dataset", tmp,
                        "--device", DEVICE, "--quiet"])
        launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"jdata: kernels launched {launches}")
    if not (res["final_loss"] < res["initial_loss"]
            and res["embed_shape"] == [350, 128]):
        raise AssertionError(f"jdata: {res}")
    emit({"phase": "native", "run": "metapath2vec_jdata",
          "dataset": "empty directory (synthetic JData actions)",
          "initial_loss": res["initial_loss"],
          "final_loss": res["final_loss"],
          "embed_shape": res["embed_shape"], "epochs": res["epochs"],
          "seconds": res["seconds"], "launches": 0})
    emit({"phase": "native", "seconds": time.perf_counter() - t_phase})


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


def _k1_layout(values, out_c, heads, n, e) -> dict:
    lay = k1.spmm_layout(out_c, out_c // heads, values.element_size(),
                         e / max(n, 1), n, tile_walk.sm_count(
                             torch.device(DEVICE).index or 0))
    return dataclasses.asdict(lay)


#: Bytes written between two calls of ``_cold_ms``: more than the card's
#: L2 (50 MB on an H100), so each call reads its operands from DRAM.
L2_FLUSH_BYTES = 64 << 20


def _cold_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn`` with the L2 flushed before
    it (``L2_FLUSH_BYTES`` written), each call between its own two events;
    ``time_ms`` times calls back to back, where an operand smaller than
    the L2 stays there from one call to the next."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=DEVICE)
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for start, end in events:
        scratch.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _k1_case(values, recv, row_ptr, n, label, long_rows=None,
             long_edges=0, cold=False):
    """K1's per-edge form on ``values`` against its plain version. Only
    the ``row_ptr[-1]`` spanned edges count (Cora's padding does not), so
    the plain version, the library call and the bound all take those edges
    alone. ``long_rows``: the rows a CTA of their own takes (the graph's,
    as the main path passes them; None on raw arrays). ``cold``: also time
    K1 with the L2 flushed before each call (``kernel_cold_ms``)."""
    elt = values.element_size()
    f = values.shape[1]
    e = int(row_ptr[-1])
    vals, rec = values[:e], recv[:e]
    kw = dict(n_edges=e, long_rows=long_rows, long_edges=long_edges)
    out = k1.segment_sum(values, recv, row_ptr, n, **kw)
    ref = k1.segment_sum_plain(vals, rec, n)
    torch.cuda.synchronize()
    dtype = str(values.dtype).replace("torch.", "")
    abs_sum = k1.segment_sum_plain(vals.float().abs(), rec, n)
    err, rtol, atol = _check(f"K1 {label}", out, ref, dtype, abs_sum)
    lib_out = torch.zeros(n, f, dtype=values.dtype, device=DEVICE)
    n_bytes = e * f * elt + (n + 1) * 4 + n * f * elt
    b_ms, b_by = bound(n_bytes, e * f)
    def kernel():
        return k1.segment_sum(values, recv, row_ptr, n, **kw)

    return dict(
        kernel="K1", form="edges", shape=list(values.shape), edges_read=e,
        dtype=dtype, n_out=n, graph=label, max_abs_err=err, rtol=rtol,
        atol=atol, layout=_k1_layout(values, f, 1, n, e),
        long_rows=0 if long_rows is None else int(long_rows.numel()),
        kernel_ms=time_ms(kernel),
        **({"kernel_cold_ms": _cold_ms(kernel)} if cold else {}),
        plain_ms=time_ms(lambda: k1.segment_sum_plain(vals, rec, n)),
        library_ms=time_ms(lambda: lib_out.index_add_(0, rec, vals)),
        library="index_add_", bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)


def _k1_csr_library(table, rows_ptr, cols, w, n):
    """One PyTorch call for K1's gathered form with [E] weights:
    ``torch.sparse.mm`` on a CSR matrix of the spans ``rows_ptr``, the
    gathered rows ``cols`` and the weights ``w`` in the table's type,
    built once. Returns the call and its output, or None and the reason
    where PyTorch refuses it."""
    a = torch.sparse_csr_tensor(rows_ptr, cols, w.to(table.dtype),
                                size=(n, table.shape[0]))
    try:
        out = torch.sparse.mm(a, table)
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:120]}"
    return (lambda: torch.sparse.mm(a, table)), out


def _k1_gathered_case(label, form, table, rows, row_ptr, n, senders,
                      weight=None, weight_at=None, round_weight=False,
                      long_rows=None, long_edges=0, cold=False):
    """K1's gathered form, ``out[r] = Σ_e round(w · table[senders_e])``,
    against its plain version (``gathered_plain`` then
    ``segment_sum_plain``) over the ``row_ptr[-1]`` spanned edges: the
    main path's forward (``form`` "gather": the graph's receiver rows),
    the gathered form's d x (``form`` "transpose": the transpose's sender
    rows, the receivers gathered, the weights read at the edge ids) and a
    sender gather's backward (``form`` "transpose_ids": per-edge values
    read at the edge ids). The bound counts the table rows that the edges
    name, once, the gather index, the weights and their index, the spans
    and ``out``. The library call: with [E] weights ``torch.sparse.mm`` on
    a CSR matrix (``_k1_csr_library``); a sender gather's backward is one
    ``index_add_`` of the values at the graph's senders; no single call
    gathers and reduces with [E, H] weights. ``index_add_ms``: one
    ``index_add_`` of the products gathered beforehand (the per-edge
    form's library call on this function's terms). ``cold``: also time K1
    with the L2 flushed before each call."""
    e = int(row_ptr[-1])
    c, elt = table.shape[1], table.element_size()
    heads = 1 if weight is None or weight.ndim == 1 else weight.shape[1]
    kw = dict(senders=senders, weight=weight, weight_at=weight_at,
              round_weight=round_weight, n_edges=e, long_rows=long_rows,
              long_edges=long_edges)
    w_e = weight if weight is None or weight_at is not None else weight[:e]
    w_at = None if weight_at is None else weight_at[:e]

    def plain():
        return k1.segment_sum_plain(k1.gathered_plain(
            table, senders[:e], w_e, w_at, round_weight), rows[:e], n)

    out = k1.segment_sum(table, rows, row_ptr, n, **kw)
    ref = plain()
    torch.cuda.synchronize()
    dtype = str(table.dtype).replace("torch.", "")
    terms = k1.gathered_plain(table, senders[:e], w_e, w_at, round_weight)
    abs_sum = k1.segment_sum_plain(terms.float().abs(), rows[:e], n)
    err, rtol, atol = _check(f"K1 {label} {form}", out, ref, dtype, abs_sum)
    named = int(senders[:e].unique().numel())
    n_bytes = (named * c * elt + e * 4 + (0 if weight is None
                                          else e * heads * 4)
               + (0 if weight_at is None else e * 4) + (n + 1) * 4
               + n * c * elt)
    b_ms, b_by = bound(n_bytes, e * c * (1 if weight is None else 2))
    library_ms, library_err = None, None
    if weight is not None and weight.ndim == 1:
        call, lib = _k1_csr_library(table, row_ptr, senders[:e],
                                    w_e if w_at is None else w_e[w_at.long()],
                                    n)
        library = "torch.sparse.mm (CSR)"
    elif weight is None and form == "transpose_ids":
        # Σ over a sender's edges of the values read at the edge ids: the
        # same sum, in edge order, at the edges' senders
        lib_out = torch.zeros(n, c, dtype=table.dtype, device=DEVICE)
        ids = senders[:e].long()
        by = rows[:e].long()[torch.argsort(ids)]
        vals_e = table[:e]

        def call():
            return lib_out.index_add_(0, by, vals_e)
        lib = call().clone()
        lib_out.zero_()
        library = "index_add_"
    else:
        call, lib = None, "none: a gather and a reduce"
    if call is None:
        library = lib
    else:
        library_err = float((lib.float() - ref.float()).abs().max())
        library_ms = time_ms(call)
    pre_out = torch.zeros(n, c, dtype=table.dtype, device=DEVICE)
    pre_rows = rows[:e]

    def kernel():
        return k1.segment_sum(table, rows, row_ptr, n, **kw)

    return dict(
        kernel="K1", form=form, shape=[int(table.shape[0]), c],
        heads=heads, edges_read=e, rows_named=named, dtype=dtype, n_out=n,
        graph=label, max_abs_err=err, rtol=rtol, atol=atol,
        layout=_k1_layout(table, c, heads, n, e),
        long_rows=0 if long_rows is None else int(long_rows.numel()),
        kernel_ms=time_ms(kernel),
        **({"kernel_cold_ms": _cold_ms(kernel)} if cold else {}),
        plain_ms=time_ms(plain), library_ms=library_ms, library=library,
        library_max_abs_err=library_err,
        index_add_ms=time_ms(lambda: pre_out.index_add_(0, pre_rows,
                                                        terms)),
        bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)


def _k1_gathered_cases(label, graph, table, weight, round_weight,
                       sender_gather=False, cold=False):
    """K1's gathered forms on ``graph`` (``_k1_gathered_case``): the
    forward and its d x over the transpose; with ``sender_gather`` also
    the backward of a sender gather of float32 [E_pad, heads] values (GAT's
    scores)."""
    t = graph.transpose
    ge = dict(long_edges=graph.long_edges, cold=cold)
    cases = [
        _k1_gathered_case(label, "gather", table, graph.receivers,
                          graph.row_ptr, graph.n_nodes, graph.senders,
                          weight, None, round_weight, graph.long_rows, **ge),
        _k1_gathered_case(label, "transpose", table, t.senders, t.row_ptr,
                          graph.n_nodes, t.receivers, weight, t.edge_ids,
                          round_weight, t.long_rows, **ge)]
    if sender_gather:
        heads = 1 if weight.ndim == 1 else weight.shape[1]
        edge_vals = torch.randn(
            graph.n_edge_pad, heads, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(4))
        cases.append(_k1_gathered_case(
            label, "transpose_ids", edge_vals, t.senders, t.row_ptr,
            graph.n_nodes, t.edge_ids, long_rows=t.long_rows, **ge))
    return cases


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
            longs = (dict(long_rows=g.long_rows, long_edges=g.long_edges)
                     if label == "cora" else {})
            cases.append(_k1_case(values.to(dtype), recv, row_ptr, n, label,
                                  **longs))
            emit({"phase": "kernels", **cases[-1]})
    # the gathered form as the main path runs it: GCN's first layer
    # (F=128, the graph's weights rounded to x's type) and GAT-COO's 8
    # heads x 8 (float32 [E, 8] weights), with their transposed forms
    heads_w = torch.rand(g.n_edge_pad, 8, device=DEVICE, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        for f, weight, rnd in ((128, g.edge_weight, True),
                               (64, heads_w, False)):
            table = torch.randn(g.n_nodes, f, device=DEVICE,
                                generator=gen).to(dtype)
            for case in _k1_gathered_cases(
                    "cora", g, table, weight, rnd,
                    sender_gather=f == 64 and dtype == torch.float32):
                cases.append(case)
                emit({"phase": "kernels", **case})
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


def _attend_case(label, hg, heads, feat, dtype, dropping, gen, plain_reps,
                 parts=True):
    """K4, K5 and K6 on random operands of one shape against their plain
    versions, then timed. The backward's operands follow the forward's
    (m zeroed where den == 0, as the autograd function does). Then, with
    ``parts``, K8-K10 on the same operands, with the three-pass attend's
    shift. ``x`` is in ``dtype``, the tiles as ``hg`` holds them."""
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
    if not parts:
        return cases
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


def phase_han_kernels(pap, pap_large) -> list[dict]:
    """K4, K5 and K6 at HAN's shapes: 4 heads x 8 on the PAP metapath
    graph of the CLI's 600-paper ACM (every edge in a tile: an empty
    remainder) and of the 3,025-paper ACM (the HAN paper's paper count; a
    remainder of ~12,000 edges beside its tiles), x in float32 and in
    bfloat16 over the loader's float32 tiles, without and with attention
    dropout (the HAN layer's rate; the ``han`` CLI trains without it)."""
    t0 = time.perf_counter()
    if pap.rem.n_edges != 0 or pap_large.rem.n_edges < 10_000:
        raise AssertionError(f"HAN PAP graphs: {pap.rem.n_edges} and "
                             f"{pap_large.rem.n_edges} remainder edges")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    cases = []
    for label, hg in (("acm_pap", pap), ("acm3025_pap", pap_large)):
        if hg.bcsr.tiles.dtype != torch.float32:
            raise AssertionError(f"{label}: tiles in {hg.bcsr.tiles.dtype}")
        for dtype in (torch.float32, torch.bfloat16):
            for dropping in (False, True):
                cases += _attend_case(label, hg, HAN_HEADS, HAN_HIDDEN,
                                      dtype, dropping, gen, (3, 5),
                                      parts=False)
    emit({"phase": "kernels", "han_graphs": {
        label: dict(nodes=g.n_nodes, tiles=g.bcsr.n_tiles,
                    tiled_edges=g.bcsr.n_edges,
                    remainder_edges=g.rem.n_edges)
        for label, g in (("acm_pap", pap), ("acm3025_pap", pap_large))},
        "han_seconds": time.perf_counter() - t0, "cases": len(cases)})
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
    """``data`` (one graph, or HAN's metapath graphs) on the CPU."""
    graphs = ({"graphs": [g.to("cpu") for g in data.graphs]}
              if hasattr(data, "graphs") else {"graph": data.graph.to("cpu")})
    return dataclasses.replace(
        data, **graphs, features=data.features.cpu(),
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
    emit({"phase": phase, "argv": argv, **res, "seconds": seconds,
          "launches": launches})
    return launches


#: HAN's widths in the CLI: 4 heads of 8 features, one layer
HAN_HEADS, HAN_HIDDEN = 4, 8
#: The HAN paper's ACM paper count (Wang et al., WWW 2019, Table 2)
HAN_PAPERS_LARGE = 3025
#: HAN card vs CPU, each against the largest entry of the logits, or of a
#: parameter's gradients its scale group's largest gradient entry
#: (``_scale_group``): (logits, gradients) by dtype, the tolerances of the
#: CPU tests (``tests/test_torch_han.py``).
HAN_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2)}
#: HAN's launches (per epoch, final test forward): an epoch is one train
#: step (forward and backward of the two metapath GAT layers), with no
#: validation pass; COO forward per metapath: K2 (shift) + K1
#: (denominator) + K1 (aggregation), backward 4 K1 (as GAT-COO's: the
#: aggregation's d h, the denominator's read-back, the scores' sender and
#: receiver gathers)
HAN_HYBRID = {"K4": (2, 2), "K5": (2, 0), "K6": (2, 0)}
HAN_COO = {"K1": (12, 4), "K2": (2, 2)}
#: phase: (argv, launches, (n_papers, layout, dtype) of the timed block;
#: None for ``han_batch``, which runs eager steps and no kernel)
HAN_RUNS = {
    "han": (["--model", "han"], HAN_HYBRID, (600, "auto", None)),
    "han_bf16": (["--model", "han", "--dtype", "bfloat16"], HAN_HYBRID,
                 (600, "auto", torch.bfloat16)),
    "han_3025": (["--model", "han", "--set",
                  f"n_papers={HAN_PAPERS_LARGE}"], HAN_HYBRID,
                 (HAN_PAPERS_LARGE, "auto", None)),
    "han_coo_3025": (["--model", "han", "--layout", "coo", "--set",
                      f"n_papers={HAN_PAPERS_LARGE}"], HAN_COO,
                     (HAN_PAPERS_LARGE, "coo", None)),
    "han_batch": (["--model", "han_batch"], {}, None),
}


def _scale_group(name: str) -> str:
    """The parameters whose gradients share a scale: a module's (a
    Linear's weight and bias together), and the semantic attention's
    projection with its ``q``: the projection bias's gradient is a sum
    over P x N rows that cancels to ~1e-2 of its weight's."""
    module = name.rpartition(".")[0]
    return module[:-len("proj")].rstrip(".") if module.endswith(
        "proj") else module


def _module_errs(got: dict, want: dict) -> dict:
    """Each gradient's max abs error over its scale group's largest
    entry."""
    scale = {}
    for k, g in want.items():
        group = _scale_group(k)
        scale[group] = max(scale.get(group, 0.0), float(g.abs().max()))
    return {k: float((got[k] - g).abs().max()) / scale[_scale_group(k)]
            for k, g in want.items()}


def _han_card_vs_cpu(data, dtype) -> dict:
    """HAN at the CLI's widths, one forward and the training loss's
    backward, dropout off (as the CLI trains): on the CPU (plain
    versions) and with the same weights on the card (kernels)."""
    def make():
        return HAN(int(data.features.shape[1]), len(data.graphs),
                   data.num_classes, hidden=HAN_HIDDEN,
                   num_heads=(HAN_HEADS,), dtype=dtype)

    ref, dev = make(), make()
    ref.reset_parameters(torch.Generator().manual_seed(1))
    dev.load_state_dict(ref.state_dict())
    dev.to(DEVICE)
    outs = []
    for model, d in ((ref, _on_cpu(data)), (dev, data)):
        model.eval()
        logits = model(d.graphs, d.features)
        masked_softmax_cross_entropy(logits[d.train_idx],
                                     d.labels[d.train_idx]).backward()
        outs.append((logits.detach().cpu(), {
            k: p.grad.cpu() for k, p in model.named_parameters()}))
    (lr, gr), (ld, gd) = outs
    if not torch.isfinite(ld).all() or ld.shape != lr.shape:
        raise AssertionError("HAN: bad logits on the card")
    err = float((ld - lr).abs().max()) / float(lr.abs().max())
    gerr = _module_errs(gd, gr)
    tol = HAN_TOL["float32" if dtype is None else "bfloat16"]
    if err > tol[0] or max(gerr.values()) > tol[1]:
        raise AssertionError(f"HAN card vs CPU: logits {err}, gradients "
                             f"{gerr} (tolerance {tol})")
    return dict(logits_rel_err=err, grad_rel_err=gerr, tolerance=tol)


def _han_chunk(n_papers, layout, dtype) -> dict:
    """The ``han`` CLI's chunk of 20 epochs on fresh states from one seed:
    captured (``HANBlock``) against eager epochs on the card
    (``run_han_epochs``), each epoch's loss within ``TOL[dtype]``, and in
    float32 its first ``CPU_EPOCHS`` against the CPU's eager epochs within
    ``PATH_TOL``. Then the times: wall ms per epoch of the first chunk
    (warm-up, capture, replays), of a captured chunk (20 replays and one
    host read) and of 20 eager epochs; device ms per epoch (one replay,
    with the reset of the chunk's loss index, back to back behind a sleep
    kernel: ``time_ms``)."""
    data = load_acm_han(seed=0, layout=layout, n_papers=n_papers,
                        device=DEVICE)
    opt = make_optimizer("adamw", 5e-3)

    def state(d):
        return create_train_state(
            HAN(int(d.features.shape[1]), len(d.graphs), d.num_classes,
                hidden=HAN_HIDDEN, num_heads=(HAN_HEADS,), dtype=dtype),
            d, 0, opt)

    block, eager = HANBlock(state(data), data, 20), state(data)
    rows, first_ms = _timed(block.run)
    ref = run_han_epochs(eager, data, 20)
    dname = "float32" if dtype is None else "bfloat16"
    if rows.shape != (20, 1) or not np.isfinite(rows).all():
        raise AssertionError(f"HAN captured losses {rows}")
    err = _rows_err(rows, ref, TOL[dname])
    if err > 1.0:
        raise AssertionError(f"HAN captured vs eager losses: {rows[:, 0]} "
                             f"against {ref[:, 0]}")
    out = {"captured_vs_eager_err_of_tol": err}
    if dtype is None:
        cpu_data = _on_cpu(data)
        cpu_rows = run_han_epochs(state(cpu_data), cpu_data, CPU_EPOCHS)
        cpu_err = float(np.abs(rows[:CPU_EPOCHS] - cpu_rows).max())
        if cpu_err > PATH_TOL:
            raise AssertionError(f"HAN captured vs CPU losses: "
                                 f"{rows[:CPU_EPOCHS, 0]} against "
                                 f"{cpu_rows[:, 0]}")
        out.update(cpu_epochs=CPU_EPOCHS, captured_vs_cpu_abs_err=cpu_err)
    _, wall_ms = _timed(block.run)

    def replay():
        block.index.zero_()
        block.graph.replay()

    device_ms = time_ms(replay, reps=5, batch=20)
    _, eager_ms = _timed(lambda: run_han_epochs(eager, data, 20))
    out.update(first_chunk_ms_per_epoch=first_ms,
               captured_wall_ms_per_epoch=wall_ms,
               device_ms_per_epoch=device_ms,
               eager_wall_ms_per_epoch=eager_ms,
               wall_over_device=wall_ms / device_ms)
    return out


def phase_han() -> list[dict]:
    """HAN through the CLI (``HAN_RUNS``, each at its default 100 epochs):
    test_acc >= 0.80, a finite loss and exact launch counts; then each
    full-batch configuration's chunk checked and timed (``_han_chunk``);
    then
    HAN card vs CPU on the CLI's 600-paper hybrid (float32 and bfloat16),
    the 3,025-paper hybrid and its COO graphs."""
    t0 = time.perf_counter()
    runs = []
    for phase, (argv, expect, timed) in HAN_RUNS.items():
        runs.append(_drive(phase, argv + ["--device", DEVICE,
                                              "--quiet"], expect))
        if timed is not None:
            emit({"phase": phase, "chunk": _han_chunk(*timed)})
    checks = {}
    for name, (n_papers, layout, dtype) in {
            "acm_auto": (600, "auto", None),
            "acm_auto_bf16": (600, "auto", torch.bfloat16),
            "acm3025_auto": (HAN_PAPERS_LARGE, "auto", None),
            "acm3025_coo": (HAN_PAPERS_LARGE, "coo", None)}.items():
        data = load_acm_han(seed=0, layout=layout, n_papers=n_papers,
                            device=DEVICE)
        checks[name] = _han_card_vs_cpu(data, dtype)
    emit({"phase": "han", "card_vs_cpu": checks,
          "seconds": time.perf_counter() - t0})
    return runs


#: GTN in the CLI: 2 channels, 2 layers, hidden 64 (the reference's
#: defaults), 10-epoch chunks
GTN_DIMS = dict(channels=2, num_layers=2, hidden=64)
GTN_CHUNK = 10
#: GTN card vs CPU, (logits, gradients) by dtype as ``HAN_TOL`` measures
#: them: the CPU tests' tolerances (``tests/test_torch_gtn.py``)
GTN_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2)}
#: The sparse model's logits against the dense model's, |sparse - dense|
#: <= t + t |dense|: JAX's own test's tolerance (``tests/test_models.py``)
GTN_DENSE_SPARSE = 2e-4
#: GTN's launches (per epoch, final test forward). The sparse forward
#: runs K1 five times (step 0's composition, step 1's degree sum, step
#: 1's composition, the final degree sum, the final ``spmm_weighted``),
#: its backward five times (each composition's transpose, over the wedges
#: sorted by input slot; the two degree read-backs' sums by row; the
#: convolution's d x over the final graph's transpose; the degree sums'
#: backward are gathers). The dense model runs matrix products and no
#: kernel of the port.
GTN_SPARSE = {"K1": (10, 5)}
GTN_RUNS = {
    "gtn": (["--model", "gtn"], {}),
    "gtn_bf16": (["--model", "gtn", "--dtype", "bfloat16"], {}),
    "gtn_sparse": (["--model", "gtn", "--layout", "sparse"], GTN_SPARSE),
    "gtn_sparse_bf16": (["--model", "gtn", "--layout", "sparse", "--dtype",
                         "bfloat16"], GTN_SPARSE),
}


def gtn_data(n_papers: int):
    """GTN's input on the card: the CLI's 920-node ACM stack (600
    papers), or the synthetic ACM that ``load_acm_han`` makes at
    ``n_papers``, stacked by the GTN loader's own code."""
    if n_papers == 600:
        return load_acm_gtn(seed=0, device=DEVICE)
    hg, feats, labels = synthetic_acm(
        seed=0, n_papers=n_papers, n_authors=n_papers // 2,
        n_subjects=max(20, n_papers // 30))
    return acm_data._assemble_gtn_data(hg, feats, labels, 0, 200, 100,
                                       torch.device(DEVICE))


def gtn_plan(data):
    """``data``'s wedge plan, as the CLI builds it, on ``data``'s device."""
    return build_gtn_plan(stacked_adj_to_sparse(data.adj),
                          int(data.adj.shape[1]), device=data.device)


def _gtn_model(data, sparse: bool, dtype):
    return (SparseGTN if sparse else GTN)(
        int(data.features.shape[1]), int(data.adj.shape[0]),
        data.num_classes, **GTN_DIMS, dtype=dtype)


def phase_gtn_kernels(plan, plan_large) -> list[dict]:
    """K1 at GTN's sparse shapes: the final convolution's [E_pad, C x
    hidden] on the 920-node plan (float32, bfloat16) and on the 4,637-node
    plan (float32), per edge and in the gathered form the model runs (x
    [N, C x hidden], weights [E_pad, C], and its d x over the final
    graph's transpose); the 920-node plan's second composition, per edge
    [W_pad, C] over its (output slot, edge type) rows, and as the model
    runs it: the gathered form of h [nnz_1, C] with the wedge weights over
    the forward order, and its d h over the backward order (the same
    wedges by input slot). The 920-node final convolution's and the
    compositions' cases are also timed with the L2 flushed before each
    call."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    width = GTN_DIMS["channels"] * GTN_DIMS["hidden"]
    cases = []
    for label, g, f, dtype in [
            ("gtn_final", plan.final_graph, width, torch.float32),
            ("gtn_final", plan.final_graph, width, torch.bfloat16),
            ("gtn3025_final", plan_large.final_graph, width, torch.float32),
            ("gtn_compose1", plan.step_fwd[1].graph, GTN_DIMS["channels"],
             torch.float32)]:
        values = torch.randn(g.n_edge_pad, f, device=DEVICE, generator=gen)
        cases.append(_k1_case(values.to(dtype), g.receivers, g.row_ptr,
                              g.n_nodes, label, g.long_rows, g.long_edges,
                              cold=label != "gtn3025_final"))
        emit({"phase": "kernels", **cases[-1]})
    for label, g, dtype in [
            ("gtn_final", plan.final_graph, torch.float32),
            ("gtn_final", plan.final_graph, torch.bfloat16),
            ("gtn3025_final", plan_large.final_graph, torch.float32)]:
        table = torch.randn(g.n_nodes, width, device=DEVICE,
                            generator=gen).to(dtype)
        weight = torch.rand(g.n_edge_pad, GTN_DIMS["channels"],
                            device=DEVICE, generator=gen)
        for case in _k1_gathered_cases(label, g, table, weight, False,
                                       cold=label == "gtn_final"):
            cases.append(case)
            emit({"phase": "kernels", **case})
    # the composition as SparseGTN._compose runs it (WedgeOrder.sum: one
    # block at these sizes), forward and backward
    for form, order, n_in in (("gather", plan.step_fwd[1], plan.nnz[1]),
                              ("transpose", plan.step_bwd[1],
                               plan.step_fwd[1].graph.n_nodes)):
        g = order.graph
        table = torch.randn(n_in, GTN_DIMS["channels"], device=DEVICE,
                            generator=gen)
        cases.append(_k1_gathered_case(
            "gtn_compose1", form, table, g.receivers, g.row_ptr, g.n_nodes,
            g.senders, g.edge_weight, long_rows=g.long_rows,
            long_edges=g.long_edges, cold=True))
        emit({"phase": "kernels", **cases[-1]})
    return cases


def _gtn_on_cpu(data):
    return dataclasses.replace(
        data, **{f.name: getattr(data, f.name).cpu()
                 for f in dataclasses.fields(data)
                 if isinstance(getattr(data, f.name), torch.Tensor)},
        device=torch.device("cpu"))


def _gtn_card_vs_cpu(data, plan, sparse, dtype) -> dict:
    """GTN at the CLI's widths, one forward and the training loss's
    backward: on the CPU (plain versions) and with the same weights on the
    card."""
    ref, dev = _gtn_model(data, sparse, dtype), _gtn_model(data, sparse,
                                                          dtype)
    ref.reset_parameters(torch.Generator().manual_seed(1))
    dev.load_state_dict(ref.state_dict())
    dev.to(DEVICE)
    cpu = _gtn_on_cpu(data)
    cpu_graph = gtn_plan(cpu) if sparse else cpu.adj
    outs = []
    for model, d, g in ((ref, cpu, cpu_graph),
                        (dev, data, plan if sparse else data.adj)):
        logits = model(g, d.features)
        masked_softmax_cross_entropy(logits[d.target_idx[d.train_idx]],
                                     d.labels[d.train_idx]).backward()
        outs.append((logits.detach().cpu(), {
            k: p.grad.cpu() for k, p in model.named_parameters()}))
    (lr, gr), (ld, gd) = outs
    if not torch.isfinite(ld).all() or ld.shape != lr.shape:
        raise AssertionError("GTN: bad logits on the card")
    err = float((ld - lr).abs().max()) / float(lr.abs().max())
    gerr = _module_errs(gd, gr)
    tol = GTN_TOL["float32" if dtype is None else "bfloat16"]
    if err > tol[0] or max(gerr.values()) > tol[1]:
        raise AssertionError(f"GTN card vs CPU: logits {err}, gradients "
                             f"{gerr} (tolerance {tol})")
    return dict(logits_rel_err=err, grad_rel_err=gerr, tolerance=tol)


def _gtn_chunk(data, graph, sparse, dtype) -> dict:
    """A 10-epoch ``GTNBlock`` chunk against ``run_gtn_epochs`` from a
    twin state: losses and parameters bit-equal. Then the times: wall ms
    per epoch of the first chunk (warm-up, capture, replays), of a
    captured chunk and of 10 eager epochs; device ms per epoch (a replay,
    with the chunk's index reset, back to back behind a sleep kernel:
    ``time_ms``)."""
    def state():
        return create_gtn_state(_gtn_model(data, sparse, dtype), data, 0)

    block, eager = GTNBlock(state(), data, graph, GTN_CHUNK), state()
    rows, first_ms = _timed(block.run)
    ref = run_gtn_epochs(eager, data, graph, GTN_CHUNK)
    if rows.shape != (GTN_CHUNK, 1) or not np.isfinite(rows).all():
        raise AssertionError(f"GTN captured losses {rows}")
    same = [k for (k, a), b in zip(
        block.state.model.state_dict().items(),
        eager.model.state_dict().values()) if not torch.equal(a, b)]
    if not np.array_equal(rows, ref) or same:
        raise AssertionError(f"GTN captured vs eager: losses {rows[:, 0]} "
                             f"against {ref[:, 0]}, parameters that "
                             f"differ {same}")
    _, wall_ms = _timed(block.run)

    def replay():
        block.index.zero_()
        block.graph.replay()

    device_ms = time_ms(replay, reps=3, batch=5)
    _, eager_ms = _timed(lambda: run_gtn_epochs(eager, data, graph,
                                                GTN_CHUNK))
    return dict(captured_bit_equal_to_eager=True,
                first_chunk_ms_per_epoch=first_ms,
                captured_wall_ms_per_epoch=wall_ms,
                device_ms_per_epoch=device_ms,
                eager_wall_ms_per_epoch=eager_ms,
                wall_over_device=wall_ms / device_ms,
                top_kernels_ms_per_epoch=_top_kernels(replay, 3))


def _top_kernels(fn, calls: int, top: int = 6) -> dict:
    """The kernels that take the most device time over ``calls`` calls of
    ``fn`` under ``torch.profiler``, ms per call (as ``profile_torch.py``
    sums them)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.time_range.elapsed_us()
    return {name[:80]: us / 1e3 / calls
            for name, us in by_name.most_common(top)}


def phase_gtn(data, data_large, plan, plan_large) -> list[dict]:
    """GTN through the CLI (``GTN_RUNS``, 40 epochs each): test_acc >=
    0.80 and exact launch counts; card vs CPU at 920 nodes; the captured
    chunks (``_gtn_chunk``) at 920 and 4,637 nodes; the sparse model
    against the dense one at 4,637 nodes."""
    t0 = time.perf_counter()
    runs = [_drive(phase, argv + ["--device", DEVICE, "--quiet"], expect)
            for phase, (argv, expect) in GTN_RUNS.items()]
    checks = {f"{'sparse' if sparse else 'dense'}_{name}":
              _gtn_card_vs_cpu(data, plan, sparse, dtype)
              for sparse in (False, True)
              for name, dtype in (("float32", None),
                                  ("bfloat16", torch.bfloat16))}
    n, n_large = plan.n_nodes, plan_large.n_nodes
    chunks = {
        f"dense_{n}": _gtn_chunk(data, data.adj, False, None),
        f"dense_bf16_{n}": _gtn_chunk(data, data.adj, False, torch.bfloat16),
        f"sparse_{n}": _gtn_chunk(data, plan, True, None),
        f"dense_{n_large}": _gtn_chunk(data_large, data_large.adj, False,
                                       None),
        f"sparse_{n_large}": _gtn_chunk(data_large, plan_large, True, None),
    }
    dense, sparse = (_gtn_model(data_large, False, None),
                     _gtn_model(data_large, True, None))
    dense.reset_parameters(torch.Generator().manual_seed(1))
    sparse.load_state_dict(dense.state_dict())
    with torch.no_grad():
        ld = dense.to(DEVICE)(data_large.adj, data_large.features)
        ls = sparse.to(DEVICE)(plan_large, data_large.features)
    gap = float(((ls - ld).abs() / (GTN_DENSE_SPARSE
                                    * (1 + ld.abs()))).max())
    if not torch.isfinite(ls).all() or gap > 1.0:
        raise AssertionError(f"GTN sparse vs dense at {n_large} nodes: "
                             f"{gap} of the tolerance")
    emit({"phase": "gtn", "card_vs_cpu": checks, "chunks": chunks,
          "sparse_vs_dense_large_of_tol": gap, "nodes": [n, n_large],
          "nnz": [plan.nnz, plan_large.nnz],
          "wedges": [plan.wedge_counts, plan_large.wedge_counts],
          "seconds": time.perf_counter() - t0})
    return runs


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


#: The walk embedders' CLI runs: the reference's defaults on the 500-node
#: synthetic small world (MetaPath2Vec: the 350-node user-item graph),
#: walks drawn on the device where JAX can draw them
EMBED_RUNS = {
    "deepwalk": ["--model", "deepwalk"],
    "deepwalk_device_walks": ["--model", "deepwalk", "--set",
                              "device_walks=true"],
    "node2vec": ["--model", "node2vec"],
    "node2vec_device_walks": ["--model", "node2vec", "--set",
                              "device_walks=true"],
    "struc2vec": ["--model", "struc2vec"],
    "line": ["--model", "line"],
    "sdne": ["--model", "sdne"],
    "metapath2vec": ["--model", "metapath2vec"],
    "metapath2vec_device_walks": ["--model", "metapath2vec", "--set",
                                  "device_walks=true"],
}
#: The Wiki edge list's node count, the graph of the reference's LINE and
#: SDNE runs (BASELINE.md:28-29), as a synthetic small world of degree 14
#: each way: 33,670 directed edges
WIKI_NODES, WIKI_K = 2405, 14
#: Steps in a window of eager steps or replays timed (``_step_times``),
#: and in a profiled window
EMBED_WINDOW, EMBED_PROFILED = 100, 20
#: One training step card vs CPU from the same weights and batch: the loss,
#: every parameter's gradient and every parameter after the step within
#: this share of its largest entry (float32 sums in other orders; the
#: gradients hold the backward to its size, as Adam's first step is
#: ~lr·sign(g))
EMBED_TOL = 1e-5


class _EmbedTimes:
    """Host seconds of an embedder run by part (the walks and their
    tables, the Struc2Vec layers, the corpus) and each device-loop epoch's
    wall seconds and steps, from wrappers around
    ``models/embedding.py``'s builders and ``CapturedEpochs.run`` (whose
    host read ends the epoch); it keeps the last loop and the last corpus
    handed to ``train_skipgram``."""

    PARTS = {"walks": ("uniform_walks", "metapath_walks", "_device_walks",
                       "build_node2vec_tables", "build_metapath_tables",
                       "build_device_neighbor_table"),
             "layers": ("build_multilayer_graph",),
             "corpus": ("skipgram_dataset", "line_corpus", "pagerank")}
    METHODS = ((embedding.Node2VecWalker, "__init__"),
               (embedding.Node2VecWalker, "walk"),
               (embedding.Struc2VecWalker, "__init__"),
               (embedding.Struc2VecWalker, "walk"))

    def __init__(self):
        self.host = {part: 0.0 for part in self.PARTS}
        self.epochs, self.steps = [], 0
        self.loop, self.arrays = None, None
        self.saved = []

    def _timer(self, part, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            self.host[part] += time.perf_counter() - t
            return out
        return timed

    def __enter__(self):
        patches = [(embedding, name, self._timer(part,
                                                 getattr(embedding, name)))
                   for part, names in self.PARTS.items() for name in names]
        patches += [(cls, name, self._timer("walks", getattr(cls, name)))
                    for cls, name in self.METHODS]
        run, train = embed_loop.CapturedEpochs.run, embedding.train_skipgram

        def timed_run(loop):
            t = time.perf_counter()
            rows = run(loop)
            self.epochs.append(time.perf_counter() - t)
            self.steps += loop.nb
            self.loop = loop
            return rows

        def keep_corpus(model, arrays, **kw):
            self.arrays = tuple(arrays) + tuple(
                kw.get("extra_batch_arrays", ()))
            return train(model, arrays, **kw)

        patches += [(embed_loop.CapturedEpochs, "run", timed_run),
                    (embedding, "train_skipgram", keep_corpus)]
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in patches]
        for obj, name, value in patches:
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)

    def report(self) -> dict:
        train_s = sum(self.epochs)
        n = len(self.epochs)
        per = self.steps / max(n, 1)
        return {"host_s": dict(self.host), "epochs": n,
                "steps_per_epoch": per, "train_s": train_s,
                "first_epoch_ms": self.epochs[0] * 1e3 if n else None,
                "steps_per_s": self.steps / train_s if n else None,
                "epochs_per_s": n / train_s if n else None,
                "steady_steps_per_s": ((n - 1) * per / sum(self.epochs[1:])
                                       if n > 1 else None)}


def _step_times(loop) -> dict:
    """ms per step of a trained device loop:
    a captured epoch's wall time (host clock, ending in its host read),
    ``EMBED_WINDOW`` eager steps' wall time, as many replays back to back
    behind a sleep kernel (``time_ms``), the kernel time per step of
    ``EMBED_PROFILED`` replayed and eager steps (profiler) and a replayed
    step's costliest kernels."""
    nb = loop.nb
    window, profiled = min(nb, EMBED_WINDOW), min(nb, EMBED_PROFILED)

    def replays(n):
        def run():
            loop.index.zero_()
            for _ in range(n):
                loop.graph.replay()
        return run

    def eager(n):
        def run():
            loop.index.zero_()
            loop.steps(n)
        return run

    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop.run()
    out["captured_wall_ms"] = (time.perf_counter() - t) * 1e3 / nb
    t = time.perf_counter()
    eager(window)()
    torch.cuda.synchronize()
    out["eager_wall_ms"] = (time.perf_counter() - t) * 1e3 / window
    out["captured_device_ms"] = time_ms(replays(window), reps=3,
                                        batch=1) / window
    total, top = kernel_ms(replays(profiled), top=4)
    out["captured_kernel_ms"] = total / profiled
    out["eager_kernel_ms"] = kernel_ms(eager(profiled)) / profiled
    out["captured_wall_over_device"] = (out["captured_wall_ms"]
                                        / out["captured_device_ms"])
    out["top_kernels_ms"] = {k: v / profiled for k, v in top.items()}
    return out


def _embed_run(name, run, steps=True) -> tuple[dict, _EmbedTimes]:
    """``run()`` (a CLI run or a ``run_*`` call) under ``_EmbedTimes`` with
    the launch counts set to 0 just before and read just after: no kernel
    of the port may launch, the loss must fall (REPRO.md:14-19) and the
    embedding be [V, 128]; then, with ``steps``, the step times of its
    device loop."""
    reset_launches()
    with _EmbedTimes() as times:
        t = time.perf_counter()
        loss0, loss1, shape = run()
        seconds = time.perf_counter() - t
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"embed {name}: kernels launched {launches}")
    if not (np.isfinite([loss0, loss1]).all() and loss1 < loss0
            and shape[1] == 128):
        raise AssertionError(f"embed {name}: loss {loss0} -> {loss1}, "
                             f"embedding {shape}")
    res = {"run": name, "initial_loss": loss0, "final_loss": loss1,
           "embed_shape": list(shape), "seconds": seconds, "launches": 0,
           **times.report()}
    if steps:
        res["step_ms"] = _step_times(times.loop)
    emit({"phase": "embed", **res})
    return res, times


def _cli_embed(argv):
    res = cli_main(argv + ["--device", DEVICE, "--quiet"])
    return res["initial_loss"], res["final_loss"], res["embed_shape"]


def _api_embed(fn, data, cfg):
    emb, history = fn(data, cfg, device=DEVICE)
    return history[0][1], history[-1][1], emb.shape


def _state_errs(got: torch.nn.Module, want: torch.nn.Module) -> dict:
    """Each parameter's gradient (of the step just taken: the next step
    clears it) and value, ``got`` against ``want``."""
    grads = dict(want.named_parameters())
    return {**{f"grad_{k}": _rel_err(p.grad, grads[k].grad)
               for k, p in got.named_parameters()},
            **{k: _rel_err(a, want.state_dict()[k])
               for k, a in got.state_dict().items()}}


def _embed_card_vs_cpu(deepwalk_corpus, line_corpus) -> dict:
    """One training step of SkipGram (a batch of DeepWalk's corpus: 256 x
    60), LINE (32 rows of its corpus and PageRank weights) and SDNE (32
    adjacency rows of the 500-node graph, hidden 256, 128) on the card
    and on the CPU from the same weights: the loss, every parameter's
    gradient and every parameter after the step within ``EMBED_TOL`` of
    their scale."""
    out = {}
    cases = {"skipgram": (lambda: SkipGram(500, 128), deepwalk_corpus, 256,
                          embed_loop.skipgram_loss),
             "line": (lambda: LINE(500, 128), line_corpus, 32,
                      embed_loop.line_loss)}
    for name, (make, arrays, bs, loss_fn) in cases.items():
        losses, models = [], []
        ref = make()
        ref.reset_parameters(torch.Generator().manual_seed(1))
        for device in ("cpu", DEVICE):
            model = make()
            model.load_state_dict(ref.state_dict())
            model.to(device)
            device = torch.device(device)
            opt = embed_loop.make_adam(model.parameters(), 2e-3, device)
            dev = [embed_loop._to_device(a[:bs], device) for a in arrays]
            step = embed_loop.batch_step(model, opt, loss_fn, dev)
            losses.append(step(torch.arange(bs, device=device))[0])
            models.append(model)
        out[name] = {"loss": _rel_err(losses[1], losses[0]),
                     **_state_errs(models[1], models[0])}
    cfg = embedding.SDNEConfig()
    data = load_edgelist(seed=0)
    a = torch.zeros(500, 500)
    a[torch.from_numpy(data.senders).long(),
      torch.from_numpy(data.receivers).long()] = torch.from_numpy(
          data.weights)
    losses, models = [], []
    for device in ("cpu", DEVICE):
        device = torch.device(device)
        model, opt = embedding.sdne_model(500, cfg, device)
        sel = torch.arange(32, device=device)
        rows = a.to(device)[sel]
        losses.append(embedding.sdne_step(model, opt, cfg, rows,
                                          rows[:, sel]))
        models.append(model)
    out["sdne"] = {"loss": _rel_err(losses[1], losses[0]),
                   **_state_errs(models[1], models[0])}
    worst = max(max(v.values()) for v in out.values())
    if not worst <= EMBED_TOL:
        raise AssertionError(f"embed card vs CPU: {out}")
    return out


def _twin_epochs(make, label: str) -> dict:
    """Two loops from ``make()`` (same weights, same generator seed): two
    epochs replayed from the capture against the same two epochs stepped
    eagerly; the rows and every parameter must be bit-equal."""
    (cap, cap_model), (eager, eager_model) = make(), make()
    got = [cap.run(), cap.run()]
    want = [eager.run_eager(), eager.run_eager()]
    rows_equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    differ = [k for k, v in cap_model.state_dict().items()
              if not torch.equal(v, eager_model.state_dict()[k])]
    if not rows_equal or differ:
        raise AssertionError(f"embed {label}: captured vs eager rows equal "
                             f"{rows_equal}, parameters that differ {differ}")
    return {"bit_equal": True, "steps_per_epoch": cap.nb,
            "losses": [float(r[:, 0].mean()) for r in got]}


def _skipgram_loop(arrays):
    def make():
        model = SkipGram(500, 128)
        embed_loop._init_params(model, 0)
        model.to(DEVICE)
        device = torch.device(DEVICE)
        opt = embed_loop.make_adam(model.parameters(), 2e-3, device)
        return (embed_loop.skipgram_epochs(
            model, opt, embed_loop.skipgram_loss, arrays, 256, 0,
            device), model)
    return make


def _sdne_loop():
    data = load_edgelist(seed=0)
    a = np.zeros((500, 500), np.float32)
    a[data.senders, data.receivers] = data.weights
    a = torch.from_numpy(a).to(DEVICE)
    cfg = embedding.SDNEConfig()

    def make():
        model, opt = embedding.sdne_model(500, cfg, torch.device(DEVICE))
        return embedding.sdne_epochs(model, opt, cfg, a), model
    return make


def phase_embed() -> list[dict]:
    """The walk embedders (no kernel of the port, as in JAX): the nine CLI
    runs of ``EMBED_RUNS`` (``_embed_run``: zero launches, the loss falls,
    [V, 128]; host seconds by part, steps/s and epochs/s, step ms
    captured and eager); one step of SkipGram, LINE and SDNE card vs CPU
    (``EMBED_TOL``); DeepWalk's and SDNE's captured epochs bit-equal to
    eager ones; DeepWalk, LINE and SDNE at
    the Wiki edge list's 2,405 nodes through the ``run_*`` API. Every
    kernel counter reads 0 across the phase."""
    t0 = time.perf_counter()
    reset_launches()
    runs, corpora = {}, {}
    for name, argv in EMBED_RUNS.items():
        # a device_walks run trains the same steps as its host-walk twin
        runs[name], times = _embed_run(name, lambda a=argv: _cli_embed(a),
                                       steps="device_walks" not in name)
        corpora[name] = times.arrays
    checks = {"card_vs_cpu": _embed_card_vs_cpu(corpora["deepwalk"],
                                                corpora["line"]),
              "deepwalk_captured_vs_eager": _twin_epochs(
                  _skipgram_loop(corpora["deepwalk"]), "deepwalk"),
              "sdne_captured_vs_eager": _twin_epochs(_sdne_loop(), "sdne")}
    emit({"phase": "embed", "tolerance": EMBED_TOL, **checks})
    wiki = synthetic_smallworld(n_nodes=WIKI_NODES, k=WIKI_K, seed=0)
    for name, fn, cfg in (
            ("deepwalk_2405", embedding.run_deepwalk,
             embedding.WalkEmbedConfig()),
            ("line_2405", embedding.run_line, embedding.LINEConfig()),
            ("sdne_2405", embedding.run_sdne, embedding.SDNEConfig())):
        runs[name], _ = _embed_run(name, lambda f=fn, c=cfg: _api_embed(
            f, wiki, c))
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"embed: kernels launched {launches}")
    emit({"phase": "embed", "edges_2405": len(wiki.senders),
          "launches": launches, "seconds": time.perf_counter() - t0})
    return runs


#: GATNE's and BiNE's REPRO criterion on the held-out edges (REPRO.md:20-21)
LINKPRED_F1, LINKPRED_AUC = 0.60, 0.75
#: GATNE through the CLI: the defaults (the REPRO run), the masked-BCE loss,
#: the sum aggregator and GATNE-I; the first two also timed by step
GATNE_RUNS = {
    "gatne": (["--model", "gatne"], True),
    "gatne_masked_bce": (["--model", "gatne", "--set", "loss=masked_bce"],
                         True),
    "gatne_sum": (["--model", "gatne", "--set", "aggregator=sum"], False),
    "gatne_inductive": (["--model", "gatne", "--set", "inductive=true"],
                        False),
}
#: basis on the card against the port's CPU run: every float within this
BASIS_TOL = 1e-5


class _Parts:
    """Host seconds of the parts of a run, by wrappers around module
    functions (``(module, name, part)``), each call's kept by part; a
    wrapped method of ``HostDrawnEpochs.run`` records each epoch's wall
    seconds (its host read ends it) and keeps the last loop."""

    def __init__(self, patches):
        self.patches = patches
        self.host = {part: 0.0 for _, _, part in patches}
        self.each = collections.defaultdict(list)
        self.epochs, self.loop, self.saved = [], None, []

    def _timer(self, part, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            self.each[part].append(time.perf_counter() - t)
            self.host[part] += self.each[part][-1]
            return out
        return timed

    def __enter__(self):
        run = embed_loop.HostDrawnEpochs.run

        def timed_run(loop, arrays):
            t = time.perf_counter()
            rows = run(loop, arrays)
            self.epochs.append(time.perf_counter() - t)
            self.loop = loop
            return rows

        patches = [(obj, name, self._timer(part, getattr(obj, name)))
                   for obj, name, part in self.patches]
        patches.append((embed_loop.HostDrawnEpochs, "run", timed_run))
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in patches]
        for obj, name, value in patches:
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def _gatne_parts() -> _Parts:
    return _Parts([(gatne, "build_neighbor_tables", "neighbors"),
                   (gatne, "_generate_walks", "walks"),
                   (gatne, "generate_pairs", "pairs"),
                   (gatne, "generate_padded_pairs", "pairs"),
                   (gatne._Batches, "epoch", "draws"),
                   (gatne, "evaluate_gatne", "eval")])


def _linkpred_ok(name, res) -> None:
    m = res["test_metrics"]
    if not (np.isfinite(list(m.values())).all()
            and res["final_loss"] < res["initial_loss"]):
        raise AssertionError(f"linkpred {name}: loss {res['initial_loss']} "
                             f"-> {res['final_loss']}, metrics {m}")


def _gatne_run(name, argv, steps) -> dict:
    """One GATNE CLI run with the launch counts set to 0 just before and
    read just after (no kernel may launch), the loss falling and finite
    metrics; host seconds by part, each epoch's wall time, the evaluation's
    ms an epoch, and with ``steps`` the device loop's ms per step."""
    reset_launches()
    with _gatne_parts() as parts:
        t = time.perf_counter()
        res = cli_main(argv + ["--device", DEVICE, "--quiet"])
        seconds = time.perf_counter() - t
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"linkpred {name}: kernels launched {launches}")
    _linkpred_ok(name, res)
    loop = parts.loop.loop
    host = dict(parts.host)
    host["pairs"] -= host["walks"]      # the pair functions draw the walks
    n = len(parts.epochs)
    # an epoch: the host's draws, the device loop (one copy, the replays,
    # the loss read) and the validation evaluation
    whole = [sum(t) for t in zip(parts.each["draws"], parts.epochs,
                                 parts.each["eval"])]
    out = {"run": name, "seconds": seconds, "launches": 0,
           "initial_loss": res["initial_loss"],
           "final_loss": res["final_loss"],
           "test_metrics": res["test_metrics"], "host_s": host,
           "draws_ms_per_epoch": host["draws"] * 1e3 / n,
           "eval_ms_per_epoch": np.mean(parts.each["eval"]) * 1e3,
           "epochs": n, "steps_per_epoch": loop.nb,
           "first_epoch_ms": whole[0] * 1e3,
           "first_loop_ms": parts.epochs[0] * 1e3,
           "steady_loop_steps_per_s": ((n - 1) * loop.nb
                                       / sum(parts.epochs[1:])),
           "steady_steps_per_s": (n - 1) * loop.nb / sum(whole[1:]),
           "steady_epochs_per_s": (n - 1) / sum(whole[1:])}
    if steps:
        out["step_ms"] = _step_times(loop)
    emit({"phase": "linkpred", **out})
    return out


def _gatne_pair(cfg, device, init_state, batch):
    """GATNE's parameters from ``init_state`` on ``device``, its optimizer
    and one step on ``batch``; returns (params, loss)."""
    device = torch.device(device)
    data = load_multiplex(seed=0)
    params, opt = gatne.gatne_model(data, cfg, device)
    params.load_state_dict(init_state)
    nb_tab = torch.from_numpy(gatne.build_neighbor_tables(
        data, cfg.neighbor_samples, np.random.default_rng(0))).to(device)
    fn = gatne.masked_bce if cfg.loss == "masked_bce" else gatne.nsloss
    step = gatne.make_step(params, opt, fn, nb_tab)
    loss = step(*(embed_loop._to_device(a, device) for a in batch))
    return params, loss


#: Adam's ``eps`` (optax's default, ``embed_loop.make_adam``)
ADAM_EPS = 1e-8


def _first_step_bound(g_a, g_b, lr) -> torch.Tensor:
    """Per entry, how far two first Adam steps from one value can land
    apart given their gradients ``g_a`` and ``g_b``: the step is ``lr · g
    / (|g| + eps)``, so ``lr · |g_a - g_b|`` times its steepest slope
    between them, ``eps / (min |g| + eps)^2`` (``1 / eps`` if their signs
    differ), and never more than ``2 lr``."""
    g_a, g_b = g_a.double().cpu(), g_b.double().cpu()
    low = torch.minimum(g_a.abs(), g_b.abs())
    slope = torch.where(torch.sign(g_a) == torch.sign(g_b),
                        ADAM_EPS / (low + ADAM_EPS) ** 2, 1.0 / ADAM_EPS)
    return torch.clamp_max(lr * (g_a - g_b).abs() * slope, 2.0 * lr)


def _gatne_card_vs_cpu(loss) -> dict:
    """One step of GATNE's ``loss`` (the defaults' first batch) on the card
    and on the CPU from the same initial values: the loss and every
    gradient within ``EMBED_TOL`` of their scale; the card's optimizer
    applied to the CPU's gradients within ``EMBED_TOL`` of the CPU's
    parameters; and each entry of the card's parameters after its own step
    within ``_first_step_bound`` of the CPU's (plus ``EMBED_TOL`` of the
    scale): Adam's first step ``lr · g / (|g| + eps)`` turns a float32
    rounding of a gradient entry near ``eps`` into a share of ``lr``, so
    the tables' largest differences after the step (~3e-5 of their scale
    on an H100) come from gradients equal within ~5e-7."""
    cfg = gatne.GATNEConfig(loss=loss)
    batch = [a[:cfg.batch_size] for a in _gatne_epochs(cfg, 1)[0]]
    data = load_multiplex(seed=0)
    ref = gatne.GATNEParams(data, cfg)
    ref.reset_parameters(torch.Generator().manual_seed(1))
    init = ref.state_dict()
    (cpu, l_cpu), (dev, l_dev) = (_gatne_pair(cfg, d, init, batch)
                                  for d in ("cpu", DEVICE))
    cpu_params = dict(cpu.named_parameters())
    opt_params, opt = gatne.gatne_model(data, cfg, torch.device(DEVICE))
    opt_params.load_state_dict(init)
    for k, p in opt_params.named_parameters():
        p.grad = cpu_params[k].grad.to(DEVICE)
    opt.step()
    want = cpu.state_dict()
    out = {"loss": _rel_err(l_dev, l_cpu),
           **{f"grad_{k}": _rel_err(p.grad, cpu_params[k].grad)
              for k, p in dev.named_parameters()},
           **{f"optimizer_{k}": _rel_err(v, want[k])
              for k, v in opt_params.state_dict().items()}}
    bad = {k: v for k, v in out.items() if not v <= EMBED_TOL}
    params, used = {}, {}
    for k, p in dev.named_parameters():
        w = cpu_params[k].detach()
        diff = (p.detach().cpu().double() - w.double()).abs()
        allowed = (_first_step_bound(p.grad, cpu_params[k].grad, cfg.lr)
                   + EMBED_TOL * float(w.abs().max()))
        params[k] = _rel_err(p.detach(), w)
        used[k] = float((diff / allowed).max())
        if not used[k] <= 1.0:
            bad[k] = (params[k], used[k])
    if bad:
        raise AssertionError(f"linkpred gatne {loss} card vs CPU: {bad}")
    return {**out, "params": params, "share_of_step_bound": used}


def _gatne_epochs(cfg, n_epochs=2):
    """The device loop's arrays of ``n_epochs`` epochs of ``cfg`` (the
    numpy draws of ``train_gatne``)."""
    data = load_multiplex(seed=0)
    rng = np.random.default_rng(cfg.seed)
    gatne.build_neighbor_tables(data, cfg.neighbor_samples, rng)
    source = gatne._Batches(data, cfg, rng)
    nb = len(source) // cfg.batch_size
    return [source.epoch(rng, nb) for _ in range(n_epochs)]


def _linkpred_card_vs_cpu() -> dict:
    """One training step of GATNE (both losses: ``_gatne_card_vs_cpu``)
    and of BiNE (its first batch) on the card and on the CPU from the same
    initial values; BiNE's loss, every gradient and every table after the
    step within ``EMBED_TOL`` of their scale."""
    out = {f"gatne_{loss}": _gatne_card_vs_cpu(loss)
           for loss in ("nsloss", "masked_bce")}
    cfg = bine.BiNEConfig()
    rng = np.random.default_rng(cfg.seed)
    bg, _ = bine.synthetic_ratings(rng)
    nu, nv = bg.node_counts["u"], bg.node_counts["v"]
    eu, ev, ew = bg.relations[("u", "rate", "v")]
    hub, auth = bine.hits_centrality(eu, ev, nu, nv)
    du = bine._side_dataset(bg, "u", hub, cfg, rng)
    dv = bine._side_dataset(bg, "v", auth, cfg, rng)
    batch = next(bine.bine_batches((eu, ev, ew), du, dv, cfg.batch_size,
                                   rng))
    ref = bine.BiNETables(nu, nv, cfg.embed_dim)
    bine._init_params(ref, 1)
    losses, models = [], []
    for device in ("cpu", DEVICE):
        device = torch.device(device)
        tables = bine.BiNETables(nu, nv, cfg.embed_dim)
        tables.load_state_dict(ref.state_dict())
        tables.to(device)
        opt = embed_loop.make_adam(tables.parameters(), cfg.lr, device,
                                   weight_decay=1e-4)
        losses.append(bine.bine_step(tables, opt, cfg, bine.batch_to_device(
            batch, nu, nv, device))[0])
        models.append(tables)
    out["bine"] = {"loss": _rel_err(losses[1], losses[0]),
                   **_state_errs(models[1], models[0])}
    if not max(out["bine"].values()) <= EMBED_TOL:
        raise AssertionError(f"linkpred bine card vs CPU: {out['bine']}")
    return out


def _gatne_twins(loss) -> dict:
    """Two epochs of GATNE's device loop replayed from the capture against
    the same two epochs (the same arrays) stepped eagerly from the same
    initial values: the losses and every parameter bit-equal."""
    cfg = gatne.GATNEConfig(loss=loss)
    epochs = _gatne_epochs(cfg)
    data = load_multiplex(seed=0)
    nb_tab = torch.from_numpy(gatne.build_neighbor_tables(
        data, cfg.neighbor_samples, np.random.default_rng(0))).to(DEVICE)
    fn = gatne.masked_bce if loss == "masked_bce" else gatne.nsloss
    runs = []
    for captured in (True, False):
        params, opt = gatne.gatne_model(data, cfg, torch.device(DEVICE))
        loop = embed_loop.HostDrawnEpochs(
            gatne.make_step(params, opt, fn, nb_tab), epochs[0],
            cfg.batch_size, opt, torch.device(DEVICE))
        rows = [loop.run(a) if captured else loop.run_eager(a)
                for a in epochs]
        runs.append((rows, params.state_dict()))
    (got, got_state), (want, want_state) = runs
    rows_equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    differ = [k for k, v in got_state.items()
              if not torch.equal(v, want_state[k])]
    if not rows_equal or differ:
        raise AssertionError(f"linkpred gatne {loss}: captured vs eager "
                             f"rows equal {rows_equal}, parameters that "
                             f"differ {differ}")
    return {"bit_equal": True, "steps_per_epoch": len(got[0]),
            "losses": [float(r.astype(np.float64).mean()) for r in got]}


def _bine_run() -> dict:
    """BiNE through the CLI at its defaults: no launch, the loss falling,
    the REPRO criterion; host seconds of HITS, the walks and the two side
    corpora (walks included), and the eager ms per step split into the
    host's batch draw, its copy to the card and the step's host call,
    beside the step's device time: the profiler's kernel time of its last
    call repeated (the host's ~8 ms a call outlasts ``time_ms``'s sleep
    kernel, so events would time the launches)."""
    parts = _Parts([(bine, "hits_centrality", "hits"),
                    (bine, "bine_walks", "walks"),
                    (bine, "_side_dataset", "side_datasets"),
                    (bine, "link_prediction_metrics", "metrics"),
                    (bine, "batch_to_device", "copy"),
                    (bine, "bine_step", "step_call")])
    draws = {"s": 0.0}
    batches = bine.bine_batches

    def timed_batches(*args):
        it = batches(*args)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                draws["s"] += time.perf_counter() - t
            yield batch

    last = {}
    step = bine.bine_step

    def keep(tables, optimizer, cfg, batch):
        last["call"] = (tables, optimizer, cfg, batch)
        return step(tables, optimizer, cfg, batch)

    reset_launches()
    bine.bine_batches, bine.bine_step = timed_batches, keep
    try:
        with parts:
            t = time.perf_counter()
            res = cli_main(["--model", "bine", "--device", DEVICE,
                            "--quiet"])
            seconds = time.perf_counter() - t
    finally:
        bine.bine_batches, bine.bine_step = batches, step
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"linkpred bine: kernels launched {launches}")
    _linkpred_ok("bine", res)
    m = res["test_metrics"]
    if not (m["f1"] >= LINKPRED_F1 and m["auc"] >= LINKPRED_AUC):
        raise AssertionError(f"linkpred bine: REPRO criterion {m}")
    steps = len(parts.each["step_call"])
    host = dict(parts.host)
    call = last["call"]
    # the epochs' wall time (each ends in its loss read), with the ratings'
    # draw and the tables' set-up (the run less HITS, corpora, metrics)
    train_s = (seconds - host["hits"] - host["side_datasets"]
               - host["metrics"])
    out = {"run": "bine", "seconds": seconds, "launches": 0,
           "initial_loss": res["initial_loss"],
           "final_loss": res["final_loss"], "test_metrics": m,
           "host_s": {"hits": host["hits"], "walks": host["walks"],
                      "side_datasets": host["side_datasets"]},
           "steps": steps,
           "step_ms": {
               "wall": train_s * 1e3 / steps,
               "host_batch_draw": draws["s"] * 1e3 / steps,
               "host_copy": host["copy"] * 1e3 / steps,
               "host_step_call": host["step_call"] * 1e3 / steps,
               "device_kernel": kernel_ms(lambda: [bine.bine_step(*call)
                                                   for _ in range(10)]) / 10}}
    emit({"phase": "linkpred", **out})
    return out


def _basis_card_vs_cpu() -> dict:
    """``--model basis`` on the card against the port's CPU run: every float
    within ``BASIS_TOL``, the components, degrees and diameter equal."""
    reset_launches()
    t = time.perf_counter()
    got = cli_main(["--model", "basis", "--device", DEVICE, "--quiet"])
    seconds = time.perf_counter() - t
    want = basis_demo("cpu")
    errs = {}
    for k, v in want.items():
        if k in ("degree", "connected_components", "diameter"):
            if got[k] != v:
                raise AssertionError(f"basis {k}: {got[k]} vs {v}")
        else:
            errs[k] = float(np.abs(np.subtract(got[k], v)).max())
    if not max(errs.values()) <= BASIS_TOL:
        raise AssertionError(f"basis card vs CPU: {errs}")
    out = {"run": "basis", "seconds": seconds, "max_abs_err": errs,
           "diameter": got["diameter"], "launches": 0}
    emit({"phase": "linkpred", **out})
    return out


def phase_linkpred() -> dict:
    """GATNE, BiNE and the centrality toolkit (no kernel of the port, as in
    JAX): the four GATNE CLI runs of ``GATNE_RUNS`` (``_gatne_run``; the
    defaults held to the REPRO criterion), captured GATNE epochs bit-equal
    to eager ones for both losses, one step of each GATNE loss and of BiNE
    card vs CPU (``EMBED_TOL``), BiNE at its defaults (``_bine_run``, the
    REPRO criterion) and ``basis`` card vs CPU. Every kernel counter reads
    0 across the phase."""
    t0 = time.perf_counter()
    reset_launches()
    runs = {name: _gatne_run(name, argv, steps)
            for name, (argv, steps) in GATNE_RUNS.items()}
    m = runs["gatne"]["test_metrics"]
    if not (m["f1"] >= LINKPRED_F1 and m["auc"] >= LINKPRED_AUC):
        raise AssertionError(f"linkpred gatne: REPRO criterion {m}")
    reset_launches()
    checks = {"gatne_nsloss_captured_vs_eager": _gatne_twins("nsloss"),
              "gatne_masked_bce_captured_vs_eager": _gatne_twins(
                  "masked_bce"),
              "card_vs_cpu": _linkpred_card_vs_cpu()}
    emit({"phase": "linkpred", "tolerance": EMBED_TOL, **checks})
    runs["bine"] = _bine_run()
    runs["basis"] = _basis_card_vs_cpu()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"linkpred: kernels launched {launches}")
    emit({"phase": "linkpred", "launches": launches,
          "seconds": time.perf_counter() - t0})
    return runs


#: name, source, TPU kernel replaced, and which float32 case the summary
#: times (GCN's first layer for K1, in the gathered form the COO path
#: runs, and for K3 on the Cora hybrid; GAT's 8
#: heads for K2; the first GAT layer of a training step for K4-K6 and
#: K8-K10; SAGE's first layer on the Pubmed hybrid for K7)
KERNELS = {
    "K1": ("segment_sum", "graphneuralnetwork_tpu_torch/csrc/spmm_kernel.cu",
           "graphneuralnetwork_tpu/ops/pallas/spmm_kernel.py:94",
           lambda c: _width("cora", 128)(c) and c["form"] == "gather"),
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
                          + (f" ({c['form']})" if kern == "K1" else "")
                          + (" with dropout" if c.get("dropout") else ""),
        })
        if kern in ("K1", "K2", "K3", "K7"):   # every case of this run
            rows[-1]["cases"] = [
                {"case": _case_name(x), "ms": x["kernel_ms"],
                 "bound_ms": x["bound_ms"]}
                for x in cases if x["kernel"] == kern]
    return {"kernels": rows, "launch_floor_ms": floor_ms}


def _tile_case(c) -> str:
    return (f"{c['dtype']} {c['shape']} on {c['graph']}, {c['tile_dtype']} "
            "tiles")


def _case_name(c) -> str:
    if c["kernel"] == "K1":
        return f"{c['form']} {c['dtype']} {c['shape']} on {c['graph']}"
    if c["kernel"] == "K2":
        return f"{c['form']} {c['shape']} on {c['graph']}"
    return _tile_case(c)


def _attend_key(c) -> tuple:
    """An attend case's key; K8-K10's also name the shift."""
    key = (c["kernel"], c["graph"], c["dtype"],
           f"{c['shape'][1]}x{c['shape'][2]}", c["dropout"])
    return key + ((c["shift"],) if "shift" in c else ())


def previous_design(cases) -> dict:
    """Each K1-K10 case's time in this run beside its previous design's,
    which ``PREVIOUS_DESIGN_MS`` holds as recorded (None where it holds
    none: K1's gathered forms replace a gather and the per-edge kernel),
    not measured here."""
    rows = []
    for c in cases:
        if c["kernel"] == "K1":
            case = _case_name(c)
            key = (("K1", c["graph"], c["dtype"], c["shape"][1])
                   if c["form"] == "edges" else None)
        elif c["kernel"] == "K2":
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


#: Launches of one step of each dry-run phase at the Cora width on one
#: rank (a tiled halo partition with every edge interior: its K1 still
#: walks the empty boundary, which launches). GCN per layer: forward K1
#: over the interior and the boundary edges and K3 over the tiles, the
#: backward the same three over the transposes. GAT: forward K2 (the
#: shift) and K1 twice each (denominator, numerator) over interior and
#: boundary, K7 over the tiles; backward K1 for the numerator's d h and
#: for the two score gathers, over interior and boundary. HAN: the GAT
#: layer's K1 and K2 for each of its two metapath graphs (untiled). The
#: tensor-parallel phases on the 1 × 1 mesh: ``tp_gcn`` GCN's; ``tp_gat``
#: two halo GAT layers (attn1 and attn_out, each the GAT phase's 10 K1, 2
#: K2 and 1 K7); ``gtn_dense`` none (its products are cuBLAS's, as JAX's
#: are XLA's); ``gtn_sparse`` the sparse GTN's training step (the
#: compositions forward and backward, the degree sums and their
#: read-backs, the final convolution and its d x).
PARALLEL_LAUNCHES = {"gcn": {"K1": 8, "K3": 4},
                     "gat": {"K1": 10, "K2": 2, "K7": 1},
                     "han": {"K1": 20, "K2": 4},
                     "sage": {}, "skipgram": {}, "walks": {},
                     "tp_gcn": {"K1": 8, "K3": 4},
                     "tp_gat": {"K1": 20, "K2": 4, "K7": 2},
                     "gtn_dense": {}, "gtn_sparse": {"K1": 10}}
#: The halo GCN's training run: the CLI's epochs and REPRO criterion.
PARALLEL_EPOCHS, PARALLEL_ACC = 200, 0.80
#: Steps each dry-run phase is timed over.
PARALLEL_TIMED_STEPS = 10


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _collectives(step) -> dict:
    """One run of ``step`` under ``torch.profiler``: the host ms of the
    process group's collectives (the ``nccl:*`` events of ProcessGroupNCCL,
    ``gloo:*`` on the CPU) and their count by name, the device ms of
    kernels named NCCL and of every kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    host_us = nccl_us = kernel_us = 0.0
    calls = collections.Counter()
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernel_us += us
                nccl_us += us if "nccl" in e.name.lower() else 0.0
        elif e.name.startswith(("nccl:", "gloo:")):
            host_us += us
            calls[e.name] += 1
    return {"collective_host_ms": host_us / 1e3,
            "collective_calls": dict(calls), "nccl_kernel_ms": nccl_us / 1e3,
            "kernel_ms": kernel_us / 1e3}


def _four_way(setup) -> dict:
    """Part (c): every rank's local step of a 4-way tiled halo partition
    of the dry run's graph on the card, each given the halo slab built
    from the whole array, against the single-device ops."""
    from graphneuralnetwork_tpu_torch.ops.segment import (
        edge_softmax, segment_max as plain_segment_max)
    from graphneuralnetwork_tpu_torch.ops.spmm import spmm, spmm_weighted
    from graphneuralnetwork_tpu_torch.parallel import Mesh
    from graphneuralnetwork_tpu_torch.parallel.halo import (
        halo_slab, partition_graph_halo, segment_max_local, spmm_halo_local)
    from graphneuralnetwork_tpu_torch.parallel.halo_attention import (
        attend_local)

    n, layout = setup.n, Mesh.layout(4)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(n, 128, generator=gen).to(DEVICE)
    heads, feat = 8, 8
    h = torch.randn(n, heads, feat, generator=gen).to(DEVICE)
    fs, fd = (torch.randn(n, heads, generator=gen).to(DEVICE)
              for _ in range(2))
    res = {}
    for name, weight in (("weighted", setup.weight), ("unit", None)):
        hg = partition_graph_halo(setup.s, setup.r, n, weight, mesh=layout,
                                  tiled_interior=True, min_edges_per_tile=8)
        nps, pad = hg.nodes_per_shard, hg.n_node_pad - n
        xp = torch.cat([x, x.new_zeros(pad, x.shape[1])])
        shards = [hg.shard(k, DEVICE) for k in range(4)]
        rows = [slice(k * nps, (k + 1) * nps) for k in range(4)]
        graph = build_graph(setup.s, setup.r, n, weight, device=DEVICE)
        if weight is not None:
            got = torch.cat([spmm_halo_local(sh, xp[rw], halo_slab(xp, hg, k))
                             for k, (sh, rw) in enumerate(zip(shards, rows))])
            res["spmm"] = _rel_err(got[:n], spmm(graph, x))
            res["tiles"] = list(hg.n_tiles)
            res["boundary_edges"] = list(hg.bnd_edges)
            continue
        got = torch.cat([segment_max_local(sh, xp[rw], halo_slab(xp, hg, k))
                         for k, (sh, rw) in enumerate(zip(shards, rows))])
        res["segment_max"] = _rel_err(got[:n], plain_segment_max(
            x[graph.senders.long()], graph.receivers.long(), n,
            mask=graph.edge_mask))
        hp = torch.cat([h, h.new_zeros(pad, heads, feat)])
        fsp, fdp = (torch.cat([f, f.new_zeros(pad, heads)]) for f in (fs, fd))
        payload = torch.cat([hp.reshape(-1, heads * feat), fsp], dim=1)
        got = torch.cat([attend_local(sh, hp[rw], fsp[rw], fdp[rw],
                                      halo_slab(payload, hg, k))
                         for k, (sh, rw) in enumerate(zip(shards, rows))])
        sc = torch.nn.functional.leaky_relu(
            fs[graph.senders.long()] + fd[graph.receivers.long()], 0.2)
        want = spmm_weighted(graph, edge_softmax(graph, sc), h)
        res["attend"] = _rel_err(got[:n], want.reshape(n, -1))
    bad = {k: v for k, v in res.items()
           if isinstance(v, float) and not v <= PATH_TOL}
    if bad:
        raise AssertionError(f"parallel: 4-way local steps against the "
                             f"single-device ops: {bad}")
    return res


#: The hand-split tensor-parallel layout of part (d): "data" x "model".
TP_SHAPE = {"data": 2, "model": 2}


def _tp_leaves(model, family):
    """Each (d, m) rank's slices of ``model``'s parameters (``tp.py``'s
    rules) as leaves of their own, and the specs."""
    from graphneuralnetwork_tpu_torch.parallel import Mesh
    from graphneuralnetwork_tpu_torch.parallel.tp import (
        local_shard, model_param_shardings)

    specs = model_param_shardings(
        Mesh.layout(tuple(TP_SHAPE.values()), tuple(TP_SHAPE)), model,
        family)
    leaves = {(d, m): {k: local_shard(v.detach(), specs[k], TP_SHAPE,
                                      {"data": d, "model": m})
                       .clone().requires_grad_(True)
                       for k, v in model.named_parameters()}
              for d in range(TP_SHAPE["data"])
              for m in range(TP_SHAPE["model"])}
    return specs, leaves


def _tp_grads(specs, leaves) -> dict:
    """The whole gradient of each parameter from the ranks' leaves: the sum
    over the data ranks (the data all-reduce), the model ranks' slices
    side by side; a replicated parameter's from the model rank 0 (every
    model rank computes the same replicated part, once here)."""
    out = {}
    d_n, m_n = TP_SHAPE["data"], TP_SHAPE["model"]
    for k, spec in specs.items():
        if "model" in spec:
            out[k] = torch.cat([sum(leaves[(d, m)][k].grad
                                    for d in range(d_n))
                                for m in range(m_n)], spec.index("model"))
        else:
            out[k] = sum(leaves[(d, 0)][k].grad for d in range(d_n))
    return out


def _tp_gcn_local(leaves, hg, shards, xp, nps):
    """GCN's dp x tp forward split by hand: each (d, m) rank's conv1 slice
    (K1 and K3 at hidden/M columns, its halo slab built from the model
    rank's whole column block), the model psum as a sum of the M partial
    products, conv2 replicated on the data ranks."""
    from graphneuralnetwork_tpu_torch.parallel.halo import (halo_slab,
                                                            spmm_halo_local)

    d_n, m_n = TP_SHAPE["data"], TP_SHAPE["model"]
    rows = [slice(d * nps, (d + 1) * nps) for d in range(d_n)]
    sup = {(d, m): xp[rows[d]] @ leaves[(d, m)]["conv1.linear.weight"].T
           for d in range(d_n) for m in range(m_n)}
    h = {}
    for m in range(m_n):
        full = torch.cat([sup[(d, m)] for d in range(d_n)])
        for d in range(d_n):
            h[(d, m)] = torch.relu(
                spmm_halo_local(shards[d], sup[(d, m)],
                                halo_slab(full, hg, d))
                + leaves[(d, m)]["conv1.bias"])
    z = [sum(h[(d, m)] @ leaves[(d, m)]["conv2.linear.weight"].T
             for m in range(m_n)) for d in range(d_n)]
    full = torch.cat(z)
    return torch.cat([spmm_halo_local(shards[d], z[d], halo_slab(full, hg, d))
                      + leaves[(d, 0)]["conv2.bias"] for d in range(d_n)])


def _tp_attend(shards, hg, h, a_src, a_dst):
    """The halo attention of every data rank's ``h[d]`` [nps, H, F] with
    the attention vectors ``a_src[d]``/``a_dst[d]``: [D·nps, H·F]."""
    from graphneuralnetwork_tpu_torch.parallel.halo import halo_slab
    from graphneuralnetwork_tpu_torch.parallel.halo_attention import (
        attend_local)

    d_n = len(h)
    fs = [torch.einsum("nhf,hf->nh", h[d].float(), a_src[d])
          for d in range(d_n)]
    fd = [torch.einsum("nhf,hf->nh", h[d].float(), a_dst[d])
          for d in range(d_n)]
    payload = torch.cat([torch.cat([h[d].reshape(h[d].shape[0], -1).float(),
                                    fs[d]], dim=1) for d in range(d_n)])
    return [attend_local(shards[d], h[d], fs[d], fd[d],
                         halo_slab(payload, hg, d)) for d in range(d_n)]


def _tp_gat_local(leaves, hg, shards, xp, nps, heads, feat):
    """GAT's dp x tp forward split by hand: each (d, m) rank's heads of
    attn1 (K1 and K2 at heads/M), the model psum of attn_out's partial
    projections, attn_out's attention replicated on the data ranks."""
    d_n, m_n = TP_SHAPE["data"], TP_SHAPE["model"]
    hl = heads // m_n
    e = {}
    for m in range(m_n):
        h = [(xp[d * nps:(d + 1) * nps]
              @ leaves[(d, m)]["attn1.linear.weight"].T).reshape(
                  nps, hl, feat) for d in range(d_n)]
        out = _tp_attend(shards, hg, h,
                         [leaves[(d, m)]["attn1.attn_src"]
                          for d in range(d_n)],
                         [leaves[(d, m)]["attn1.attn_dst"]
                          for d in range(d_n)])
        for d in range(d_n):
            e[(d, m)] = torch.nn.functional.elu(out[d])
    proj = [sum(e[(d, m)] @ leaves[(d, m)]["attn_out.linear.weight"].T
                for m in range(m_n)) for d in range(d_n)]
    h2 = [p.reshape(nps, 1, -1) for p in proj]
    out = _tp_attend(shards, hg, h2,
                     [leaves[(d, 0)]["attn_out.attn_src"]
                      for d in range(d_n)],
                     [leaves[(d, 0)]["attn_out.attn_dst"]
                      for d in range(d_n)])
    return torch.cat(out)


def _tp_by_hand(setup) -> dict:
    """Part (d): a 2 x 2 dp x tp layout of GCN (hidden 128) and GAT (8
    heads x 8) at the Cora width, split by hand in this process: the data
    axis a 2-way tiled halo partition whose slabs are built from the whole
    arrays (as ``_four_way``), the model psum a sum of the M partial
    products; the ranks' logits, loss and gradients (summed over the data
    ranks, the model ranks' slices side by side) against the single-device
    model. K1 (and K2, K3, K7) run at the sharded widths: 64 of GCN's 128
    hidden columns, 4 of GAT's 8 heads."""
    from graphneuralnetwork_tpu_torch.parallel import Mesh
    from graphneuralnetwork_tpu_torch.parallel.halo import (
        partition_graph_halo)

    w, n = setup.w, setup.n
    gen = torch.Generator().manual_seed(11)
    x = setup.tensor(setup.feats)
    y = setup.tensor(setup.labels)
    idx = setup.tensor(setup.train_idx)
    res = {}
    for fam, weight in (("gcn", setup.weight), ("gat", None)):
        hg = partition_graph_halo(setup.s, setup.r, n, weight,
                                  mesh=Mesh.layout(TP_SHAPE["data"]),
                                  tiled_interior=True, min_edges_per_tile=8)
        shards = [hg.shard(d, DEVICE) for d in range(TP_SHAPE["data"])]
        nps = hg.nodes_per_shard
        xp = torch.cat([x, x.new_zeros(hg.n_node_pad - n, x.shape[1])])
        if fam == "gcn":
            model = GCN(x.shape[1], hidden=w["gcn_hidden"],
                        num_classes=setup.n_classes, dropout=0.0)
        else:
            model = GAT(x.shape[1], hidden=w["tp_gat_feat"],
                        num_heads=w["tp_gat_heads"],
                        num_classes=setup.n_classes, dropout=0.0)
        model.reset_parameters(gen)
        model.to(DEVICE)
        ref_logits = model(build_graph(setup.s, setup.r, n, weight,
                                       device=DEVICE), x)
        ref_loss = masked_softmax_cross_entropy(ref_logits[idx], y[idx])
        ref_loss.backward()
        specs, leaves = _tp_leaves(model, fam)
        reset_launches()
        if fam == "gcn":
            logits = _tp_gcn_local(leaves, hg, shards, xp, nps)[:n]
        else:
            logits = _tp_gat_local(leaves, hg, shards, xp, nps,
                                   w["tp_gat_heads"], w["tp_gat_feat"])[:n]
        loss = masked_softmax_cross_entropy(logits[idx], y[idx])
        loss.backward()
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        errs = {"logits": _rel_err(logits.detach(), ref_logits.detach()),
                "loss": _rel_err(loss.detach(), ref_loss.detach()),
                **{f"grad {k}": v for k, v in _module_errs(
                    _tp_grads(specs, leaves),
                    {k: p.grad for k, p in model.named_parameters()}
                ).items()}}
        bad = {k: v for k, v in errs.items() if not v <= PATH_TOL}
        if bad:
            raise AssertionError(f"parallel: the hand-split 2x2 {fam} "
                                 f"against the single-device model: {bad}")
        res[fam] = {"rel_err": errs, "launches": launches,
                    "local_width": (w["gcn_hidden"] // TP_SHAPE["model"]
                                    if fam == "gcn" else
                                    f"{w['tp_gat_heads'] // TP_SHAPE['model']}"
                                    f"x{w['tp_gat_feat']}")}
    return res


#: Ranks of part (e)'s sharded wedge plans.
SHARDED_PLAN_RANKS = 4


def phase_gtn_sharded(plan, plan_large) -> dict:
    """Part (e): the 920- and 4,637-node wedge plans sharded 4 ways by
    output slot (``parallel/gtn_sparse.py:shard_gtn_plan``). For each
    composition step, each rank's local compose (K1's gathered form over
    its ``fwd`` order) and its ``dh`` (K1 over its ``bwd`` order) on the
    card, each held against its plain version and timed beside its bound,
    its plain version and its library call (``_k1_gathered_case``); the
    ranks' rows cut by ``slot_cnt`` and concatenated, and their ``dh``
    summed, against the single-device composition and its ``dh``
    (``PATH_TOL``)."""
    from graphneuralnetwork_tpu_torch.parallel import Mesh
    from graphneuralnetwork_tpu_torch.parallel.gtn_sparse import (
        shard_gtn_plan)

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    c = GTN_DIMS["channels"]
    out = {"phase": "parallel", "part": "sharded_plan",
           "ranks": SHARDED_PLAN_RANKS, "tolerance": PATH_TOL, "plans": []}
    for label, p in (("gtn", plan), ("gtn3025", plan_large)):
        sp = shard_gtn_plan(p, Mesh.layout(SHARDED_PLAN_RANKS))
        orders = [sp.orders(k, DEVICE) for k in range(SHARDED_PLAN_RANKS)]
        rec = {"plan": label, "nnz": list(p.nnz),
               "slot_cnt": [list(x) for x in sp.slot_cnt],
               "wedge_cnt": [list(x) for x in sp.wedge_cnt],
               "l_pad": list(sp.l_pad), "steps": []}
        for s in range(len(sp.l_pad)):
            h = torch.randn(p.nnz[s], c, device=DEVICE, generator=gen)
            rows_t = p.nnz[s + 1] * p.n_types
            dq = torch.randn(rows_t, c, device=DEVICE, generator=gen)
            lp_rows = sp.l_pad[s] * p.n_types
            q_parts, dh, cases = [], torch.zeros_like(h), []
            lo = 0
            for k, (fwd, bwd) in enumerate(orders):
                cnt = sp.slot_cnt[s][k] * p.n_types
                q = fwd[s].sum(h, 1 << 30)
                q_parts.append(q[:cnt])
                dq_k = torch.zeros(lp_rows, c, device=DEVICE)
                dq_k[:cnt] = dq[lo:lo + cnt]
                lo += cnt
                dh += bwd[s].sum(dq_k, 1 << 30)
                for form, order, table in (("gather", fwd[s], h),
                                           ("transpose", bwd[s], dq_k)):
                    g = order.graph
                    case = _k1_gathered_case(
                        f"{label}_compose{s}_rank{k}", form, table,
                        g.receivers, g.row_ptr, g.n_nodes, g.senders,
                        g.edge_weight, long_rows=g.long_rows,
                        long_edges=g.long_edges)
                    cases.append({key: case[key] for key in (
                        "graph", "form", "edges_read", "n_out",
                        "max_abs_err", "kernel_ms", "plain_ms",
                        "library_ms", "library", "bound_ms", "bound_by")})
            want_q = p.step_fwd[s].sum(h, 1 << 30)
            want_dh = p.step_bwd[s].sum(dq, 1 << 30)
            errs = {"q": _rel_err(torch.cat(q_parts), want_q),
                    "dh": _rel_err(dh, want_dh)}
            bad = {k: v for k, v in errs.items() if not v <= PATH_TOL}
            if bad:
                raise AssertionError(
                    f"parallel: the {label} plan's step {s} sharded "
                    f"{SHARDED_PLAN_RANKS} ways against the single-device "
                    f"composition: {bad}")
            rec["steps"].append({"step": s, "rel_err": errs, "k1": cases})
        out["plans"].append(rec)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


#: ``tools/bench_scaling.py`` on the card at world 1: its default sizes.
SCALING_ARGV = ["--devices", "1"]


def _scaling(card: str) -> dict:
    """Part (f): the scaling tool at world 1 (its weak-scaling defaults:
    16,384 nodes x 262,144 edges x 128 features a device), edges/s of
    ``spmm_halo`` beside the card's name and power limit; then the device
    ms of one ``spmm_halo`` of the same inputs (``time_ms``: 10 calls
    queued behind a sleep kernel, run back to back on the card) beside the
    tool's wall ms a call."""
    from graphneuralnetwork_tpu_torch.parallel import make_mesh
    from graphneuralnetwork_tpu_torch.parallel.halo import (
        partition_graph_halo, shard_nodes_halo, spmm_halo)
    from graphneuralnetwork_tpu_torch.tools import bench_scaling

    reset_launches()
    summary = bench_scaling.main(SCALING_ARGV + ["--device", DEVICE])
    launches = {k: v for k, v in read_launches().items() if v}
    if not launches.get("K1"):
        raise AssertionError("parallel: bench_scaling launched no K1")
    rec = summary["detail"][0]
    n, e = 16384, 262144
    s, r, w, x = bench_scaling._build_inputs(n, e, 128)
    hg = partition_graph_halo(s, r, n, w, mesh=make_mesh(devices=[0],
                                                         device=DEVICE))
    xs = shard_nodes_halo(x, hg)
    with torch.no_grad():
        device_ms = time_ms(lambda: spmm_halo(hg, xs), batch=10)
    return {"card": card, "edges_per_s": rec["edges_per_s"],
            "ms_per_spmm": rec["seconds"] * 1e3,
            "device_ms_per_spmm": device_ms,
            "platform": summary["platform"], "launches": launches}


def phase_parallel(card: str) -> dict:
    """Phase ``parallel`` (module docstring): returns the launches of one
    step of each dry-run phase, summed."""
    import torch.distributed as dist

    from graphneuralnetwork_tpu_torch.parallel import (initialize_distributed,
                                                       make_mesh)
    from graphneuralnetwork_tpu_torch.parallel.dryrun import (
        SEED, Setup, dryrun_multichip)

    t0 = time.perf_counter()
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    try:
        mesh = make_mesh(device=DEVICE)
        if mesh.group is None or dist.get_backend() != (
                "nccl" if DEVICE == "cuda" else "gloo"):
            raise AssertionError("parallel: no NCCL process group")
        reports = dryrun_multichip(
            mesh, width="cora", timed_steps=PARALLEL_TIMED_STEPS,
            train_epochs=PARALLEL_EPOCHS)
        launches = {k: 0 for k in COUNTERS}
        for name, rep in reports.items():
            want = PARALLEL_LAUNCHES[name]
            if rep["launches"] != want:
                raise AssertionError(f"parallel {name}: launched "
                                     f"{rep['launches']} a step, expected "
                                     f"{want}")
            for k, v in rep["launches"].items():
                launches[k] += v
            rep.update(_collectives(rep.pop("step")))
            rep["collective_share_of_step"] = (
                rep["collective_host_ms"] / rep["step_ms"]
                if rep["step_ms"] else None)
            emit({"phase": "parallel", "part": name,
                  **{k: v for k, v in rep.items() if k != "phase"}})
        acc = reports["gcn"]["test_acc"]
        if not acc >= PARALLEL_ACC:
            raise AssertionError(f"parallel: the halo GCN's test_acc {acc} "
                                 f"after {PARALLEL_EPOCHS} epochs (REPRO "
                                 f"criterion {PARALLEL_ACC})")
        setup = Setup(mesh, "cora", SEED)
        four = _four_way(setup)
        t1 = time.perf_counter()
        tp = _tp_by_hand(setup)
        t2 = time.perf_counter()
        scaling = _scaling(card)
    finally:
        dist.destroy_process_group()
    emit({"phase": "parallel", "part": "four_way", "tolerance": PATH_TOL,
          **four, "seconds": t1 - t0})
    emit({"phase": "parallel", "part": "tp_by_hand", "shape": TP_SHAPE,
          "tolerance": PATH_TOL, **tp, "seconds": t2 - t1})
    emit({"phase": "parallel", "part": "bench_scaling", **scaling,
          "seconds": time.perf_counter() - t2})
    return launches


def main() -> None:
    card = phase_device()
    phase_build()
    phase_native(card)
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
    # HAN's PAP metapath graphs as the loader tiles them (float32 tiles)
    cases += phase_han_kernels(
        load_acm_han(seed=0, layout="hybrid", device=DEVICE).graphs[0],
        load_acm_han(seed=0, layout="hybrid", n_papers=HAN_PAPERS_LARGE,
                     device=DEVICE).graphs[0])
    # GTN's wedge plans: the CLI's 920-node ACM stack and the 3,025-paper
    # one (4,637 nodes)
    gtn_small, gtn_large = gtn_data(600), gtn_data(HAN_PAPERS_LARGE)
    gtn_plans = (gtn_plan(gtn_small), gtn_plan(gtn_large))
    cases += phase_gtn_kernels(*gtn_plans)
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
    # GCN-COO per epoch: 2 layers x (train + val forward) K1's gathered
    # form, and 2 in the backward (each layer's d support over the
    # transpose; the first layer's support X.W needs one too); the final
    # test evaluation adds one forward. GAT-COO per layer forward: K2 (the
    # shift), K1 (the denominator) and K1 (the aggregation); backward 4 K1:
    # the aggregation's d h over the transpose, the denominator's
    # read-back by receiver, the scores' gathers by sender (over the
    # transpose) and by receiver
    runs += [
        _drive("gcn", ["--model", "gcn", "--epochs", str(GCN_EPOCHS),
                       "--device", DEVICE, "--quiet"], {"K1": (6, 2)}),
        _drive("gat", ["--model", "gat", "--layout", "coo", "--epochs",
                       str(GAT_EPOCHS), "--device", DEVICE, "--quiet"],
               {"K1": (16, 4), "K2": (4, 2)}),
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
    # tiles and K1 on the remainder, 2 K3 and 2 K1 in the backward (d
    # support of both layers: the transpose tiles, and the remainder's
    # transpose)
    for dtype in ("float32", "bfloat16"):
        runs.append(_drive(
            "gcn_hybrid" + ("_bf16" if dtype == "bfloat16" else ""),
            ["--model", "gcn", "--layout", "hybrid", "--epochs",
             str(GCN_EPOCHS), "--dtype", dtype, "--device", DEVICE,
             "--quiet"], {"K3": (6, 2), "K1": (6, 2)}))
    # SAGE mean per forward: 2 layers x (counts + sum) K3 and K1; the
    # backward needs d input of sage_out only (sage0's input is the
    # features): 1 K3 and 1 K1 (the remainder's transpose). Max per
    # forward: 2 layers x (K7 + K2), backward in plain PyTorch.
    sage = ["--model", "graphsage", "--layout", "hybrid", "--epochs",
            str(SAGE_EPOCHS), "--device", DEVICE, "--quiet"]
    runs.append(_drive("graphsage_hybrid", sage,
                       {"K3": (9, 4), "K1": (9, 4)}))
    runs.append(_drive("graphsage_hybrid_max",
                       sage + ["--set", "aggregator=max"],
                       {"K7": (4, 2), "K2": (4, 2)}))
    runs += phase_han()
    runs += phase_gtn(gtn_small, gtn_large, *gtn_plans)
    # phase parallel's sharded wedge plans, on the plans built here
    phase_gtn_sharded(*gtn_plans)
    del gtn_small, gtn_large, gtn_plans
    row_sum, row_sum_launches = phase_row_sum()
    runs.append(row_sum_launches)
    phase_sage_sampled()
    phase_embed()
    phase_linkpred()
    runs.append(phase_parallel(card))
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
