"""The system under test, built from the generated arrays: the port's graph
builders, model, training state and captured epoch block, as the CLI
assembles them (``data/planetoid.py:load_cora``, ``cli.py``,
``train/scan_loop.py``), with the benchmark's data and initial weights.
What differs by model is ``models/<model>.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from graphneuralnetwork_tpu_torch.core.graph import (add_self_loops,
                                                     gcn_graph, symmetrize)
from graphneuralnetwork_tpu_torch.core.reorder import (invert_permutation,
                                                       locality_order)
from graphneuralnetwork_tpu_torch.data.planetoid import NodeClassificationData
from graphneuralnetwork_tpu_torch.train.loop import (create_train_state,
                                                     make_eval_fn)
from graphneuralnetwork_tpu_torch.train.scan_loop import CapturedBlock
from graphneuralnetwork_tpu_torch.train.schedule import make_optimizer

from . import spec
from .generate import Dataset


@dataclasses.dataclass
class Program:
    data: NodeClassificationData
    model: torch.nn.Module
    state: object            # train.loop.TrainState
    block: CapturedBlock
    perm: Optional[np.ndarray]   # perm[new] = old on the hybrid layout
    graph_build_s: float


def model(cfg: dict):
    """The configuration's model, ``models/<model>.py``."""
    return spec.part("models", cfg["model"])


def build_graph(ds: Dataset, cfg: dict, layout: str, device):
    """The port's graph for ``layout``, warmed, and its renumbering."""
    s, r, n = ds.senders, ds.receivers, ds.n_nodes
    if layout == "coo":
        return gcn_graph(s, r, n, device=device).warm(), None
    if layout != "hybrid":
        raise ValueError(f"unknown layout {layout!r}")
    perm = locality_order(*add_self_loops(*symmetrize(s, r), n), n)
    return model(cfg).hybrid_graph(ds, perm, device).warm(), perm


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(ds: Dataset, cfg: dict, layout: str, params: dict, seed: int,
          device) -> Program:
    """Graph, data, model, optimizer and epoch block; the block has not
    run yet."""
    t0 = time.perf_counter()
    graph, perm = build_graph(ds, cfg, layout, device)
    sync(device)
    graph_build_s = time.perf_counter() - t0
    feats, labels = ds.features, ds.labels
    idx = [ds.train_idx, ds.val_idx, ds.test_idx]
    if perm is not None:
        inv = invert_permutation(perm)
        feats = feats[torch.from_numpy(perm).to(feats.device)]
        labels = labels[perm]
        idx = [np.sort(inv[i]) for i in idx]

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    data = NodeClassificationData(
        graph=graph, features=feats, labels=dev(labels),
        train_idx=dev(idx[0]), val_idx=dev(idx[1]), test_idx=dev(idx[2]),
        num_classes=cfg["num_classes"], device=torch.device(device))
    net = model(cfg).make_model(cfg)
    opt = cfg["optimizer"]
    optimizer = make_optimizer(opt["name"], opt["lr"],
                               weight_decay=opt["weight_decay"])
    state = create_train_state(net, data, seed, optimizer, params=params)
    block = CapturedBlock(state, data, make_eval_fn(net),
                          cfg["epochs_per_call"])
    return Program(data, net, state, block, perm, graph_build_s)


def tiled_fraction(graph) -> float:
    """The share of the edges in dense tiles (0 on the COO layout)."""
    if not hasattr(graph, "bcsr"):
        return 0.0
    tiled = graph.bcsr.n_edges
    return tiled / (tiled + graph.rem.n_edges)
