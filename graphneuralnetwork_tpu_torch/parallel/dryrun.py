"""The multi-device dry run: one training step of each data-, graph- and
tensor-parallel path, each held against the single-device model.

Port of the ten phases of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``:

  1. ``gcn``: a GCN step on a tiled halo partition (K1 on every shard's
     interior and boundary edges, K3 on its interior tiles);
  1b. ``gat``: a GAT layer and a linear read-out on the tiled halo
     partition with unit weights (one exchange a layer);
  3. ``han``: HAN on two halo-partitioned metapath graphs (the semantic
     attention's mean over every rank's rows);
  5. ``sage``: device-sampled GraphSAGE, the batch split by rank, each rank
     drawing its hops from its own generator;
  6. ``skipgram``: data-parallel skip-gram, the batch rows split by rank;
  7. ``walks``: node2vec p/q walks on the device, the start nodes split by
     rank;
  2. ``tp_gcn``: a dp × tp GCN step (``tp_models.py``) on a "data" ×
     "model" mesh, the data axis a tiled halo partition;
  2b. ``tp_gat``: a dp × tp GAT step, heads split over "model";
  4. ``gtn_dense``: the dense GTN on its stack's rows split over the
     ranks (``TPGTN`` on the 1-D mesh);
  8. ``gtn_sparse``: the wedge-plan GTN on a plan sharded by output slot
     (``gtn_sparse.py``), every rank computing the replicated loss.

Every step but the last is data-parallel (``dp.py``): each rank's loss is
its share of the global loss, the gradients are summed over the (data)
ranks; the sharded GTN's gradients need no sum. Each phase compares the
step's logits (gathered from every rank), loss and gradients (each rank's
slices against the same slices of the reference's) with the same model
on the whole graph on one device, from the same weights, and raises past
``TOL`` (relative to the largest entry). The tensor-parallel phases run on
a 2 × 2 mesh in a world of 4 and on ``world × 1`` otherwise. The ``tiny``
width is JAX's dry run (64 nodes a rank, 32 features; GCN hidden 16, GAT
2 heads × 4, GTN 2 channels × hidden 8 on random stacks of 0.05 density);
``cora`` is the CLI's Cora shape (2,708 × 1,433, 7 classes; GCN hidden
128, GAT 8 heads × 8, HAN at its CLI widths, 4 heads × 8) and the CLI's
GTN (2 channels, hidden 64) on its 920-node ACM stack, where
``train_epochs`` also trains the halo GCN at the CLI's recipe and reports
its test accuracy.

    torchrun --standalone --nproc_per_node N \
        -m graphneuralnetwork_tpu_torch.parallel.dryrun
    python -m graphneuralnetwork_tpu_torch.parallel.dryrun --device cpu

One JSON line a phase (from the primary process). The CPU runs gloo; the
card NCCL, one process per card.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.graph import (add_self_loops, build_graph, row_normalize_features,
                          sym_normalize_weights, symmetrize)
from ..data.planetoid import synthetic_citation_graph
from ..data.acm import load_acm_gtn
from ..nn import GAT, GCN, HAN
from ..nn.conv import GATConv
from ..nn.gtn import GTN
from ..nn.gtn_sparse import SparseGTN, build_gtn_plan, stacked_adj_to_sparse
from ..nn.embed import SkipGram
from ..nn.sage import SampledGraphSAGE
from ..ops.cuda.counters import read_launches, reset_launches
from ..sampling.device_neighbor import (build_device_neighbor_table,
                                        device_multihop_sampling)
from ..sampling.device_walks import (build_node2vec_tables,
                                     device_node2vec_walks)
from ..sampling.walks import csr_from_edges
from ..train.embed_loop import (make_adam, make_skipgram_step,
                                shard_batch_arrays)
from ..train.metrics import masked_softmax_cross_entropy
from ..train.schedule import make_optimizer
from .collectives import all_gather_rows, all_reduce_sum, broadcast_parameters
from .dp import dp_cross_entropy, dp_step, owned_rows
from .gtn_sparse import shard_gtn_plan
from .halo import partition_graph_halo, shard_nodes_halo
from .halo_attention import rank_generator
from .multihost import Mesh, initialize_distributed, is_primary, make_mesh
from .tp import local_shard, make_tp_mesh, shard_rows
from .tp_models import gtn_rows, tensor_parallel

#: The step against the single-device model: logits and loss relative to
#: their largest entry, each gradient relative to the largest gradient
#: entry of its scale group (``_scale_group``); two summation orders of
#: the same float32 math differ by ~1e-6 of the scale.
TOL = 1e-4
#: The seed of the weights, the graphs' draws and the generators.
SEED = 0
WIDTHS = {
    "tiny": dict(nodes_per_rank=64, feats=32, classes=4, gcn_hidden=16,
                 gat_heads=2, gat_feat=8, han_hidden=4, han_heads=2,
                 han_edges_per_node=40 / 64, sage_dims=(8,),
                 sage_fanouts=(3, 3), sage_batch=8, embed_dim=8,
                 embed_batch=16, embed_ctx=4, walk_starts=8, walk_length=6,
                 min_edges_per_tile=8, tp_gat_heads=2, tp_gat_feat=4,
                 gtn_hidden=8, gtn_types=3, gtn_density=0.05),
    "cora": dict(feats=1433, classes=7, gcn_hidden=128, gat_heads=8,
                 gat_feat=8, han_hidden=8, han_heads=4, han_edges_per_node=5,
                 sage_dims=(128,), sage_fanouts=(10, 10), sage_batch=64,
                 embed_dim=128, embed_batch=512, embed_ctx=6,
                 walk_starts=1024, walk_length=10, min_edges_per_tile=8,
                 tp_gat_heads=8, tp_gat_feat=8, gtn_hidden=64),
}


class Setup:
    """The dry run's graph and features (the same on every rank), its
    mesh, widths and seed."""

    def __init__(self, mesh: Mesh, width: str, seed: int):
        self.mesh, self.w, self.seed = mesh, WIDTHS[width], seed
        self.device = mesh.device
        if width == "tiny":
            feats, labels, s, r = synthetic_citation_graph(
                n_nodes=self.w["nodes_per_rank"] * mesh.size,
                n_feats=self.w["feats"], n_classes=self.w["classes"],
                seed=0)
            n = feats.shape[0]
            self.train_idx = np.arange(0, n // 2)
            self.test_idx = np.arange(n // 2, n)
        else:
            feats, labels, s, r = synthetic_citation_graph(seed=0)
            feats = row_normalize_features(feats)
            n = feats.shape[0]
            self.train_idx = np.arange(0, 140)
            self.test_idx = np.arange(500, 1500)
        s, r = symmetrize(s, r)
        self.s, self.r = add_self_loops(s, r, n)
        self.weight = sym_normalize_weights(self.s, self.r, n)
        self.n, self.feats = n, feats
        self.labels = labels.astype(np.int64)
        self.n_classes = int(labels.max()) + 1

    @property
    def tp_mesh(self) -> Mesh:
        """The tensor-parallel phases' "data" × "model" mesh: 2 × 2 in a
        world of 4, else ``world × 1`` (built once: its groups' creation
        is collective)."""
        if "_tp_mesh" not in self.__dict__:
            d = self.mesh.size
            shape = (2, 2) if d == 4 else (d, 1)
            self._tp_mesh = make_tp_mesh(*shape, devices=list(
                self.mesh.devices.ravel()), device=self.device)
        return self._tp_mesh

    def gtn_stack(self) -> tuple:
        """GTN's input (numpy): the stack [T, N, N] with the identity
        last, the features, each node's label (0 off the targets) and the
        training rows' node ids. ``tiny``: JAX's dry-run stack on this
        graph; ``cora``: the CLI's 920-node synthetic ACM."""
        if "gtn_density" in self.w:
            rng = np.random.default_rng(self.seed)
            t, n = self.w["gtn_types"], self.n
            adj = (rng.random((t - 1, n, n))
                   < self.w["gtn_density"]).astype(np.float32)
            adj = np.concatenate([adj, np.eye(n, dtype=np.float32)[None]])
            return adj, self.feats, self.labels, self.train_idx
        data = load_acm_gtn(seed=self.seed, device="cpu")
        tgt = data.target_idx.numpy()
        labels = np.zeros(data.adj.shape[1], np.int64)
        labels[tgt] = data.labels.numpy()
        return (data.adj.numpy(), data.features.numpy(), labels,
                tgt[data.train_idx.numpy()])

    def tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def init(self, module: torch.nn.Module, salt: int) -> torch.nn.Module:
        """``module`` on the device with parameters from the run's seed,
        the same on every rank (rank 0's, broadcast)."""
        module.reset_parameters(torch.Generator().manual_seed(
            self.seed * 100 + salt))
        module.to(self.device)
        broadcast_parameters(module, self.mesh)
        return module


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _grads(module: torch.nn.Module) -> dict:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()
            if p.grad is not None}


def _scale_group(name: str) -> str:
    """The parameters whose gradients share a scale: a module's (a
    Linear's weight and bias together), and HAN's semantic attention's
    projection with its ``q``: the projection bias's gradient is a sum
    over P x N rows that cancels to ~1e-2 of its weight's."""
    module = name.rpartition(".")[0]
    return module[:-len("proj")].rstrip(".") if module.endswith(
        "proj") else module


def _grad_errs(model, ref) -> dict:
    """Each gradient of ``model`` against ``ref``'s (this rank's slice of
    it where ``model`` is tensor-parallel: its ``specs``): the largest
    difference over the largest entry of the reference's scale group."""
    want = _grads(ref)
    scale = {}
    for k, g in want.items():
        grp = _scale_group(k)
        scale[grp] = max(scale.get(grp, 0.0), float(g.abs().max()))
    specs = getattr(model, "specs", None)
    if specs is not None:
        mesh = model.mesh
        coords = {a: mesh.coord(a) for a in mesh.axis_names}
        want = {k: local_shard(g, specs[k], mesh.shape, coords)
                for k, g in want.items()}
    return {f"grad {k}": float((g - want[k]).abs().max())
            / max(scale[_scale_group(k)], 1e-30)
            for k, g in _grads(model).items()}


def _compare(phase: str, pairs: dict, grad_errs: dict) -> dict:
    """``pairs``' errors (``_rel``) and ``grad_errs``, checked against
    ``TOL``."""
    errs = {k: _rel(a, b) for k, (a, b) in pairs.items()}
    errs.update(grad_errs)
    bad = {k: e for k, e in errs.items() if not e <= TOL}
    if bad:
        raise AssertionError(f"dryrun {phase}: the partitioned step differs "
                             f"from the single-device step: {bad}")
    return errs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted(step: Callable[[], float], device: torch.device):
    """Run ``step`` once with the launch counts set to 0 just before and
    read just after: (its result, the launches)."""
    _sync(device)
    reset_launches()
    out = step()
    _sync(device)
    return out, {k: n for k, n in read_launches().items() if n}


def _timed(step: Callable[[], float], device: torch.device,
           reps: int) -> Optional[float]:
    """The median host ms of ``reps`` runs of ``step``, each ended by a
    device synchronisation; None for no run."""
    if reps <= 0:
        return None
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        step()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _report(phase: str, setup: Setup, loss, errs: dict, launches: dict,
            step: Callable[[], float], timed_steps: int, **extra) -> dict:
    return dict(phase=phase, world=setup.mesh.size, loss=float(loss),
                rel_err=errs, launches=launches,
                step_ms=_timed(step, setup.device, timed_steps),
                step=step, **extra)


def _ce_step(phase: str, setup: Setup, model, ref, graph, ref_graph, x, y,
             rows, idx, opt, forward, mesh: Optional[Mesh] = None,
             ref_inputs=None):
    """The data-parallel cross-entropy step of ``model`` (``forward(model,
    graph, x)`` gives this rank's logits) over the (data) ``mesh`` (the
    run's by default) against ``ref`` on the whole graph (``ref_inputs``:
    its features and labels, the run's by default); returns (loss,
    errors, launches, step)."""
    mesh = setup.mesh if mesh is None else mesh
    feats, labels = ((setup.feats, setup.labels) if ref_inputs is None
                     else ref_inputs)
    ref_logits = forward(ref, ref_graph, setup.tensor(feats))
    ref_loss = masked_softmax_cross_entropy(
        ref_logits[idx], setup.tensor(labels)[idx])
    ref_loss.backward()
    held = {}

    def local_loss():
        logits = forward(model, graph, x)
        held["logits"] = logits.detach()
        return dp_cross_entropy(logits, y, rows, mesh)

    def step():
        return float(dp_step(model.parameters(), opt, local_loss, mesh))

    loss, launches = _counted(step, setup.device)
    logits = all_gather_rows(held["logits"], mesh)[:ref_logits.shape[0]]
    pairs = {"logits": (logits, ref_logits),
             "loss": (torch.tensor(loss), ref_loss.detach().cpu())}
    return loss, _compare(phase, pairs, _grad_errs(model, ref)), launches, \
        step


def phase_gcn(setup: Setup, timed_steps: int = 0,
              train_epochs: int = 0) -> dict:
    """Phase 1: a GCN step on the tiled halo partition; with
    ``train_epochs``, a fresh GCN trained that long at the CLI's recipe
    (dropout 0.5, AdamW 2e-3, weight decay 5e-4) and its test accuracy."""
    w, mesh = setup.w, setup.mesh
    hg = partition_graph_halo(setup.s, setup.r, setup.n, setup.weight,
                              mesh=mesh, tiled_interior=True,
                              min_edges_per_tile=w["min_edges_per_tile"])
    x, y = (shard_nodes_halo(setup.feats, hg),
            shard_nodes_halo(setup.labels, hg))
    nps = hg.nodes_per_shard

    def make(dropout=0.0):
        return GCN(setup.feats.shape[1], hidden=w["gcn_hidden"],
                   num_classes=setup.n_classes, dropout=dropout)

    model = setup.init(make(), 1)
    ref = copy.deepcopy(model)
    idx = setup.tensor(setup.train_idx)
    rows = owned_rows(idx, mesh.rank, nps)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    ref_graph = build_graph(setup.s, setup.r, setup.n, setup.weight,
                            device=setup.device)
    loss, errs, launches, step = _ce_step(
        "gcn", setup, model, ref, hg, ref_graph, x, y, rows, idx, opt,
        lambda m, g, xx: m(g, xx))
    extra = dict(tiles=hg.n_tiles, boundary_edges=hg.bnd_edges)
    if train_epochs:
        extra.update(_train_gcn(setup, hg, x, y, make(0.5), train_epochs))
    return _report("gcn", setup, loss, errs, launches, step, timed_steps,
                   **extra)


def _train_gcn(setup: Setup, hg, x, y, model, epochs: int) -> dict:
    mesh = setup.mesh
    nps = hg.nodes_per_shard
    model = setup.init(model, 2)
    opt, _ = make_optimizer("adamw", 2e-3, weight_decay=5e-4).build(
        model.parameters())
    gen = rank_generator(setup.seed, mesh.rank, setup.device)
    rows = owned_rows(setup.tensor(setup.train_idx), mesh.rank, nps)
    model.train()
    t0 = time.perf_counter()
    for _ in range(epochs):
        loss = dp_step(model.parameters(), opt, lambda: dp_cross_entropy(
            model(hg, x, generator=gen), y, rows, mesh), mesh)
    _sync(setup.device)
    seconds = time.perf_counter() - t0
    model.eval()
    with torch.no_grad():
        pred = model(hg, x).argmax(dim=-1)
    test = owned_rows(setup.tensor(setup.test_idx), mesh.rank, nps)
    hits = all_reduce_sum(torch.stack([
        (pred[test] == y[test]).float().sum(),
        torch.tensor(float(test.shape[0]), device=setup.device)]), mesh)
    return dict(train_epochs=epochs, train_seconds=seconds,
                final_loss=float(loss), test_acc=float(hits[0] / hits[1]))


class _GATReadout(torch.nn.Module):
    """JAX's phase-1b model: one multi-head GAT layer, then a linear
    read-out of the concatenated heads (no bias)."""

    def __init__(self, f_in: int, heads: int, feat: int, classes: int):
        super().__init__()
        self.gat = GATConv(f_in, feat, num_heads=heads)
        self.out = torch.nn.Linear(heads * feat, classes, bias=False)

    def reset_parameters(self, generator=None):
        self.gat.reset_parameters(generator)
        with torch.no_grad():
            self.out.weight.normal_(0.0, 0.2, generator=generator)

    def forward(self, graph, x):
        return self.out(self.gat(graph, x))


def phase_gat(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 1b: a GAT step on the tiled halo partition with unit
    weights."""
    w, mesh = setup.w, setup.mesh
    hg = partition_graph_halo(setup.s, setup.r, setup.n, mesh=mesh,
                              tiled_interior=True,
                              min_edges_per_tile=w["min_edges_per_tile"])
    x, y = (shard_nodes_halo(setup.feats, hg),
            shard_nodes_halo(setup.labels, hg))
    model = setup.init(_GATReadout(setup.feats.shape[1], w["gat_heads"],
                                   w["gat_feat"], setup.n_classes), 3)
    model.eval()
    ref = copy.deepcopy(model)
    idx = setup.tensor(setup.train_idx)
    rows = owned_rows(idx, mesh.rank, hg.nodes_per_shard)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    ref_graph = build_graph(setup.s, setup.r, setup.n, device=setup.device)
    loss, errs, launches, step = _ce_step(
        "gat", setup, model, ref, hg, ref_graph, x, y, rows, idx, opt,
        lambda m, g, xx: m(g, xx))
    return _report("gat", setup, loss, errs, launches, step, timed_steps,
                   tiles=hg.n_tiles)


def phase_han(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 3: HAN on two random metapath graphs, each halo-partitioned
    (GATConv on the halo branch; the semantic mean over every rank's
    rows)."""
    w, mesh = setup.w, setup.mesh
    rng = np.random.default_rng(setup.seed)
    e = int(w["han_edges_per_node"] * setup.n)
    edges = [(rng.integers(0, setup.n, e), rng.integers(0, setup.n, e))
             for _ in range(2)]
    hgs = [partition_graph_halo(s, r, setup.n, mesh=mesh) for s, r in edges]
    x, y = (shard_nodes_halo(setup.feats, hgs[0]),
            shard_nodes_halo(setup.labels, hgs[0]))
    model = setup.init(HAN(setup.feats.shape[1], 2, setup.n_classes,
                           hidden=w["han_hidden"],
                           num_heads=(w["han_heads"],), dropout=0.0), 4)
    model.eval()
    ref = copy.deepcopy(model)
    idx = setup.tensor(setup.train_idx)
    rows = owned_rows(idx, mesh.rank, hgs[0].nodes_per_shard)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    ref_graphs = [build_graph(s, r, setup.n, device=setup.device)
                  for s, r in edges]
    loss, errs, launches, step = _ce_step(
        "han", setup, model, ref, hgs, ref_graphs, x, y, rows, idx, opt,
        lambda m, g, xx: m(g, xx))
    return _report("han", setup, loss, errs, launches, step, timed_steps)


def phase_sage(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 5: device-sampled GraphSAGE, each rank drawing the hops of its
    block of the batch from its own generator; the reference steps on
    every rank's hops at once."""
    w, mesh = setup.w, setup.mesh
    indptr, indices, _ = csr_from_edges(setup.s, setup.r, setup.n)
    table, deg = build_device_neighbor_table(indptr, indices,
                                             device=setup.device)
    feats = setup.tensor(setup.feats)
    labels = setup.tensor(setup.labels)
    dims = (*w["sage_dims"], setup.n_classes)
    fanouts = w["sage_fanouts"]
    model = setup.init(SampledGraphSAGE(setup.feats.shape[1], dims,
                                        fanouts[:len(dims)]), 5)
    ref = copy.deepcopy(model)
    batch = w["sage_batch"] * mesh.size
    sel = torch.tensor_split(torch.arange(batch, device=setup.device),
                             mesh.size)[mesh.rank]
    gen = rank_generator(setup.seed + 2, mesh.rank, setup.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    held = {}

    def local_loss():
        hops = device_multihop_sampling(gen, sel, fanouts[:len(dims)],
                                        table, deg)
        held["hops"] = hops
        logits = model([feats[h.long()] for h in hops])
        held["logits"] = logits.detach()
        return dp_cross_entropy(logits, labels[sel.long()],
                                torch.arange(sel.shape[0],
                                             device=setup.device), mesh)

    def step():
        return float(dp_step(model.parameters(), opt, local_loss, mesh))

    loss, launches = _counted(step, setup.device)
    hops = [all_gather_rows(h, mesh) for h in held["hops"]]
    ref_logits = ref([feats[h.long()] for h in hops])
    ref_loss = masked_softmax_cross_entropy(ref_logits,
                                            labels[hops[0].long()])
    ref_loss.backward()
    pairs = {"logits": (all_gather_rows(held["logits"], mesh), ref_logits),
             "loss": (torch.tensor(loss), ref_loss.detach().cpu())}
    return _report("sage", setup, loss,
                   _compare("sage", pairs, _grad_errs(model, ref)), launches,
                   step, timed_steps)


def phase_skipgram(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 6: a data-parallel skip-gram step, the batch's rows split by
    rank, against the single-device step on the whole batch."""
    w, mesh = setup.w, setup.mesh
    rng = np.random.default_rng(setup.seed)
    b, c = w["embed_batch"] * mesh.size, w["embed_ctx"]
    centers = rng.integers(0, setup.n, b).astype(np.int32)
    ctx_neg = rng.integers(0, setup.n, (b, c)).astype(np.int32)
    labels = (rng.random((b, c)) < 0.5).astype(np.float32)
    mask = np.ones((b, c), np.float32)
    model = setup.init(SkipGram(setup.n, w["embed_dim"]), 6)
    ref = copy.deepcopy(model)
    step_dp = make_skipgram_step(
        model, make_adam(model.parameters(), 1e-2, setup.device), mesh=mesh)
    batch = shard_batch_arrays((centers, ctx_neg, labels, mask), mesh)

    def step():
        return float(step_dp(*batch)[0])

    loss, launches = _counted(step, setup.device)
    ref_step = make_skipgram_step(
        ref, make_adam(ref.parameters(), 1e-2, setup.device))
    ref_loss, _ = ref_step(*(setup.tensor(a)
                             for a in (centers, ctx_neg, labels, mask)))
    pairs = {"loss": (torch.tensor(loss), ref_loss.cpu()),
             "center after the step": (model.center, ref.center),
             "context after the step": (model.context, ref.context)}
    return _report("skipgram", setup, loss, _compare("skipgram", pairs, {}),
                   launches, step, timed_steps)


def phase_walks(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 7: node2vec walks (p 0.25, q 2) on the device, the start
    nodes split by rank, each rank drawing from its own generator; the
    gathered walks start at their nodes and follow edges."""
    w, mesh = setup.w, setup.mesh
    ss = np.concatenate([setup.s, setup.r])
    rr = np.concatenate([setup.r, setup.s])
    indptr, indices, weights = csr_from_edges(ss, rr, setup.n)
    tables = build_node2vec_tables(indptr, indices, p=0.25, q=2.0,
                                   weights=weights, device=setup.device)
    n_starts = w["walk_starts"] * mesh.size
    starts = torch.arange(n_starts, device=setup.device) % setup.n
    mine = torch.tensor_split(starts, mesh.size)[mesh.rank]
    gen = rank_generator(setup.seed + 3, mesh.rank, setup.device)
    held = {}

    def step():
        held["walks"] = device_node2vec_walks(gen, mine, w["walk_length"],
                                              tables)
        return 0.0

    _, launches = _counted(step, setup.device)
    walks = all_gather_rows(held["walks"], mesh).cpu().numpy()
    edge_set = set(zip(ss.tolist(), rr.tolist()))
    a, b = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    follows = all((u == v) or ((u, v) in edge_set)
                  for u, v in zip(a.tolist(), b.tolist()))
    ok = (walks.shape == (n_starts, w["walk_length"])
          and (walks[:, 0] == starts.cpu().numpy()).all()
          and (walks >= 0).all() and (walks < setup.n).all() and follows)
    if not ok:
        raise AssertionError(f"dryrun walks: bad walks {walks.shape}")
    return _report("walks", setup, 0.0, {}, launches, step, timed_steps,
                   shape=list(walks.shape))


def _tp_graph_step(phase: str, setup: Setup, family: str, make, weight,
                   salt: int, timed_steps: int) -> dict:
    """A dp × tp step of ``make()`` (GCN or GAT, dropout 0) on the
    tensor-parallel mesh, the data axis a tiled halo partition."""
    tpm = setup.tp_mesh
    dm = tpm.axis("data")
    hg = partition_graph_halo(setup.s, setup.r, setup.n, weight, mesh=dm,
                              tiled_interior=True,
                              min_edges_per_tile=setup.w[
                                  "min_edges_per_tile"])
    x, y = (shard_nodes_halo(setup.feats, hg),
            shard_nodes_halo(setup.labels, hg))
    single = setup.init(make(), salt)
    ref = copy.deepcopy(single)
    model = tensor_parallel(single, tpm, family)
    idx = setup.tensor(setup.train_idx)
    rows = owned_rows(idx, dm.rank, hg.nodes_per_shard)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    ref_graph = build_graph(setup.s, setup.r, setup.n, weight,
                            device=setup.device)
    loss, errs, launches, step = _ce_step(
        phase, setup, model, ref, hg, ref_graph, x, y, rows, idx, opt,
        lambda m, g, xx: m(g, xx), mesh=dm)
    return _report(phase, setup, loss, errs, launches, step, timed_steps,
                   mesh=list(tpm.devices.shape), tiles=hg.n_tiles)


def phase_tp_gcn(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 2: dp × tp GCN, conv1 column-sharded and conv2 row-sharded
    over "model"."""
    w = setup.w
    return _tp_graph_step(
        "tp_gcn", setup, "gcn",
        lambda: GCN(setup.feats.shape[1], hidden=w["gcn_hidden"],
                    num_classes=setup.n_classes, dropout=0.0),
        setup.weight, 7, timed_steps)


def phase_tp_gat(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 2b: dp × tp GAT, attn1's heads split over "model", attn_out
    row-sharded; unit weights."""
    w = setup.w
    return _tp_graph_step(
        "tp_gat", setup, "gat",
        lambda: GAT(setup.feats.shape[1], hidden=w["tp_gat_feat"],
                    num_heads=w["tp_gat_heads"],
                    num_classes=setup.n_classes, dropout=0.0),
        None, 8, timed_steps)


def _gtn_model(setup: Setup, adj, x, labels, sparse: bool):
    kw = dict(in_features=x.shape[1], num_types=adj.shape[0],
              num_classes=int(labels.max()) + 1, channels=2, num_layers=2,
              hidden=setup.w["gtn_hidden"])
    return SparseGTN(**kw) if sparse else GTN(**kw)


def phase_gtn_dense(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 4: the dense GTN with its stack's rows split over the ranks
    (each composition against the all-gathered mixture, the projected
    rows all-gathered once)."""
    mesh = setup.mesh
    adj, feats, labels, train = setup.gtn_stack()
    a, x = gtn_rows(adj, feats, mesh)
    y = shard_rows(labels, mesh)
    single = setup.init(_gtn_model(setup, adj, feats, labels, False), 9)
    ref = copy.deepcopy(single)
    model = tensor_parallel(single, mesh, "gtn")
    idx = setup.tensor(train)
    rows = owned_rows(idx, mesh.rank, a.shape[1])
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    loss, errs, launches, step = _ce_step(
        "gtn_dense", setup, model, ref, a, setup.tensor(adj), x, y, rows,
        idx, opt, lambda m, g, xx: m(g, xx), ref_inputs=(feats, labels))
    return _report("gtn_dense", setup, loss, errs, launches, step,
                   timed_steps, nodes=int(adj.shape[1]),
                   rows_per_rank=int(a.shape[1]))


def phase_gtn_sparse(setup: Setup, timed_steps: int = 0) -> dict:
    """Phase 8: the wedge-plan GTN on a plan sharded by output slot over
    the ranks; every rank computes the whole (replicated) loss, and its
    gradients are the single-device ones without a sum."""
    mesh = setup.mesh
    adj, feats, labels, train = setup.gtn_stack()
    n = adj.shape[1]
    plan = build_gtn_plan(stacked_adj_to_sparse(adj), n, num_layers=2,
                          device=setup.device)
    splan = shard_gtn_plan(plan, mesh)
    splan.warm()
    model = setup.init(_gtn_model(setup, adj, feats, labels, True), 10)
    ref = copy.deepcopy(model)
    x, y = setup.tensor(feats), setup.tensor(labels)
    idx = setup.tensor(train)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    held = {}

    def step():
        opt.zero_grad(set_to_none=True)
        logits = model(splan, x)
        held["logits"] = logits.detach()
        loss = masked_softmax_cross_entropy(logits[idx], y[idx])
        loss.backward()
        opt.step()
        return float(loss.detach())

    ref_logits = ref(plan, x)
    ref_loss = masked_softmax_cross_entropy(ref_logits[idx], y[idx])
    ref_loss.backward()
    loss, launches = _counted(step, setup.device)
    pairs = {"logits": (held["logits"], ref_logits),
             "loss": (torch.tensor(loss), ref_loss.detach().cpu())}
    errs = _compare("gtn_sparse", pairs, _grad_errs(model, ref))
    return _report("gtn_sparse", setup, loss, errs, launches, step,
                   timed_steps, nodes=int(n), nnz=list(plan.nnz),
                   slots=[list(c) for c in splan.slot_cnt],
                   wedges=[list(c) for c in splan.wedge_cnt])


PHASES = {"gcn": phase_gcn, "gat": phase_gat, "han": phase_han,
          "sage": phase_sage, "skipgram": phase_skipgram,
          "walks": phase_walks, "tp_gcn": phase_tp_gcn,
          "tp_gat": phase_tp_gat, "gtn_dense": phase_gtn_dense,
          "gtn_sparse": phase_gtn_sparse}


def dryrun_multichip(mesh: Mesh, *, width: str = "tiny",
                     timed_steps: int = 0, train_epochs: int = 0) -> dict:
    """Run every phase on ``mesh`` (every rank of it calls this); returns
    each phase's report (its ``step`` closure runs one more step)."""
    setup = Setup(mesh, width, SEED)
    out = {}
    for name, phase in PHASES.items():
        kw = dict(timed_steps=timed_steps)
        if name == "gcn":
            kw["train_epochs"] = train_epochs
        out[name] = phase(setup, **kw)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", choices=tuple(WIDTHS), default="tiny")
    args = ap.parse_args(argv)
    initialize_distributed(device=args.device)
    reports = dryrun_multichip(make_mesh(device=args.device),
                               width=args.width)
    if is_primary():
        for rep in reports.values():
            rep.pop("step")
            print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
