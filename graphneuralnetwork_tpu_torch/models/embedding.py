"""The walk embedders end to end, with the reference's defaults.

Port of ``graphneuralnetwork_tpu/models/embedding.py``: each ``run_*``
builds its walks (or, for LINE, neighbour contexts) on the host, turns
them into a padded skip-gram corpus and trains ``SkipGram``/``LINE``
through ``train/embed_loop.py:train_skipgram``; SDNE trains its
autoencoder over dense adjacency rows. Each returns (the node embedding
as a numpy array, the loss history). Every entry point runs on ``cuda``
unless ``device`` says otherwise; the host builders consume the numpy
``rng`` of ``cfg.seed`` in JAX's order, so a CPU run's walks, corpus and
batches are JAX's (DeepWalk's walks and Struc2Vec's distances on the C++
engine, as JAX's).
``device_walks`` draws DeepWalk's, Node2vec's and MetaPath2Vec's walks on
the device from a ``torch.Generator`` instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.hetero import HeteroGraph
from ..data.edgelist import EdgeListData, load_edgelist
from ..nn.embed import LINE, SDNE, SkipGram, sdne_loss_first, sdne_loss_second
from ..sampling.device_neighbor import (build_device_neighbor_table,
                                        device_uniform_walks)
from ..sampling.device_walks import (build_metapath_tables,
                                     build_node2vec_tables,
                                     device_metapath_walks,
                                     device_node2vec_walks)
from ..sampling.skipgram import NegativeSampler, batchify, skipgram_dataset
from ..sampling.struc2vec import Struc2VecWalker, build_multilayer_graph
from ..sampling.walks import (Node2VecWalker, csr_from_edges, metapath_walks,
                              uniform_walks)
from ..train import embed_loop
from ..train.embed_loop import (CapturedEpochs, get_embedding, line_loss,
                                make_adam, make_line_step, train_skipgram)


@dataclass
class WalkEmbedConfig:
    """80 walks of length 10 a node, window 5, 5 negatives, dim 128, Adam
    lr 2e-3, batch 256, 5 epochs; node2vec p 0.25, q 2; subsampling at
    1e-4 (None: off); ``device_walks`` draws the walks on the device."""
    num_walks: int = 80
    walk_length: int = 10
    window: int = 5
    num_negatives: int = 5
    embed_dim: int = 128
    lr: float = 2e-3
    batch_size: int = 256
    epochs: int = 5
    seed: int = 0
    p: float = 0.25
    q: float = 2.0
    subsample_t: float | None = 1e-4
    device_walks: bool = False


def _device_walks(walk, starts: np.ndarray, seed: int, device) -> np.ndarray:
    """``walk(generator, starts)`` on ``device``, from a generator seeded
    with ``seed``, as a numpy array."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return walk(gen, torch.from_numpy(starts).to(device)).cpu().numpy()


def _train_from_walks(walks: np.ndarray, n_nodes: int, cfg: WalkEmbedConfig,
                      device, rng: Optional[np.random.Generator] = None,
                      lr: Optional[float] = None, **dataset_kw):
    """The corpus of ``walks`` (``skipgram_dataset`` with ``dataset_kw``,
    from ``rng`` or a fresh one of ``cfg.seed``) and a SkipGram trained on
    it; (the center table, history)."""
    rng = rng or np.random.default_rng(cfg.seed)
    arrays = skipgram_dataset(
        walks, n_nodes, window=cfg.window, num_negatives=cfg.num_negatives,
        rng=rng, **dataset_kw)
    params, history = train_skipgram(
        SkipGram(n_nodes, cfg.embed_dim), arrays, epochs=cfg.epochs,
        batch_size=cfg.batch_size, lr=cfg.lr if lr is None else lr,
        seed=cfg.seed, device=device)
    return get_embedding(params, "center"), history


def run_deepwalk(data: Optional[EdgeListData] = None,
                 cfg: Optional[WalkEmbedConfig] = None,
                 device: str | torch.device = "cuda"):
    """DeepWalk: uniform walks, skip-gram with subsampling."""
    device = resolve_device(device)
    cfg = cfg or WalkEmbedConfig()
    data = data or load_edgelist(seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers,
                                        data.n_nodes)
    starts = np.tile(np.arange(data.n_nodes), cfg.num_walks)
    if cfg.device_walks:
        table, deg = build_device_neighbor_table(indptr, indices,
                                                 device=device)
        walks = _device_walks(
            lambda g, s: device_uniform_walks(g, s, cfg.walk_length, table,
                                              deg),
            starts, cfg.seed, device)
    else:
        walks = uniform_walks(indptr, indices, starts, cfg.walk_length, rng)
    return _train_from_walks(walks, data.n_nodes, cfg, device,
                             subsample_t=cfg.subsample_t)


def run_node2vec(data: Optional[EdgeListData] = None,
                 cfg: Optional[WalkEmbedConfig] = None,
                 device: str | torch.device = "cuda"):
    """Node2vec: p/q-biased second-order walks."""
    device = resolve_device(device)
    cfg = cfg or WalkEmbedConfig()
    data = data or load_edgelist(seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    indptr, indices, w = csr_from_edges(
        data.senders, data.receivers, data.n_nodes, data.weights)
    starts = np.tile(np.arange(data.n_nodes), cfg.num_walks)
    if cfg.device_walks:
        tables = build_node2vec_tables(indptr, indices, p=cfg.p, q=cfg.q,
                                       weights=w, device=device)
        walks = _device_walks(
            lambda g, s: device_node2vec_walks(g, s, cfg.walk_length,
                                               tables),
            starts, cfg.seed, device)
    else:
        walker = Node2VecWalker(indptr, indices, p=cfg.p, q=cfg.q,
                                weights=w)
        walks = walker.walk(starts, cfg.walk_length, rng)
    return _train_from_walks(walks, data.n_nodes, cfg, device,
                             subsample_t=cfg.subsample_t)


def run_struc2vec(data: Optional[EdgeListData] = None,
                  cfg: Optional[WalkEmbedConfig] = None,
                  k_max: int = 3, stay_prob: float = 0.3,
                  device: str | torch.device = "cuda"):
    """Struc2Vec: walks over the structural multilayer graph; skip-gram
    without subsampling, its corpus from the walks' own ``rng``."""
    device = resolve_device(device)
    cfg = cfg or WalkEmbedConfig()
    data = data or load_edgelist(seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers,
                                        data.n_nodes)
    layers = build_multilayer_graph(indptr, indices, data.n_nodes,
                                    k_max=k_max)
    walker = Struc2VecWalker(layers, stay_prob=stay_prob)
    starts = np.tile(np.arange(data.n_nodes), cfg.num_walks)
    walks = walker.walk(starts, cfg.walk_length, rng)
    return _train_from_walks(walks, data.n_nodes, cfg, device, rng=rng,
                             subsample_t=None)


@dataclass
class LINEConfig:
    """dim 128, 5 negatives, batch 32, Adam lr 2e-3, 5 epochs."""
    embed_dim: int = 128
    num_negatives: int = 5
    batch_size: int = 32
    lr: float = 2e-3
    epochs: int = 5
    seed: int = 0


def pagerank(indptr: np.ndarray, indices: np.ndarray, n: int,
             iters: int = 30) -> np.ndarray:
    """Power-iteration PageRank (damping 0.85) scaled to mean ~1."""
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    out_deg = np.maximum(deg, 1)
    src = np.repeat(np.arange(n), indptr[1:] - indptr[:-1])
    for _ in range(iters):
        nxt = np.zeros(n)
        np.add.at(nxt, indices, (pr / out_deg)[src])
        pr = 0.15 / n + 0.85 * nxt
    return pr * n


def line_corpus(indptr: np.ndarray, indices: np.ndarray, n: int,
                num_negatives: int, rng: np.random.Generator):
    """LINE's batchified corpus: every node a center, its neighbours
    (padded to the largest degree) its contexts, ``num_negatives`` degree
    ^0.75 negatives per context."""
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    max_deg = int(deg.max())
    contexts = np.full((n, max_deg), -1, np.int64)
    for v in range(n):
        nb = indices[indptr[v]:indptr[v + 1]]
        contexts[v, :len(nb)] = nb
    sampler = NegativeSampler(np.maximum(deg, 1))
    K = num_negatives * max_deg
    negs = sampler.draw((n, K), rng)
    keep = np.arange(K)[None, :] < (num_negatives * deg)[:, None]
    return batchify(np.arange(n, dtype=np.int64), contexts,
                    np.where(keep, negs, -1))


def run_line(data: Optional[EdgeListData] = None,
             cfg: Optional[LINEConfig] = None,
             device: str | torch.device = "cuda"):
    """LINE: neighbours as contexts (no walks), degree^0.75 negatives,
    the second-order loss weighted by each center's PageRank."""
    device = resolve_device(device)
    cfg = cfg or LINEConfig()
    data = data or load_edgelist(seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    n = data.n_nodes
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, n)
    pr = pagerank(indptr, indices, n)
    arrays = line_corpus(indptr, indices, n, cfg.num_negatives, rng)
    params, history = train_skipgram(
        LINE(n, cfg.embed_dim), arrays, epochs=cfg.epochs,
        batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed,
        step_fn_factory=make_line_step,
        extra_batch_arrays=(pr.astype(np.float32),),
        device_loss_fn=line_loss, device=device)
    return get_embedding(params, "vertex"), history


@dataclass
class SDNEConfig:
    """hidden (256, 128), alpha 1e-6, beta 5, AdamW lr 2e-3 with weight
    decay 1e-4, batch 32, 10 epochs."""
    hidden_dims: Tuple[int, ...] = (256, 128)
    alpha: float = 1e-6
    beta: float = 5.0
    weight_decay: float = 1e-4
    batch_size: int = 32
    lr: float = 2e-3
    epochs: int = 10
    seed: int = 0


def sdne_step(model: SDNE, optimizer, cfg: SDNEConfig, rows: torch.Tensor,
              sub_a: torch.Tensor) -> torch.Tensor:
    """One AdamW step on SDNE's loss for the adjacency ``rows`` of a batch
    and its sub-matrix ``sub_a`` (L = D - A on the batch's sub-graph);
    returns the loss."""
    sub_l = torch.diag(sub_a.sum(1)) - sub_a
    optimizer.zero_grad(set_to_none=True)
    y, x_hat = model(rows)
    loss = (sdne_loss_first(y, sub_l, cfg.alpha)
            + sdne_loss_second(x_hat, rows, cfg.beta))
    loss.backward()
    optimizer.step()
    return loss.detach()


def sdne_epochs(model: SDNE, optimizer, cfg: SDNEConfig,
                a: torch.Tensor) -> CapturedEpochs:
    """SDNE's device loop: ``a`` [N, N] stays on the device, each step
    gathers its batch rows and their [B, B] sub-matrix there; the
    permutation comes from a generator seeded with ``cfg.seed ^ 0x50E``."""
    def step(sel):
        rows = a[sel]
        return sdne_step(model, optimizer, cfg, rows, rows[:, sel])[None]

    gen = torch.Generator(device=a.device).manual_seed(cfg.seed ^ 0x50E)
    return CapturedEpochs(step, a.shape[0], cfg.batch_size, 1, optimizer,
                          gen, a.device)


def sdne_model(n: int, cfg: SDNEConfig, device: torch.device):
    """SDNE initialised from ``cfg.seed`` on ``device`` and its AdamW."""
    model = SDNE(n, cfg.hidden_dims)
    embed_loop._init_params(model, cfg.seed)
    model.to(device)
    return model, make_adam(model.parameters(), cfg.lr, device,
                            weight_decay=cfg.weight_decay)


def run_sdne(data: Optional[EdgeListData] = None,
             cfg: Optional[SDNEConfig] = None,
             device: str | torch.device = "cuda"):
    """SDNE: reconstruct adjacency rows (beta-weighted) with a Laplacian
    smoothness penalty over each batch's sub-graph. On CUDA the device
    loop (``sdne_epochs``); elsewhere the host loop, shuffled by the numpy
    ``rng``. Returns (the embedding Y of every row, [(epoch, mean
    loss)])."""
    device = resolve_device(device)
    cfg = cfg or SDNEConfig()
    data = data or load_edgelist(seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    n = data.n_nodes
    a = np.zeros((n, n), np.float32)
    a[data.senders, data.receivers] = data.weights
    model, opt = sdne_model(n, cfg, device)
    a_dev = torch.from_numpy(a).to(device)
    bs = cfg.batch_size
    history = []
    if device.type == "cuda" and n >= bs:
        loop = sdne_epochs(model, opt, cfg, a_dev)
        for epoch in range(1, cfg.epochs + 1):
            history.append((epoch, float(loop.run().astype(
                np.float64).mean())))
    else:
        idx = np.arange(n)
        for epoch in range(1, cfg.epochs + 1):
            rng.shuffle(idx)
            losses = []
            for i in range(0, n - bs + 1, bs):
                sel = torch.from_numpy(idx[i:i + bs]).to(device)
                rows = a_dev[sel]
                losses.append(sdne_step(model, opt, cfg, rows,
                                        rows[:, sel]))
            total = (float(torch.stack(losses).double().sum())
                     if losses else 0.0)
            history.append((epoch, total / max(len(losses), 1)))
    with torch.no_grad():
        y, _ = model(a_dev)
    return y.cpu().numpy(), history


def synthetic_user_item(seed: int, n_users: int = 200, n_items: int = 150,
                        n_edges: int = 2000):
    """The default MetaPath2Vec graph: random user-item edges and their
    reverse, the U-I-U metapath and the type offsets (users first)."""
    rng0 = np.random.default_rng(seed)
    u = rng0.integers(0, n_users, n_edges)
    i = rng0.integers(0, n_items, n_edges)
    hetero = HeteroGraph({"u": n_users, "i": n_items})
    hetero.add_relation(("u", "ui", "i"), u, i)
    hetero.add_relation(("i", "iu", "u"), i, u)
    return (hetero, [("u", "ui", "i"), ("i", "iu", "u")],
            {"u": 0, "i": n_users})


def run_metapath2vec(hetero=None, metapath=None, type_offsets=None,
                     cfg: Optional[WalkEmbedConfig] = None,
                     typed_negatives: bool = True,
                     device: str | torch.device = "cuda"):
    """MetaPath2Vec: metapath-constrained walks (U-I-U-I-... on the
    synthetic user-item graph by default) mapped to one global id space by
    ``type_offsets``, typed alternating negatives for two node types, Adam
    at min(lr, 0.05)."""
    device = resolve_device(device)
    cfg = cfg or WalkEmbedConfig(window=4, num_negatives=4,
                                 batch_size=512, lr=0.4)
    if hetero is None:
        hetero, metapath, type_offsets = synthetic_user_item(cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    start_type = metapath[0][0]
    starts = np.tile(np.arange(hetero.node_counts[start_type]),
                     cfg.num_walks)
    if cfg.device_walks:
        legs = build_metapath_tables(hetero, metapath, device=device)
        walks_local = _device_walks(
            lambda g, s: device_metapath_walks(g, s, cfg.walk_length, legs),
            starts, cfg.seed, device)
    else:
        walks_local = metapath_walks(hetero, metapath, starts,
                                     cfg.walk_length, rng)
    # position t > 0 holds the type metapath[(t - 1) % L][2]
    L = len(metapath)
    types = [start_type] + [metapath[(t - 1) % L][2]
                            for t in range(1, cfg.walk_length)]
    offs = np.array([type_offsets[t] for t in types], np.int64)
    walks = walks_local.astype(np.int64) + offs[None, :]
    n_total = sum(hetero.node_counts[t] for t in type_offsets)
    token_types = None
    if typed_negatives and len(type_offsets) == 2:
        second_off = sorted(type_offsets.values())[1]
        token_types = (np.arange(n_total) >= second_off).astype(np.int64)
    # subsampled at skipgram_dataset's default, as in JAX
    return _train_from_walks(walks, n_total, cfg, device, rng=rng,
                             lr=min(cfg.lr, 0.05), token_types=token_types)
