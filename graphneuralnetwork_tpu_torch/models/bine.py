"""BiNE: bipartite network embedding, end to end.

Port of ``graphneuralnetwork_tpu/models/bine.py``. The pipeline follows
BiNE/run.py:4-33 and train_eval.py:16-88: HITS centrality on the
bipartite graph, centrality-proportional truncated walks on its two
homogeneous projections, and the joint loss

    L = alpha * o1(explicit) + beta * o2(u implicit) + gamma * o3(v implicit)

with o1 the weight-scaled BCE of the rated edges and o2/o3 masked
skip-gram BCE terms (train_eval.py:60-63), trained with AdamW at optax's
defaults. Defaults: dim 128, alpha = beta = 0.01, gamma 0.1, max_t 32,
min_t 1, p_stop 0.15, window 5, 4 negatives, lr 1e-2.

The host draws the synthetic ratings, the walks, the skip-gram corpora and
every batch from the numpy ``rng`` of ``cfg.seed`` in JAX's order. Each
batch is one eager step on the device, as JAX runs one jitted step a
batch; the loss is read on the host once an epoch, or at every step when
``cfg.logdir`` asks for its three terms. The initial tables come from a
``torch.Generator`` seeded with ``cfg.seed`` (``_init_params``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.hetero import BipartiteGraph
from ..sampling.skipgram import minibatches, skipgram_dataset
from ..sampling.walks import bine_walks, csr_from_edges
from ..train.embed_loop import _host_tensor, make_adam, spread_padding
from ..train.linkpred import link_prediction_metrics
from ..train.metrics import sigmoid_binary_cross_entropy


@dataclass
class BiNEConfig:
    embed_dim: int = 128
    alpha: float = 0.01
    beta: float = 0.01
    gamma: float = 0.1
    max_t: int = 32
    min_t: int = 1
    p_stop: float = 0.15
    percent: float = 0.15
    window: int = 5
    num_negatives: int = 4
    batch_size: int = 128
    lr: float = 1e-2
    epochs: int = 5
    seed: int = 0
    logdir: Optional[str] = None  # TensorBoard dir (BiNE train_eval.py:41)


def hits_centrality(u, v, n_users: int, n_items: int,
                    iters: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Power-iteration HITS on the bipartite adjacency (replaces
    networkx.hits at BiNE/utils/graph_utils.py:178)."""
    hub = np.ones(n_users)
    for _ in range(iters):
        auth = np.zeros(n_items)
        np.add.at(auth, v, hub[u])
        auth /= max(np.linalg.norm(auth), 1e-12)
        hub = np.zeros(n_users)
        np.add.at(hub, u, auth[v])
        hub /= max(np.linalg.norm(hub), 1e-12)
    return hub, auth


def _side_dataset(bg: BipartiteGraph, side: str, centrality,
                  cfg: BiNEConfig, rng):
    """The skip-gram corpus (centers, ctx_neg, labels, mask) of one side:
    ``bine_walks`` on its 2-hop projection, padded -1 into a matrix, no
    subsampling (BiNE keeps every token)."""
    g = bg.homogeneous_projection(side, device="cpu")
    s = g.senders[: g.n_edges].numpy()
    r = g.receivers[: g.n_edges].numpy()
    w = g.edge_weight[: g.n_edges].numpy()
    n = bg.node_counts[side]
    indptr, indices, ws = csr_from_edges(s, r, n, w)
    walks = bine_walks(indptr, indices, ws, centrality, rng,
                       percent=cfg.percent, max_t=cfg.max_t,
                       min_t=cfg.min_t, p_stop=cfg.p_stop)
    max_len = max((len(wk) for wk in walks), default=1)
    mat = np.full((len(walks), max(max_len, 2)), -1, np.int64)
    for i, wk in enumerate(walks):
        mat[i, :len(wk)] = wk
    return skipgram_dataset(
        mat, n, window=cfg.window, num_negatives=cfg.num_negatives,
        rng=rng, subsample_t=None)


def synthetic_ratings(rng: np.random.Generator):
    """The default data: 150 users and 120 items in 6 communities, 1,500
    ratings in [1, 5) (85 % inside the user's community), a tenth held
    out as true test edges beside as many random false ones. Returns
    (the training ``BipartiteGraph``, ((tu, tv), (fu, fv)))."""
    nu, nv, n_comm = 150, 120, 6
    cu = rng.integers(0, n_comm, nu)
    cv = rng.integers(0, n_comm, nv)
    u = rng.integers(0, nu, 1500).astype(np.int32)
    v = np.empty(1500, np.int32)
    for i in range(1500):
        if rng.random() < 0.85:
            pool = np.flatnonzero(cv == cu[u[i]])
            v[i] = pool[rng.integers(0, len(pool))] if len(pool) else \
                rng.integers(0, nv)
        else:
            v[i] = rng.integers(0, nv)
    w = rng.random(1500).astype(np.float32) * 4 + 1
    k = len(u)
    hold = rng.permutation(k)[: k // 10]
    keep = np.setdiff1d(np.arange(k), hold)
    bg = BipartiteGraph(nu, nv, u[keep], v[keep], w[keep])
    fu = rng.integers(0, nu, len(hold)).astype(np.int32)
    fv = rng.integers(0, nv, len(hold)).astype(np.int32)
    return bg, ((u[hold], v[hold]), (fu, fv))


class BiNETables(nn.Module):
    """The user and item tables ``U``, ``V`` and their context tables
    ``Cu``, ``Cv``, each normal(0.01) [count, embed_dim] (JAX's names)."""

    def __init__(self, n_users: int, n_items: int, embed_dim: int):
        super().__init__()
        for name, n in (("U", n_users), ("V", n_items), ("Cu", n_users),
                        ("Cv", n_items)):
            self.register_parameter(
                name, nn.Parameter(torch.empty(n, embed_dim)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for p in self.parameters():
                p.normal_(0.0, 0.01, generator=generator)


def _init_params(tables: BiNETables, seed: int) -> None:
    """The initial tables, from a CPU generator seeded with ``seed`` (the
    tests replace this with JAX's initial tables)."""
    tables.reset_parameters(torch.Generator().manual_seed(seed))


def _skipgram_term(center_tab, ctx_tab, c, cn, labels, mask):
    """The masked BCE of center . context over every valid slot of the
    batch, divided by their count."""
    logits = torch.einsum("bd,bld->bl", center_tab[c], ctx_tab[cn])
    ls = sigmoid_binary_cross_entropy(logits, labels)
    return torch.sum(ls * mask) / torch.clamp_min(mask.sum(), 1.0)


def bine_loss(tables: BiNETables, cfg: BiNEConfig, batch):
    """(alpha * o1 + beta * o2 + gamma * o3, [o1, o2, o3]) of one batch:
    (e_u, e_v, e_w) rated edges, then the u side's and the v side's
    skip-gram rows (centers, ctx_neg, labels, mask)."""
    (e_u, e_v, e_w, cu, cnu, lu, mu, cv, cnv, lv, mv) = batch
    # o1: explicit relations, weighted BCE on u . v
    # (BiNE/train_eval.py:16-24)
    logit = torch.sum(tables.U[e_u] * tables.V[e_v], dim=-1)
    o1 = torch.mean(e_w * sigmoid_binary_cross_entropy(
        logit, torch.ones_like(logit)))
    o2 = _skipgram_term(tables.U, tables.Cu, cu, cnu, lu, mu)
    o3 = _skipgram_term(tables.V, tables.Cv, cv, cnv, lv, mv)
    total = cfg.alpha * o1 + cfg.beta * o2 + cfg.gamma * o3
    return total, torch.stack([o1, o2, o3])


def bine_step(tables: BiNETables, optimizer, cfg: BiNEConfig, batch):
    """One AdamW step on ``bine_loss``; returns (loss, terms), detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, terms = bine_loss(tables, cfg, batch)
    loss.backward()
    optimizer.step()
    return loss.detach(), terms.detach()


def batch_to_device(batch, n_users: int, n_items: int,
                    device: torch.device) -> tuple:
    """A host batch on ``device`` (ids int64, the rest float32), the
    padded context slots of each side spread over its vocabulary
    (``spread_padding``: their terms are masked out either way)."""
    out = [_host_tensor(a).to(device) for a in batch]
    out[4] = spread_padding(out[4], out[6], n_users)
    out[8] = spread_padding(out[8], out[10], n_items)
    return tuple(out)


def bine_batches(edges, du, dv, batch_size: int,
                 rng: np.random.Generator):
    """One epoch's host batches in JAX's draw order: a shuffled pass over
    the rated edges, each batch joined by the next batch of each side's
    corpus, a side's pass restarted (reshuffled) when it runs out."""
    it_u = minibatches(du, batch_size, rng)
    it_v = minibatches(dv, batch_size, rng)
    for be in minibatches(edges, batch_size, rng):
        try:
            bu = next(it_u)
        except StopIteration:
            it_u = minibatches(du, batch_size, rng)
            bu = next(it_u)
        try:
            bv = next(it_v)
        except StopIteration:
            it_v = minibatches(dv, batch_size, rng)
            bv = next(it_v)
        yield be + bu + bv


def train_bine(bg: Optional[BipartiteGraph] = None,
               test_edges=None,
               cfg: Optional[BiNEConfig] = None, verbose: bool = False,
               device: str | torch.device = "cuda"):
    """BiNE on ``bg`` (the synthetic ratings by default, with their test
    edges). Returns (the tables by name, on ``device``; history [(epoch,
    mean loss)]; link-prediction metrics of ``test_edges`` on [U; V], or
    None)."""
    cfg = cfg or BiNEConfig()
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    if bg is None:
        bg, test_edges = synthetic_ratings(rng)
    nu, nv = bg.node_counts["u"], bg.node_counts["v"]
    eu, ev, ew = bg.relations[("u", "rate", "v")]
    hub, auth = hits_centrality(eu, ev, nu, nv)
    du = _side_dataset(bg, "u", hub, cfg, rng)
    dv = _side_dataset(bg, "v", auth, cfg, rng)

    tables = BiNETables(nu, nv, cfg.embed_dim)
    _init_params(tables, cfg.seed)
    tables.to(device)
    optimizer = make_adam(tables.parameters(), cfg.lr, device,
                          weight_decay=1e-4)
    # per-term logging, the reference's three add_scalar calls
    # (BiNE/train_utils/train_eval.py:75-77)
    writer = None
    if cfg.logdir is not None:
        from ..utils.tb import SummaryWriter
        writer = SummaryWriter(cfg.logdir)

    history, gstep = [], 0
    t0 = time.perf_counter()
    for epoch in range(1, cfg.epochs + 1):
        losses = []
        for batch in bine_batches((eu, ev, ew), du, dv, cfg.batch_size, rng):
            loss, terms = bine_step(tables, optimizer, cfg,
                                    batch_to_device(batch, nu, nv, device))
            losses.append(loss)
            gstep += 1
            if writer is not None:
                o1, o2, o3 = terms.tolist()
                writer.add_scalar("loss/o1_explicit", o1, global_step=gstep)
                writer.add_scalar("loss/o2_implicit_u", o2,
                                  global_step=gstep)
                writer.add_scalar("loss/o3_implicit_v", o3,
                                  global_step=gstep)
        total = float(torch.stack(losses).double().sum()) if losses else 0.0
        history.append((epoch, total / max(len(losses), 1)))
        if verbose:
            print(f"epoch {epoch}: loss {history[-1][1]:.5f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    if writer is not None:
        writer.close()

    metrics = None
    if test_edges is not None:
        (tu, tv), (fu, fv) = test_edges
        emb_all = torch.cat([tables.U, tables.V]).detach().cpu().numpy()
        metrics = link_prediction_metrics(
            emb_all, (tu, tv + nu), (fu, fv + nu))
    return ({k: v.detach().clone() for k, v in tables.state_dict().items()},
            history, metrics)
