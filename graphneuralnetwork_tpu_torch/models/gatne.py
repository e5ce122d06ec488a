"""GATNE end to end (multiplex heterogeneous link prediction).

Port of ``graphneuralnetwork_tpu/models/gatne.py``. The pipeline follows
GATNE/run.py:58-66: per-type walks, window pairs tagged with their edge
type, per-type sampled neighbour tables, the ``nn.embed.GATNE`` encoder
trained on a sampled-negative skip-gram loss (``nsloss``, Adam) or on
padded context and negative rows scored against a decoder table
(``masked_bce``, AdamW), and a per-epoch cosine link-prediction
evaluation of every node under every edge type (``evaluate_gatne``).

The host builds everything from the numpy ``rng`` of ``cfg.seed`` in JAX's
order, draw for draw (the walks on the C++ engine, as JAX's). Training
takes one of JAX's two loops:

  * the host loop (the CPU's, as JAX's CPU backend runs it): each epoch
    shuffles the pairs (``minibatches``) and draws each batch's negatives
    as it goes;
  * the device loop (the card's default, JAX's ``lax.scan`` loop): the
    host draws the epoch's permutation and all of its negatives in one go,
    copies them to the device once an epoch, and ``HostDrawnEpochs``
    steps through them, on the card one captured step replayed per batch.

Both read the loss on the host once an epoch. The initial parameters come
from a ``torch.Generator`` seeded with ``cfg.seed`` (``_init_params``;
JAX's come from ``jax.random``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..data.edgelist import MultiplexData, load_multiplex
from ..nn.embed import GATNE
from ..sampling.neighbor import _take
from ..sampling.skipgram import (NegativeSampler, batchify,
                                 centers_and_contexts, minibatches)
from ..sampling.walks import csr_from_edges, uniform_walks
from ..train.embed_loop import (HostDrawnEpochs, _params, _to_device,
                                _update, make_adam, spread_padding)
from ..train.linkpred import link_prediction_metrics
from ..train.metrics import masked_sigmoid_bce


@dataclass
class GATNEConfig:
    """Defaults of GATNE/run.py:15-53 but for dim 64 (the reference's 200)
    and Adam at 1e-2 (the reference's SGD at 0.4)."""
    embed_dim: int = 64
    edge_embed_dim: int = 16
    attn_dim: int = 32
    num_walks: int = 10
    walk_length: int = 10
    window: int = 5
    num_negatives: int = 5
    neighbor_samples: int = 10
    batch_size: int = 512
    lr: float = 1e-2
    epochs: int = 5
    seed: int = 0
    inductive: bool = False   # GATNE-I uses node features
    # Negative distribution: 'log_uniform' is the reference NSLoss Zipfian
    # over frequency rank (GATNE/train_utils/loss_utils.py:14-22);
    # 'frequency' is freq^0.75 skip-gram style.
    negative_sampling: str = "log_uniform"
    # v1/v2 neighbor aggregation (GATNE_Pytorch/models/GATNE.py:72-77)
    aggregator: str = "mean"
    # 'nsloss' = v1 sampled-negative skip-gram
    # (GATNE/train_utils/loss_utils.py:7-42); 'masked_bce' = v2 padded
    # context+negative rows scored against a decoder table under per-row
    # masked BCE (GATNE_Pytorch/models/GATNE.py:100-114).
    loss: str = "nsloss"
    # Walk-corpus cache dir: one .npz, the file and keys of JAX's
    cache_dir: Optional[str] = None


def build_neighbor_tables(data: MultiplexData, samples: int,
                          rng: np.random.Generator) -> np.ndarray:
    """[N, T, S] per-type sampled neighbors with resampling; isolated nodes
    self-fill (GATNE/utils/data_utils.py:127-146). An isolated node at the
    end of the CSR does not read past ``indices`` (JAX's numpy raises
    there)."""
    n, T = data.n_nodes, len(data.edge_types)
    out = np.empty((n, T, samples), np.int32)
    for t, ty in enumerate(data.edge_types):
        s, r = data.train_edges[ty]
        ss = np.concatenate([s, r])
        rr = np.concatenate([r, s])
        indptr, indices, _ = csr_from_edges(ss, rr, n)
        deg = indptr[1:] - indptr[:-1]
        off = (rng.random((n, samples)) *
               np.maximum(deg, 1)[:, None]).astype(np.int64)
        nb = _take(indices, indptr[:-1][:, None] + off)
        self_rep = np.broadcast_to(
            np.arange(n, dtype=np.int32)[:, None], nb.shape)
        out[:, t, :] = np.where(deg[:, None] > 0, nb, self_rep)
    return out


def _generate_walks(data: MultiplexData, cfg: GATNEConfig,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Per-type uniform walks from every node with an edge of the type,
    persisted to ``cfg.cache_dir`` so that reruns skip them (the
    reference's train_walks.txt, GATNE/utils/data_utils.py:171-207), as
    one ``walks_w{num_walks}_l{walk_length}_s{seed}.npz`` keyed by edge
    type: JAX's file reads here unchanged, and the other way round."""
    cache = None
    if cfg.cache_dir is not None:
        os.makedirs(cfg.cache_dir, exist_ok=True)
        cache = os.path.join(
            cfg.cache_dir,
            f"walks_w{cfg.num_walks}_l{cfg.walk_length}_s{cfg.seed}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return {ty: z[ty] for ty in data.edge_types}
    out = {}
    for ty in data.edge_types:
        s, r = data.train_edges[ty]
        ss = np.concatenate([s, r])
        rr = np.concatenate([r, s])
        indptr, indices, _ = csr_from_edges(ss, rr, data.n_nodes)
        nodes = np.unique(ss)
        starts = np.tile(nodes, cfg.num_walks)
        out[ty] = uniform_walks(indptr, indices, starts, cfg.walk_length,
                                rng)
    if cache is not None:
        tmp = cache + ".tmp.npz"
        np.savez_compressed(tmp, **out)
        os.replace(tmp, cache)
    return out


def generate_pairs(data: MultiplexData, cfg: GATNEConfig,
                   rng: np.random.Generator):
    """Per-type walks -> (center, context, type) triples, int32
    (GATNE/utils/data_utils.py:89-124)."""
    centers, contexts, types = [], [], []
    all_walks = _generate_walks(data, cfg, rng)
    for t, ty in enumerate(data.edge_types):
        walks = all_walks[ty]
        c, ctx = centers_and_contexts(walks.astype(np.int64),
                                      cfg.window, rng)
        for k in range(ctx.shape[1]):
            valid = ctx[:, k] >= 0
            centers.append(c[valid])
            contexts.append(ctx[valid, k])
            types.append(np.full(valid.sum(), t, np.int32))
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(contexts).astype(np.int32),
            np.concatenate(types))


def generate_padded_pairs(data: MultiplexData, cfg: GATNEConfig,
                          rng: np.random.Generator):
    """Per-type walks -> (centers [P], types [P], contexts [P, 2 * window]
    padded -1) for the masked-BCE loss (Collate_fn's ragged context lists,
    GATNE_Pytorch/utils/data_utils.py:168-188)."""
    centers, types, contexts = [], [], []
    all_walks = _generate_walks(data, cfg, rng)
    for t, ty in enumerate(data.edge_types):
        walks = all_walks[ty]
        c, ctx = centers_and_contexts(walks.astype(np.int64),
                                      cfg.window, rng)
        keep = (ctx >= 0).any(axis=1)
        centers.append(c[keep])
        contexts.append(ctx[keep])
        types.append(np.full(keep.sum(), t, np.int32))
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(types),
            np.concatenate(contexts).astype(np.int32))


class GATNEParams(nn.Module):
    """What GATNE trains: the encoder ``model`` and its output table,
    ``ctx`` (``nsloss``: normal(0.01)) or ``decoder`` (``masked_bce``:
    Xavier uniform), [N, embed_dim]. The names are those of JAX's
    ``{"model": ..., "ctx"|"decoder": ...}`` tree, so that
    ``params.from_flax`` of it loads here. GATNE-I's node features ride
    along as a buffer outside the state dict."""

    def __init__(self, data: MultiplexData, cfg: GATNEConfig):
        super().__init__()
        inductive = cfg.inductive and data.features is not None
        self.model = GATNE(
            data.n_nodes, len(data.edge_types), embed_dim=cfg.embed_dim,
            edge_embed_dim=cfg.edge_embed_dim, attn_dim=cfg.attn_dim,
            inductive=inductive,
            feature_dim=data.features.shape[1] if inductive else None,
            aggregator=cfg.aggregator)
        self.table_name = "decoder" if cfg.loss == "masked_bce" else "ctx"
        self.register_parameter(self.table_name, nn.Parameter(
            torch.empty(data.n_nodes, cfg.embed_dim)))
        self.register_buffer(
            "features", torch.from_numpy(data.features) if inductive
            else None, persistent=False)
        self.reset_parameters()

    def table(self) -> torch.Tensor:
        return getattr(self, self.table_name)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.model.reset_parameters(generator)
        n, d = self.table().shape
        with torch.no_grad():
            if self.table_name == "ctx":
                self.table().normal_(0.0, 0.01, generator=generator)
            else:
                lim = float(np.sqrt(6.0 / (n + d)))
                self.table().uniform_(-lim, lim, generator=generator)

    def encode(self, centers, edge_type, neighbors) -> torch.Tensor:
        return self.model(centers, edge_type, neighbors, self.features)


def _init_params(params: GATNEParams, seed: int) -> None:
    """The initial parameters, from a CPU generator seeded with ``seed``
    (the tests replace this with JAX's initial parameters)."""
    params.reset_parameters(torch.Generator().manual_seed(seed))


def nsloss(params: GATNEParams, centers, contexts, types, negs,
           neighbors) -> torch.Tensor:
    """The mean over the batch of -log s(e . ctx[context]) - sum_k
    log s(-e . ctx[neg_k]) (NSLoss, GATNE/train_utils/loss_utils.py:7-42),
    e the center's embedding under its type."""
    emb = params.encode(centers, types, neighbors)            # [B, D]
    pos_e = params.ctx[contexts.long()]                       # [B, D]
    neg_e = params.ctx[negs.long()]                           # [B, K, D]
    pos_logit = torch.sum(emb * pos_e, dim=-1)
    neg_logit = torch.einsum("bd,bkd->bk", emb, neg_e)
    return (-F.logsigmoid(pos_logit)
            - F.logsigmoid(-neg_logit).sum(-1)).mean()


def masked_bce(params: GATNEParams, centers, types, ctx_neg, labels, mask,
               neighbors) -> torch.Tensor:
    """Per-row masked BCE of e . decoder[slot] over a padded row of
    contexts and negatives, averaged over the rows (the reference's
    loss(pred, labels, masks) / masks.sum(1) * masks.shape[1], per row).
    The padded slots' ids may be anything (``spread_padding``): their
    terms are masked out."""
    emb = params.encode(centers, types, neighbors)            # [B, D]
    w = params.decoder[ctx_neg.long()]                        # [B, L, D]
    return masked_sigmoid_bce(torch.einsum("bd,bld->bl", emb, w), labels,
                              mask)


def make_step(params: GATNEParams, optimizer, loss_fn: Callable,
              neighbors: torch.Tensor) -> Callable[..., torch.Tensor]:
    """``step(centers, *rest) -> loss``: one optimizer step on
    ``loss_fn(params, centers, *rest, neighbors[centers])``."""
    def step(centers, *rest):
        loss = loss_fn(params, centers, *rest, neighbors[centers.long()])
        _update(optimizer, loss)
        return loss.detach()

    return step


def _nsloss_sampler(centers, contexts, n_nodes: int,
                    cfg: GATNEConfig) -> NegativeSampler:
    """NSLoss's negatives: the reference's Zipfian over frequency rank,
    P(k) ~ log(k + 2) - log(k + 1) (GATNE/train_utils/loss_utils.py:14-22;
    ranked by the corpus frequency), or frequency^0.75."""
    freq = np.bincount(np.concatenate([centers, contexts]),
                       minlength=n_nodes)
    if cfg.negative_sampling != "log_uniform":
        return NegativeSampler(np.maximum(freq, 1))
    rank = np.empty(n_nodes, np.int64)
    rank[np.argsort(-freq, kind="stable")] = np.arange(n_nodes)
    k = rank.astype(np.float64)
    w = (np.log(k + 2) - np.log(k + 1)) / np.log(n_nodes + 1)
    return NegativeSampler(w, power=1.0)


class _Batches:
    """One loss's host side: ``epoch(rng, nb)`` the device loop's arrays
    of an epoch (its first ``nb * batch_size`` shuffled rows, negatives
    drawn for all of them at once), ``batches(rng)`` the host loop's
    batches; each a tuple (centers, *rest) in the loss's argument order,
    padded ids spread over the vocabulary."""

    def __init__(self, data: MultiplexData, cfg: GATNEConfig,
                 rng: np.random.Generator):
        self.cfg, self.n = cfg, data.n_nodes
        if cfg.loss == "masked_bce":
            self.rows = generate_padded_pairs(data, cfg, rng)
            centers, _, contexts = self.rows
            freq = np.bincount(
                np.concatenate([centers, contexts[contexts >= 0]]),
                minlength=self.n)
            self.sampler = NegativeSampler(np.maximum(freq, 1))
            self.k = cfg.num_negatives * contexts.shape[1]
        else:
            self.rows = generate_pairs(data, cfg, rng)
            self.sampler = _nsloss_sampler(self.rows[0], self.rows[1],
                                           self.n, cfg)

    def __len__(self) -> int:
        return len(self.rows[0])

    def _finish(self, rows, rng) -> tuple:
        if self.cfg.loss != "masked_bce":
            c, ctx, ty = rows
            negs = self.sampler.draw((len(c), self.cfg.num_negatives), rng,
                                     exclude=ctx[:, None])
            return c, ctx, ty, negs.astype(np.int32)
        c, ty, ctx = rows
        # num_negatives per valid context (the reference draws
        # len(context) * num_negatives per center,
        # utils/data_utils.py:104-151); the rest pad to -1 and are masked
        negs = self.sampler.draw((len(c), self.k), rng).astype(np.int64)
        n_ctx = (ctx >= 0).sum(1)
        slot = np.arange(self.k)[None, :]
        negs = np.where(slot < (n_ctx * self.cfg.num_negatives)[:, None],
                        negs, -1)
        cc, ctx_neg, labels, mask = batchify(c, ctx, negs)
        ctx_neg = spread_padding(torch.from_numpy(ctx_neg.astype(np.int64)),
                                 torch.from_numpy(mask), self.n).numpy()
        return cc, ty, ctx_neg, labels, mask

    def epoch(self, rng: np.random.Generator, nb: int) -> tuple:
        perm = rng.permutation(len(self))[: nb * self.cfg.batch_size]
        return self._finish(tuple(a[perm] for a in self.rows), rng)

    def batches(self, rng: np.random.Generator):
        for rows in minibatches(self.rows, self.cfg.batch_size, rng):
            yield self._finish(rows, rng)


def embed_all(params: GATNEParams, neighbors: torch.Tensor) -> np.ndarray:
    """[T, N, D]: every node's embedding under every edge type, one
    forward of all nodes a type."""
    n, T = neighbors.shape[0], neighbors.shape[1]
    nodes = torch.arange(n, device=neighbors.device)
    with torch.no_grad():
        return torch.stack([params.encode(nodes, torch.full_like(nodes, t),
                                          neighbors)
                            for t in range(T)]).cpu().numpy()


def evaluate_gatne(params: GATNEParams, data: MultiplexData,
                   neighbors: torch.Tensor,
                   split: str = "test") -> Dict[str, float]:
    """Per-type cosine link-prediction metrics of the ``split``'s true and
    false edges, averaged over the types (replaces the O(N) loop at
    GATNE/train_utils/train_eval.py:54-68)."""
    true_d = data.valid_true if split == "valid" else data.test_true
    false_d = data.valid_false if split == "valid" else data.test_false
    agg = None
    for emb, ty in zip(embed_all(params, neighbors), data.edge_types):
        m = link_prediction_metrics(emb, true_d[ty], false_d[ty])
        agg = m if agg is None else {k: agg[k] + m[k] for k in m}
    return {k: v / len(data.edge_types) for k, v in agg.items()}


def gatne_model(data: MultiplexData, cfg: GATNEConfig,
                device: torch.device):
    """``GATNEParams`` initialised from ``cfg.seed`` on ``device`` and its
    optimizer: Adam (``nsloss``) or AdamW with optax's weight decay 1e-4
    (``masked_bce``), both at optax's defaults, capturable on CUDA."""
    params = GATNEParams(data, cfg)
    _init_params(params, cfg.seed)
    params.to(device)
    decay = 1e-4 if cfg.loss == "masked_bce" else None
    return params, make_adam(params.parameters(), cfg.lr, device,
                             weight_decay=decay)


def train_gatne(data: Optional[MultiplexData] = None,
                cfg: Optional[GATNEConfig] = None, verbose: bool = False,
                device: str | torch.device = "cuda",
                device_loop: Optional[bool] = None):
    """GATNE on ``data`` (the synthetic multiplex by default) with the
    loss ``cfg.loss``. Returns (the parameters by name, on ``device``;
    history [(epoch, mean loss, validation metrics)]; test metrics).
    ``device_loop`` defaults to the device loop on CUDA; a corpus smaller
    than one batch takes the host loop, as in JAX."""
    cfg = cfg or GATNEConfig()
    data = data or load_multiplex(seed=cfg.seed)
    if cfg.loss not in ("nsloss", "masked_bce"):
        raise ValueError(f"loss must be 'nsloss' or 'masked_bce', got "
                         f"{cfg.loss!r}")
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    neighbors = torch.from_numpy(
        build_neighbor_tables(data, cfg.neighbor_samples, rng)).to(device)
    source = _Batches(data, cfg, rng)
    params, optimizer = gatne_model(data, cfg, device)
    loss_fn = masked_bce if cfg.loss == "masked_bce" else nsloss
    step = make_step(params, optimizer, loss_fn, neighbors)
    nb = len(source) // cfg.batch_size
    if device_loop is None:
        device_loop = device.type == "cuda"
    device_loop = device_loop and nb > 0
    loop, history = None, []
    t0 = time.perf_counter()
    for epoch in range(1, cfg.epochs + 1):
        if device_loop:
            arrays = source.epoch(rng, nb)
            loop = loop or HostDrawnEpochs(step, arrays, cfg.batch_size,
                                           optimizer, device)
            mean_loss = float(loop.run(arrays).astype(np.float64).mean())
        else:
            losses = [step(*(_to_device(a, device) for a in batch))
                      for batch in source.batches(rng)]
            mean_loss = (float(torch.stack(losses).double().sum())
                         / len(losses) if losses else 0.0)
        metrics = evaluate_gatne(params, data, neighbors, split="valid")
        history.append((epoch, mean_loss, metrics))
        if verbose:
            print(f"epoch {epoch}: loss {mean_loss:.4f} val {metrics} "
                  f"({time.perf_counter() - t0:.1f}s)")
    test_metrics = evaluate_gatne(params, data, neighbors, split="test")
    return _params(params), history, test_metrics
