"""Mini-batch GraphSAGE training, supervised and unsupervised.

Port of ``graphneuralnetwork_tpu/train/sage_loop.py``. Supervised: fanout-
sample a batch of labelled nodes, cross-entropy on the folded output;
defaults fanouts (10, 10), dims (128, C), batch 64, AdamW lr 1e-2 (or the
reference's SGD lr 0.1 under warmup-poly). Unsupervised: each batch node
gets a context node (a step of a short walk) and K negatives (degree^0.75);
the same sampled forward embeds all three, scored by dot products under a
binary-logit loss.

The host-sampled loops draw from one numpy ``rng`` in the JAX package's
exact order, so the same seed gives the same hops batch for batch: the
``hops0`` draw that JAX makes only to initialise flax is still drawn, then
each epoch's shuffle, each batch's walks, negatives and hops, and each
evaluation batch's hops. Only the int32 hop ids cross to the device; the
features are gathered there. The parameters come from a torch generator
seeded with ``cfg.seed`` (``_init_params``), not from JAX's keys.

``train_sage_supervised_device`` samples on the device
(``sampling/device_neighbor.py``): the permutation and the hops are drawn
there from a ``torch.Generator``, one eager step per batch. (JAX runs the
epoch as one ``lax.scan`` dispatch; capturing it as a CUDA graph is later
work.) Every entry point runs on ``cuda`` unless ``device`` says
otherwise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn.sage import SampledGraphSAGE
from ..sampling import csr_from_edges, multihop_sampling, uniform_walks
from ..sampling.skipgram import NegativeSampler
from .metrics import (accuracy, binary_accuracy, masked_softmax_cross_entropy,
                      sigmoid_binary_cross_entropy)
from .schedule import OptimizerSpec, make_optimizer


@dataclass
class SageConfig:
    fanouts: Sequence[int] = (10, 10)
    hidden: int = 128
    batch_size: int = 64
    lr: float = 1e-2
    weight_decay: float = 1e-4
    epochs: int = 5
    aggregator: str = "mean"
    # "adamw" (default) or "sgd" = the reference recipe: SGD at the
    # reference lr under the warmup-poly schedule
    optimizer: str = "adamw"
    seed: int = 0
    # unsupervised mode
    num_negatives: int = 5
    walk_length: int = 5
    # sample on the device (sampling/device_neighbor.py) instead of the host
    device_sampling: bool = False
    max_table_degree: Optional[int] = None


def _make_tx(cfg: SageConfig, steps_per_epoch: int) -> OptimizerSpec:
    """``cfg``'s optimizer over ``epochs · steps_per_epoch`` steps with one
    epoch of warmup (SGD's schedule; AdamW's lr is constant)."""
    return make_optimizer(cfg.optimizer, cfg.lr,
                          weight_decay=cfg.weight_decay,
                          total_steps=cfg.epochs * steps_per_epoch,
                          warmup_steps=steps_per_epoch, momentum=0.9)


def _init_params(model: SampledGraphSAGE, seed: int) -> None:
    """The model's initial parameters, from a CPU generator seeded with
    ``seed`` (flax's ``nn.Dense`` initialiser, other draws)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))


def _build(in_features: int, dims, cfg: SageConfig, steps_per_epoch: int,
           device: torch.device):
    """The model (initialised, on ``device``), its optimizer and schedule."""
    model = SampledGraphSAGE(in_features, dims=dims,
                             fanouts=tuple(cfg.fanouts),
                             aggregator=cfg.aggregator)
    _init_params(model, cfg.seed)
    model.to(device)
    opt, sched = _make_tx(cfg, steps_per_epoch).build(model.parameters())
    return model, opt, sched


def _hops_to_device(hops, device: torch.device) -> list[torch.Tensor]:
    """The host's int32 hop id arrays on ``device`` (the only host-to-device
    copy of a batch)."""
    return [torch.from_numpy(np.ascontiguousarray(h, np.int32)).to(device)
            for h in hops]


def _gather(features: torch.Tensor, hop_ids) -> list[torch.Tensor]:
    """Each hop's features, gathered on the features' device."""
    return [features[h.long()] for h in hop_ids]


def _update(opt, sched, loss: torch.Tensor) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    if sched is not None:
        sched.step()


def _supervised_step(model, opt, sched, features, hop_ids, labels):
    """One optimizer step on a batch; (loss, accuracy) as device scalars."""
    logits = model(_gather(features, hop_ids))
    loss = masked_softmax_cross_entropy(logits, labels)
    _update(opt, sched, loss)
    return loss.detach(), accuracy(logits.detach(), labels)


@torch.no_grad()
def _infer(model, features, hop_ids) -> torch.Tensor:
    return model(_gather(features, hop_ids))


def _state(model) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _log(verbose: bool, epoch: int, loss: float, name: str, value: float,
         t0: float) -> None:
    if verbose:
        print(f"epoch {epoch}: loss {loss:.4f} {name} {value:.4f} "
              f"({time.perf_counter() - t0:.1f}s)")


def train_sage_supervised(data, cfg: Optional[SageConfig] = None,
                          verbose: bool = False,
                          device: str | torch.device = "cuda"):
    """(params, history [(epoch, mean train loss, val_acc)], test_acc) of
    host-sampled supervised training on ``data`` (``SampledNodeData``);
    ``cfg.device_sampling`` hands over to
    ``train_sage_supervised_device``."""
    cfg = cfg or SageConfig()
    device = resolve_device(device)
    if cfg.device_sampling:
        return train_sage_supervised_device(data, cfg, verbose=verbose,
                                            device=device)
    rng = np.random.default_rng(cfg.seed)
    n = data.features.shape[0]
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, n)
    B = cfg.batch_size
    # JAX draws these hops to initialise flax; drawn here for the same rng
    multihop_sampling(data.train_idx[:B], cfg.fanouts, indptr, indices, rng)
    model, opt, sched = _build(
        data.features.shape[1], (cfg.hidden, data.num_classes), cfg,
        max(len(data.train_idx) // B, 1), device)
    feats = torch.from_numpy(np.asarray(data.features, np.float32)).to(device)
    labels = torch.from_numpy(np.asarray(data.labels, np.int64)).to(device)

    def evaluate(idx):
        model.eval()
        correct = torch.zeros((), dtype=torch.int64, device=device)
        total = 0
        for i in range(0, len(idx) - B + 1, B):
            sel = idx[i:i + B]
            hops = multihop_sampling(sel, cfg.fanouts, indptr, indices, rng)
            hop_ids = _hops_to_device(hops, device)
            pred = _infer(model, feats, hop_ids).argmax(-1)
            correct += (pred == labels[hop_ids[0].long()]).sum()
            total += len(sel)
        return int(correct) / max(total, 1)

    history = []
    t0 = time.perf_counter()
    train_idx = np.array(data.train_idx)   # shuffled in place: a copy
    for epoch in range(1, cfg.epochs + 1):
        rng.shuffle(train_idx)
        model.train()
        losses = []
        for i in range(0, len(train_idx) - B + 1, B):
            sel = train_idx[i:i + B]
            hops = multihop_sampling(sel, cfg.fanouts, indptr, indices, rng)
            hop_ids = _hops_to_device(hops, device)
            loss, _ = _supervised_step(model, opt, sched, feats, hop_ids,
                                       labels[hop_ids[0].long()])
            losses.append(loss)
        mean_loss = (float(torch.stack(losses).double().sum()) /
                     max(len(losses), 1)) if losses else 0.0
        val_acc = evaluate(np.asarray(data.val_idx))
        history.append((epoch, mean_loss, val_acc))
        _log(verbose, epoch, mean_loss, "val_acc", val_acc, t0)
    test_acc = evaluate(np.asarray(data.test_idx))
    return _state(model), history, test_acc


def train_sage_supervised_device(data, cfg: SageConfig,
                                 verbose: bool = False,
                                 device: str | torch.device = "cuda"):
    """Supervised training with the sampling on the device: the neighbour
    table, features and labels live there, and each epoch's permutation
    and each batch's hops are drawn there from a generator seeded with
    ``cfg.seed``; one eager step per batch. Same returns as
    ``train_sage_supervised``."""
    from ..sampling.device_neighbor import (build_device_neighbor_table,
                                            device_multihop_sampling)

    device = resolve_device(device)
    n = data.features.shape[0]
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, n)
    table, deg = build_device_neighbor_table(
        indptr, indices, max_deg=cfg.max_table_degree, device=device)
    feats = torch.from_numpy(np.asarray(data.features, np.float32)).to(device)
    labels = torch.from_numpy(np.asarray(data.labels, np.int64)).to(device)
    B = cfg.batch_size
    train_np = np.asarray(data.train_idx)
    if len(train_np) < B:   # wrap-pad a tiny split to one full batch
        train_np = np.resize(train_np, B)
    train_ids = torch.from_numpy(train_np.astype(np.int32)).to(device)
    nb = max(len(train_ids) // B, 1)
    model, opt, sched = _build(data.features.shape[1],
                               (cfg.hidden, data.num_classes), cfg, nb,
                               device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    def hop_ids(sel):
        return device_multihop_sampling(gen, sel, cfg.fanouts, table, deg)

    def eval_split(idx):
        idx = np.asarray(idx)
        if len(idx) < B:
            idx = np.resize(idx, B)
        m = max(len(idx) // B, 1)
        mat = torch.from_numpy(idx[:m * B].reshape(m, B).astype(np.int32)
                               ).to(device)
        model.eval()
        accs = [accuracy(_infer(model, feats, hop_ids(sel)),
                         labels[sel.long()]) for sel in mat]
        return float(torch.stack(accs).mean())

    history = []
    t0 = time.perf_counter()
    for epoch in range(1, cfg.epochs + 1):
        perm = torch.randperm(len(train_ids), generator=gen, device=device)
        batches = train_ids[perm][:nb * B].reshape(nb, B)
        model.train()
        losses = [_supervised_step(model, opt, sched, feats, hop_ids(sel),
                                   labels[sel.long()])[0]
                  for sel in batches]
        loss = float(torch.stack(losses).mean())
        val_acc = eval_split(data.val_idx)
        history.append((epoch, loss, val_acc))
        _log(verbose, epoch, loss, "val_acc", val_acc, t0)
    test_acc = eval_split(data.test_idx)
    return _state(model), history, test_acc


def _unsupervised_step(model, opt, sched, features, hop_u, hop_c, hop_n,
                       b: int, k: int):
    """One step of the binary-logit loss on dot(emb_u, emb_ctx) = 1 and
    dot(emb_u, emb_neg) = 0; (loss, binary accuracy) as device scalars."""
    emb_u = model(_gather(features, hop_u))                 # [B, D]
    emb_c = model(_gather(features, hop_c))                 # [B, D]
    emb_n = model(_gather(features, hop_n)).reshape(b, k, -1)
    pos = torch.sum(emb_u * emb_c, -1)
    neg = torch.einsum("bd,bkd->bk", emb_u, emb_n)
    logits = torch.cat([pos[:, None], neg], dim=1)
    target = torch.cat([torch.ones(b, 1, device=logits.device),
                        torch.zeros(b, k, device=logits.device)], dim=1)
    loss = sigmoid_binary_cross_entropy(logits, target).mean()
    _update(opt, sched, loss)
    return loss.detach(), binary_accuracy(logits.detach(), target)


def train_sage_unsupervised(data, cfg: Optional[SageConfig] = None,
                            verbose: bool = False,
                            device: str | torch.device = "cuda"):
    """(params, history [(epoch, mean loss, mean binary accuracy)]) of the
    context/negative mode: contexts from short uniform walks, negatives
    from degree^0.75, dims (hidden, hidden)."""
    cfg = cfg or SageConfig()
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    n = data.features.shape[0]
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, n)
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    neg_sampler = NegativeSampler(np.maximum(deg, 1))
    B, K = cfg.batch_size, cfg.num_negatives
    # JAX draws these hops to initialise flax; drawn here for the same rng
    multihop_sampling(np.arange(B), cfg.fanouts, indptr, indices, rng)
    model, opt, sched = _build(data.features.shape[1],
                               (cfg.hidden, cfg.hidden), cfg,
                               max(n // B, 1), device)
    feats = torch.from_numpy(np.asarray(data.features, np.float32)).to(device)

    def hops(nodes):
        return _hops_to_device(
            multihop_sampling(nodes, cfg.fanouts, indptr, indices, rng),
            device)

    history = []
    t0 = time.perf_counter()
    nodes = np.arange(n)
    for epoch in range(1, cfg.epochs + 1):
        rng.shuffle(nodes)
        model.train()
        losses, accs = [], []
        for i in range(0, n - B + 1, B):
            batch = nodes[i:i + B]
            walks = uniform_walks(indptr, indices, batch, cfg.walk_length,
                                  rng)
            ctx = walks[np.arange(len(batch)),
                        rng.integers(1, cfg.walk_length, len(batch))]
            negs = neg_sampler.draw((len(batch) * K,), rng)
            hop_u, hop_c, hop_n = hops(batch), hops(ctx), hops(negs)
            loss, acc = _unsupervised_step(model, opt, sched, feats, hop_u,
                                           hop_c, hop_n, len(batch), K)
            losses.append(loss)
            accs.append(acc)
        nb = max(len(losses), 1)
        mean_loss = float(torch.stack(losses).double().sum()) / nb
        mean_acc = float(torch.stack(accs).double().sum()) / nb
        history.append((epoch, mean_loss, mean_acc))
        _log(verbose, epoch, mean_loss, "binary_acc", mean_acc, t0)
    return _state(model), history


def sage_embed_all(params: Mapping[str, torch.Tensor], data,
                   cfg: SageConfig,
                   hidden_out: Optional[int] = None) -> np.ndarray:
    """[N, D] embeddings of every node by the trained unsupervised model
    ``params`` (on their device), hops drawn from a fresh ``rng`` seeded
    with ``cfg.seed``."""
    rng = np.random.default_rng(cfg.seed)
    n = data.features.shape[0]
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, n)
    device = next(iter(params.values())).device
    model = SampledGraphSAGE(data.features.shape[1],
                             dims=(cfg.hidden, hidden_out or cfg.hidden),
                             fanouts=tuple(cfg.fanouts),
                             aggregator=cfg.aggregator).to(device)
    model.load_state_dict(params)
    model.eval()
    feats = torch.from_numpy(np.asarray(data.features, np.float32)).to(device)
    b = cfg.batch_size
    idx = np.arange(n)
    idx_p = np.concatenate([idx, idx[:(-len(idx)) % b]])
    out = []
    for i in range(0, len(idx_p), b):
        hops = multihop_sampling(idx_p[i:i + b], cfg.fanouts, indptr,
                                 indices, rng)
        out.append(_infer(model, feats, _hops_to_device(hops, device)))
    return torch.cat(out)[:n].cpu().numpy()
