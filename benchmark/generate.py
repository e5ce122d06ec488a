"""The benchmark's one traffic generator: a citation-shaped graph, its
features, labels and split, from a mix's parameters and a seed.

A mix (``traffic/<name>.json``) fixes the node and edge counts, the
feature width, the classes, the split sizes and the graph's structure:

* ``sender_law: "pareto"``: the out-degrees follow a fixed sequence, the
  quantiles of Pareto(``pareto_alpha``) scaled to ``edges``, which the
  graph's seed deals out to the nodes;
* ``intra_share``: the share of each edge's receivers drawn inside the
  sender's community of ``community`` consecutive ids (the rest uniform
  over all nodes); then every id is shuffled, so a layout has to find the
  communities again.

The graph comes from the mix's own ``graph_seed``, as a data set is fixed:
graphs drawn alike still differ in where their hubs fall, and that moved
the epoch's time by 3.5 % between seeds where two runs of one seed agreed
within 0.6 % (PERF.md). ``--seed`` draws everything else: labels, split,
features, and (``cell.py``) the initial weights and the dropout.

The edges are ``edges`` distinct undirected pairs without self loops: the
program symmetrises and adds the loops itself. Features are class
centroids plus unit noise, drawn on ``device`` in two calls; labels and
the split come from the seed on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

@dataclasses.dataclass(frozen=True)
class Dataset:
    senders: np.ndarray      # int32 [edges]: one end of each pair
    receivers: np.ndarray    # int32 [edges]: the other end
    n_nodes: int
    labels: np.ndarray       # int64 [nodes]
    train_idx: np.ndarray    # int64, sorted
    val_idx: np.ndarray
    test_idx: np.ndarray
    features: torch.Tensor   # float32 [nodes, features] on the device


def sender_weights(n: int, alpha: float) -> np.ndarray:
    """Pareto(``alpha``) quantiles at the midpoints of ``n`` equal bins,
    largest first: a fixed heavy-tailed weight sequence."""
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    return q ** (-1.0 / alpha)


def degree_sequence(weights: np.ndarray, m: int) -> np.ndarray:
    """Integer degrees proportional to ``weights`` that sum to ``m``: the
    floors, then one more for the largest remainders (ties by index)."""
    exact = weights / weights.sum() * m
    deg = np.floor(exact).astype(np.int64)
    short = m - int(deg.sum())
    if short > 0:
        deg[np.argsort(-(exact - deg), kind="stable")[:short]] += 1
    return deg


def _receivers(senders: np.ndarray, mix: dict, n: int,
               rng: np.random.Generator) -> np.ndarray:
    recv = rng.integers(0, n, senders.shape[0])
    share = float(mix["intra_share"])
    if share > 0.0:
        comm = int(mix["community"])
        base = senders // comm * comm
        size = np.minimum(comm, n - base)
        inside = rng.random(senders.shape[0]) < share
        local = base + (rng.random(senders.shape[0]) * size).astype(np.int64)
        recv = np.where(inside, local, recv)
    return recv


def draw_pairs(mix: dict, rng: np.random.Generator) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """``edges`` distinct undirected pairs in pre-shuffle slot ids, in the
    order drawn: first the degree sequence, then, for the pairs lost to
    duplicates and self loops, senders drawn by the same weights."""
    n, m = int(mix["nodes"]), int(mix["edges"])
    if mix["sender_law"] != "pareto":
        raise ValueError(f"unknown sender_law {mix['sender_law']!r}")
    w = sender_weights(n, float(mix["pareto_alpha"]))[rng.permutation(n)]
    send = np.repeat(np.arange(n), degree_sequence(w, m))
    send = send[rng.permutation(send.shape[0])]
    keys = np.empty(0, np.int64)
    while True:
        recv = _receivers(send, mix, n, rng)
        keep = send != recv
        lo = np.minimum(send, recv)[keep]
        hi = np.maximum(send, recv)[keep]
        keys = np.concatenate([keys, lo * n + hi])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
        if keys.shape[0] >= m:
            keys = keys[:m]
            break
        need = m - keys.shape[0]
        send = rng.choice(n, size=need + need // 4 + 64, p=w / w.sum())
    return keys // n, keys % n


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th seed derived from ``seed`` (a non-negative int64)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_dataset(mix: dict, seed: int,
                 device: str | torch.device) -> Dataset:
    """The mix's graph, and the labels, split and features of ``seed``."""
    label_ss, feat_ss = np.random.SeedSequence(seed).spawn(2)
    rng = np.random.default_rng(int(mix["graph_seed"]))
    n = int(mix["nodes"])
    lo, hi = draw_pairs(mix, rng)
    ids = rng.permutation(n)
    senders, receivers = ids[lo].astype(np.int32), ids[hi].astype(np.int32)

    rng = np.random.default_rng(label_ss)
    classes, width = int(mix["classes"]), int(mix["features"])
    labels = rng.integers(0, classes, n).astype(np.int64)
    n_train, n_val, n_test = (int(k) for k in mix["split"])
    if n_train + n_val + n_test != n:
        raise ValueError("the split sizes must add up to the node count")
    order = rng.permutation(n)
    train = np.sort(order[:n_train])
    val = np.sort(order[n_train:n_train + n_val])
    test = np.sort(order[n_train + n_val:])

    gen = torch.Generator(device=device).manual_seed(
        int(feat_ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    centroids = torch.randn(classes, width, generator=gen, device=device)
    noise = torch.randn(n, width, generator=gen, device=device)
    label_t = torch.from_numpy(labels).to(device)
    features = noise.add_(centroids[label_t], alpha=0.5)
    return Dataset(senders, receivers, n, labels, train, val, test, features)
