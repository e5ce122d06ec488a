"""Link-prediction evaluation: cosine scores of held-out true and false
edges, with accuracy, precision, recall, F1, rank AUC and BCE (numpy).

A copy of ``graphneuralnetwork_tpu/train/linkpred.py`` (the port imports
nothing of the JAX package). The reference scores every node and edge
type through the model one at a time (ValScale.get_model,
GATNE/train_utils/train_eval.py:46-84) and scores held-out edges by cosine
similarity (get_score :12-18) with BCE/accuracy/F1 (:21-44); here the
embedding dump is one batched forward by the caller and the metrics are
numpy, so equal embeddings give equal metrics, bit for bit."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def cosine_scores(emb: np.ndarray, src: np.ndarray,
                  dst: np.ndarray) -> np.ndarray:
    a = emb[src]
    b = emb[dst]
    num = np.sum(a * b, axis=-1)
    den = (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return num / np.maximum(den, 1e-12)


def auc_score(pos: np.ndarray, neg: np.ndarray) -> float:
    """Rank-based AUC without sklearn."""
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ties
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2 + 1
        i = j + 1
    n_pos, n_neg = len(pos), len(neg)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels == 1].sum()
                  - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def link_prediction_metrics(
    emb: np.ndarray,
    true_edges: Tuple[np.ndarray, np.ndarray],
    false_edges: Tuple[np.ndarray, np.ndarray],
    threshold: float | None = None,
) -> Dict[str, float]:
    """BCE-style sigmoid scoring of cosine similarities + accuracy/F1/AUC
    (GATNE/train_utils/train_eval.py:21-44 semantics)."""
    pos = cosine_scores(emb, *true_edges)
    neg = cosine_scores(emb, *false_edges)
    if threshold is None:
        # best threshold on the evaluated set, mirroring the reference's
        # use of a fixed 0.5 on sigmoid(score): keep 0.0 on raw cosine
        threshold = 0.0
    tp = float((pos > threshold).sum())
    fn = float((pos <= threshold).sum())
    fp = float((neg > threshold).sum())
    tn = float((neg <= threshold).sum())
    acc = (tp + tn) / max(tp + tn + fp + fn, 1)
    prec = tp / max(tp + fp, 1e-12)
    rec = tp / max(tp + fn, 1e-12)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    # stable BCE on sigmoid(cosine)
    def bce(s, y):
        z = np.clip(s, -30, 30)
        p = 1 / (1 + np.exp(-z))
        p = np.clip(p, 1e-7, 1 - 1e-7)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))
    loss = float(np.concatenate(
        [bce(pos, 1.0), bce(neg, 0.0)]).mean())
    return dict(accuracy=acc, precision=prec, recall=rec, f1=f1,
                auc=auc_score(pos, neg), loss=loss)
