"""Classification metrics (port of the JAX package's
``train/metrics.py``). The accuracies, the softmax loss, the masked
sigmoid loss and the precision/recall/F-beta triple return float32
scalars on the logits' device, so a training loop can keep them there;
``sigmoid_binary_cross_entropy`` (also ``optax_sigmoid_bce``) is
elementwise, as optax's is; ``Accumulator`` keeps running sums on the
host."""

from __future__ import annotations

import torch
from torch.nn import functional as F


def accuracy(logits, labels, mask=None):
    correct = (torch.argmax(logits, dim=-1) == labels).float()
    if mask is None:
        return correct.mean()
    m = mask.float()
    return torch.sum(correct * m) / torch.clamp_min(torch.sum(m), 1.0)


def masked_softmax_cross_entropy(logits, labels, mask=None):
    losses = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[:, None])[:, 0]
    if mask is None:
        return losses.mean()
    m = mask.to(losses.dtype)
    return torch.sum(losses * m) / torch.clamp_min(torch.sum(m), 1.0)


def binary_accuracy(logits, labels, mask=None, threshold=0.5):
    """sigmoid(logits) > threshold against {0, 1} labels."""
    pred = (torch.sigmoid(logits) > threshold).float()
    correct = (pred == labels.float()).float()
    if mask is None:
        return correct.mean()
    m = mask.float()
    return torch.sum(correct * m) / torch.clamp_min(torch.sum(m), 1.0)


def sigmoid_binary_cross_entropy(logits, labels):
    """Elementwise binary cross-entropy on logits, as
    ``optax.sigmoid_binary_cross_entropy`` computes it:
    ``-y·log σ(x) - (1 - y)·log σ(-x)``."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


#: JAX's name for the same elementwise loss.
optax_sigmoid_bce = sigmoid_binary_cross_entropy


def masked_sigmoid_bce(logits, labels, mask=None):
    """Binary cross-entropy on logits of padded skip-gram rows: each row's
    mean over its valid entries (``mask``; a row without one counts 0),
    then the mean over rows; without ``mask`` the mean of every entry."""
    losses = sigmoid_binary_cross_entropy(logits, labels)
    if mask is None:
        return losses.mean()
    m = mask.to(losses.dtype)
    row = torch.sum(losses * m, dim=-1) / torch.clamp_min(
        torch.sum(m, dim=-1), 1.0)
    return row.mean()


def confusion_counts(pred, labels, num_classes: int, mask=None):
    """Per-class one-vs-rest (TP, FP, FN, TN), each float32 [num_classes];
    ``mask`` weights the rows (all 1 when None)."""
    m = (torch.ones(labels.shape, device=labels.device) if mask is None
         else mask.float())[:, None]
    onehot_p = F.one_hot(pred.long(), num_classes).float() * m
    onehot_l = F.one_hot(labels.long(), num_classes).float() * m
    tp = torch.sum(onehot_p * onehot_l, dim=0)
    fp = torch.sum(onehot_p * (m - onehot_l * m), dim=0)
    fn = torch.sum((onehot_l - onehot_p * onehot_l) * m, dim=0)
    tn = torch.sum(m) - tp - fp - fn
    return tp, fp, fn, tn


def precision_recall_fbeta(logits, labels, num_classes: int, mask=None,
                           beta: float = 1.0, average: str = "macro"):
    """(precision, recall, F-beta) of ``argmax(logits)``: ``"macro"``
    averages the per-class scores, ``"micro"`` scores the summed counts;
    every denominator is floored at 1e-12."""
    tp, fp, fn, _ = confusion_counts(torch.argmax(logits, dim=-1), labels,
                                     num_classes, mask)
    if average == "micro":
        tp, fp, fn = torch.sum(tp), torch.sum(fp), torch.sum(fn)
    prec = tp / torch.clamp_min(tp + fp, 1e-12)
    rec = tp / torch.clamp_min(tp + fn, 1e-12)
    b2 = beta * beta
    f = (1 + b2) * prec * rec / torch.clamp_min(b2 * prec + rec, 1e-12)
    if average == "macro":
        prec, rec, f = prec.mean(), rec.mean(), f.mean()
    return prec, rec, f


class Accumulator:
    """Running sums of ``n`` logged quantities (host-side)."""

    def __init__(self, n: int):
        self.data = [0.0] * n

    def add(self, *args):
        self.data = [a + float(b) for a, b in zip(self.data, args)]

    def reset(self):
        self.data = [0.0] * len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]
