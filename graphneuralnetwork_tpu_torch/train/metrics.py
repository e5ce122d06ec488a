"""Classification metrics (port of the node-classification and binary-logit
parts of ``graphneuralnetwork_tpu/train/metrics.py``). The accuracies and
the softmax loss return float32 scalars on the logits' device, so a
training loop can keep them there; the sigmoid loss is elementwise, as
optax's is."""

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
