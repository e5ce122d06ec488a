"""Classification metrics (port of the node-classification part of
``graphneuralnetwork_tpu/train/metrics.py``). Both return float32 scalars
on the logits' device, so a training loop can keep them there."""

from __future__ import annotations

import torch


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
