"""The plain GCN (Kipf & Welling, arXiv:1609.02907):
``Â relu(Â X W1 + b1) W2 + b2`` with ``Â = D^-1/2 (A + I) D^-1/2`` over the
symmetrised edges, dropout on the hidden layer; its parameters, dropout
sites and the work of one epoch."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.reference.gnn import Edges, aggregate


def params(cfg: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each parameter's shape and its glorot fan (0: zeros), by the port's
    names."""
    f0, h, c = cfg["in_features"], cfg["hidden"], cfg["num_classes"]
    return {"conv1.linear.weight": ((h, f0), f0 + h), "conv1.bias": ((h,), 0),
            "conv2.linear.weight": ((c, h), h + c), "conv2.bias": ((c,), 0)}


def dropout_sites(cfg: dict) -> dict[str, tuple[str, int]]:
    """Each dropout mask's rows (``nodes`` or ``edges``) and width."""
    return {"h": ("nodes", cfg["hidden"])}


def norm(edges: Edges) -> torch.Tensor:
    """``d_r^-1/2 d_s^-1/2`` per edge, the degrees counting the loop."""
    deg = torch.bincount(edges.recv, minlength=edges.n).float()
    inv = deg.rsqrt()
    return inv[edges.recv] * inv[edges.send]


def forward(cfg: dict, p: dict, x: torch.Tensor, edges: Edges,
            masks) -> torch.Tensor:
    w = norm(edges)
    h = aggregate(edges, w, x @ p["conv1.linear.weight"].T)
    h = torch.relu(h + p["conv1.bias"])
    if masks is not None:
        h = h * masks["h"]
    return aggregate(edges, w, h @ p["conv2.linear.weight"].T) + p[
        "conv2.bias"]


def epoch_ops(cfg: dict, n: int, e: int, layout: str) -> list[work.Op]:
    """The train step and the val forward; the same on every layout."""
    f0, h, c = cfg["in_features"], cfg["hidden"], cfg["num_classes"]

    def agg(f):
        return work.segment_sum(n, e, f, table=n, weights=1)

    forward_ops = [work.gemm(n, f0, h), agg(h), work.gemm(n, h, c), agg(c)]
    backward = [agg(c), work.gemm(h, n, c), work.gemm(n, c, h), agg(h),
                work.gemm(f0, n, h)]
    return (forward_ops + backward + [work.adam(work.count(params(cfg)))]
            + forward_ops)
