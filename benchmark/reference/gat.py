"""The plain GAT (Veličković et al., arXiv:1710.10903): per head
``e_ij = LeakyReLU(a_src·Wh_j + a_dst·Wh_i)`` over the edges ``j -> i`` of
the symmetrised graph with self loops, ``α = softmax_j(e)``, ``out_i = Σ_j
α_ij Wh_j``; heads concatenated then ELU in the first layer, one head in
the output layer; dropout on the inputs of both layers and on ``α``. Its
parameters, dropout sites and the work of one epoch."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from benchmark import work
from benchmark.reference.gnn import Edges, aggregate


def params(cfg: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each parameter's shape and its glorot fan, by the port's names."""
    f0, heads, feat, c = (cfg["in_features"], cfg["heads"], cfg["hidden"],
                          cfg["num_classes"])
    hf = heads * feat
    return {"attn1.linear.weight": ((hf, f0), f0 + hf),
            "attn1.attn_src": ((heads, feat), heads + feat),
            "attn1.attn_dst": ((heads, feat), heads + feat),
            "attn_out.linear.weight": ((c, hf), hf + c),
            "attn_out.attn_src": ((1, c), 1 + c),
            "attn_out.attn_dst": ((1, c), 1 + c)}


def dropout_sites(cfg: dict) -> dict[str, tuple[str, int]]:
    """Each dropout mask's rows (``nodes`` or ``edges``) and width."""
    heads = cfg["heads"]
    return {"x": ("nodes", cfg["in_features"]), "att1": ("edges", heads),
            "h": ("nodes", heads * cfg["hidden"]), "att2": ("edges", 1)}


def layer(p: dict, name: str, x: torch.Tensor, edges: Edges, heads: int,
          feat: int, concat: bool, slope: float, att_mask) -> torch.Tensor:
    n = x.shape[0]
    h = (x @ p[f"{name}.linear.weight"].T).view(n, heads, feat)
    f_src = (h * p[f"{name}.attn_src"]).sum(-1)
    f_dst = (h * p[f"{name}.attn_dst"]).sum(-1)
    e = F.leaky_relu(f_src[edges.send] + f_dst[edges.recv], slope)
    idx = edges.recv[:, None].expand(-1, heads)
    shift = torch.full((n, heads), -math.inf, device=x.device).scatter_reduce(
        0, idx, e.detach(), "amax")
    num = torch.exp(e - shift[edges.recv])
    den = num.new_zeros(n, heads).index_add_(0, edges.recv, num)
    alpha = num / den[edges.recv]
    if att_mask is not None:
        alpha = alpha * att_mask
    out = aggregate(edges, alpha, h)
    return out.reshape(n, heads * feat) if concat else out.mean(1)


def forward(cfg: dict, p: dict, x: torch.Tensor, edges: Edges,
            masks) -> torch.Tensor:
    heads, feat, slope = cfg["heads"], cfg["hidden"], cfg["negative_slope"]
    m = masks or {}
    if masks is not None:
        x = x * m["x"]
    h = F.elu(layer(p, "attn1", x, edges, heads, feat, True, slope,
                    m.get("att1")))
    if masks is not None:
        h = h * m["h"]
    return layer(p, "attn_out", h, edges, 1, cfg["num_classes"], False,
                 slope, m.get("att2"))


def _coo_attend(n: int, e: int, heads: int, feat: int,
                backward: bool) -> list[work.Op]:
    """The COO formulation's per-edge aggregations: the score maxima, the
    denominators and the weighted sum; in the backward the sum's
    transpose for ``dx`` and the three gathers' transposes (the two logit
    gathers and the denominator's)."""
    hf = heads * feat
    if not backward:
        return [work.segment_max(n, e, heads), work.segment_sum(n, e, heads),
                work.segment_sum(n, e, hf, table=n, weights=heads)]
    return [work.segment_sum(n, e, hf, table=n, weights=heads),
            *(work.segment_sum(n, e, heads) for _ in range(3))]


def epoch_ops(cfg: dict, n: int, e: int, layout: str) -> list[work.Op]:
    """The train step and the val forward. ``layout="coo"`` counts the
    attention as the COO formulation's per-edge aggregations, which is how
    its kernels divide it; any other value counts it as one fused pass each
    way, the least the model needs."""
    f0, heads, feat, c = (cfg["in_features"], cfg["heads"], cfg["hidden"],
                          cfg["num_classes"])
    layers = [(f0, heads, feat), (heads * feat, 1, c)]

    def attend(h, f, backward):
        if layout == "coo":
            return _coo_attend(n, e, h, f, backward)
        make = work.attend_backward if backward else work.attend_forward
        return [make(n, e, h, f)]

    forward_ops = []
    for fin, h, f in layers:
        forward_ops += [work.gemm(n, fin, h * f), *attend(h, f, False)]
    backward = []
    for i, (fin, h, f) in reversed(list(enumerate(layers))):
        backward += attend(h, f, True)
        backward.append(work.gemm(fin, n, h * f))
        if i > 0:
            backward.append(work.gemm(n, h * f, fin))
    return (forward_ops + backward + [work.adam(work.count(params(cfg)))]
            + forward_ops)
