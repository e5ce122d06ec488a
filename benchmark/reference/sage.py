"""The plain GraphSAGE of OGB's full-batch ogbn-products example
(``snap-stanford/ogb``, ``examples/nodeproppred/products/gnn.py`` with
``--use_sage``): layers of PyG's ``SAGEConv``, ``lin_l(mean_{j -> i} x_j)
+ lin_r(x_i)`` with the bias on ``lin_l`` only, ReLU and dropout after each
hidden layer. Its parameters, dropout sites and the work of one epoch.

The mean runs over the canonical edges, which carry one self loop a node
(the harness's graph; OGB's adjacency has none), as a sum weighted by
``1 / deg(i)`` taken in blocks of ``EDGE_BLOCK`` edges: the whole graph's
gathered rows ``x[edges.send]`` would be [E, F], 129 GB at ogbn-products'
126M edges and 256 columns. Its gradient is the same blocked sum over the
reversed edges (the mean is linear: its gradient is its transpose), where
autograd through the blocks would keep every block's gathered rows."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.reference.gnn import Edges

#: edges gathered at a time: 2 GB of float32 rows at 256 columns
EDGE_BLOCK = 1 << 21


def layer_names(cfg: dict) -> list[str]:
    return [f"sage{i}" for i in range(cfg["num_layers"] - 1)] + ["sage_out"]


def widths(cfg: dict) -> list[int]:
    """Each layer's input width, then the output's."""
    return ([cfg["in_features"]] + [cfg["hidden"]] * (cfg["num_layers"] - 1)
            + [cfg["num_classes"]])


def params(cfg: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each parameter's shape and its glorot fan (0: zeros), by the port's
    names (``neighbor`` is PyG's ``lin_l``, ``self`` its ``lin_r``)."""
    dims = widths(cfg)
    out = {}
    for name, d_in, d_out in zip(layer_names(cfg), dims[:-1], dims[1:]):
        out[f"{name}.neighbor.weight"] = ((d_out, d_in), d_in + d_out)
        out[f"{name}.neighbor.bias"] = ((d_out,), 0)
        out[f"{name}.self.weight"] = ((d_out, d_in), d_in + d_out)
    return out


def dropout_sites(cfg: dict) -> dict[str, tuple[str, int]]:
    """Each dropout mask's rows (``nodes`` or ``edges``) and width: one
    after each hidden layer's ReLU."""
    return {f"h{i}": ("nodes", cfg["hidden"])
            for i in range(cfg["num_layers"] - 1)}


def _blocked_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor, n: int) -> torch.Tensor:
    """``out[d] = Σ w · x[s]`` over the edges ``s -> d``, ``EDGE_BLOCK``
    edges at a time."""
    out = x.new_zeros((n, x.shape[1]))
    for lo in range(0, w.shape[0], EDGE_BLOCK):
        hi = lo + EDGE_BLOCK
        out.index_add_(0, dst[lo:hi], x[src[lo:hi]].mul_(w[lo:hi, None]))
    return out


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edges, w):
        ctx.edges, ctx.w = edges, w
        return _blocked_sum(x, edges.send, edges.recv, w, edges.n)

    @staticmethod
    def backward(ctx, g):
        e = ctx.edges
        return _blocked_sum(g, e.recv, e.send, ctx.w, e.n), None, None


def mean(edges: Edges, x: torch.Tensor) -> torch.Tensor:
    """``out[i]`` = the mean of ``x[j]`` over the edges ``j -> i``."""
    deg = torch.bincount(edges.recv, minlength=edges.n).float()
    return _Mean.apply(x, edges, deg.reciprocal()[edges.recv])


def forward(cfg: dict, p: dict, x: torch.Tensor, edges: Edges,
            masks) -> torch.Tensor:
    h = x
    for i, name in enumerate(layer_names(cfg)):
        h = (mean(edges, h) @ p[f"{name}.neighbor.weight"].T
             + p[f"{name}.neighbor.bias"] + h @ p[f"{name}.self.weight"].T)
        if name != "sage_out":
            h = torch.relu(h)
            if masks is not None:
                h = h * masks[f"h{i}"]
    return h


def epoch_ops(cfg: dict, n: int, e: int, layout: str) -> list[work.Op]:
    """The train step and the val forward; the same on every layout. Each
    mean is counted at the narrower of its layer's two widths (it commutes
    with ``lin_l``), its divisor from the row offsets (no per-edge
    weight); the first layer's input needs no gradient."""
    dims = widths(cfg)
    forward_ops, backward = [], []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        agg = work.segment_sum(n, e, min(d_in, d_out), table=n)
        forward_ops += [agg, work.gemm(n, d_in, d_out),
                        work.gemm(n, d_in, d_out)]
        grads = [work.gemm(d_out, n, d_in), work.gemm(d_out, n, d_in)]
        if i > 0:
            grads += [work.gemm(n, d_out, d_in), work.gemm(n, d_out, d_in),
                      agg]
        backward = grads + backward
    return (forward_ops + backward + [work.adam(work.count(params(cfg)))]
            + forward_ops)
