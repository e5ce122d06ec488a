"""Graph-analysis demo — the reference's Basis/networkx_study.py:11-31
walkthrough (degree, connected components, diameter, degree/eigenvector/
betweenness/closeness centrality, pagerank, HITS) on the same 10-node
graph, computed by this package's dense tensor iterations instead of
networkx. Port of ``graphneuralnetwork_tpu/analysis/demo.py``.

Run: ``python -m graphneuralnetwork_tpu_torch.analysis.demo [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve_device
from . import centrality as C


def basis_adjacency() -> np.ndarray:
    """The Basis demo's 10-node undirected graph as a float32 adjacency."""
    # The Basis demo's edge list (both directions listed explicitly).
    src = [0, 1, 2, 3, 4, 4, 6, 7, 7, 9, 1, 4, 4, 4, 6, 7, 5, 8, 9, 8]
    dst = [1, 4, 4, 4, 6, 7, 5, 8, 9, 8, 0, 1, 2, 3, 4, 4, 6, 7, 7, 9]
    n = 10
    a = np.zeros((n, n), np.float32)
    a[src, dst] = 1.0
    return np.maximum(a, a.T)


def basis_demo(device: str | torch.device = "cuda") -> dict:
    """Every metric of the demo on ``device``, as lists (JAX's keys)."""
    a = torch.from_numpy(basis_adjacency()).to(resolve_device(device))
    hubs, auths = C.hits(a)
    return {
        "degree": (a > 0).sum(1).tolist(),
        "connected_components": C.connected_components(a).tolist(),
        "diameter": C.diameter(a),
        "degree_centrality": C.degree_centrality(a).tolist(),
        "eigenvector_centrality": C.eigenvector_centrality(a).tolist(),
        "betweenness": C.betweenness_centrality(a).tolist(),
        "closeness": C.closeness_centrality(a).tolist(),
        "pagerank": C.pagerank(a).tolist(),
        "hits_hubs": hubs.tolist(),
        "hits_authorities": auths.tolist(),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    for k, v in basis_demo(ap.parse_args().device).items():
        print(f"{k}: {v}")
