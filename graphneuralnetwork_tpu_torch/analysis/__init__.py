"""Graph analysis: the centrality / structure toolkit of the reference's
Basis demo (Basis/networkx_study.py:11-31), ported from
``graphneuralnetwork_tpu/analysis``.

Every metric is a dense-matrix iteration on the [N, N] adjacency: power
iterations for eigenvector/pagerank/HITS, level-synchronous frontier
products for BFS distances (closeness, diameter, connected components),
and a batched all-sources Brandes sweep for betweenness. No networkx
dependency.
"""

from .centrality import (  # noqa: F401
    betweenness_centrality,
    bfs_distances,
    closeness_centrality,
    connected_components,
    degree_centrality,
    diameter,
    eigenvector_centrality,
    hits,
    pagerank,
    to_dense_adjacency,
)
