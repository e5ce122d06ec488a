from .bcsr import (  # noqa: F401
    ATTEND_CHUNK,
    BCSRGraph,
    HybridGraph,
    build_bcsr,
    build_bcsr_transpose,
    build_hybrid,
)
from .device import resolve_device  # noqa: F401
from .graph import (  # noqa: F401
    EDGE_BLOCK,
    Graph,
    add_self_loops,
    build_graph,
    compute_chunk_spans,
    csr_offsets,
    dense_adj,
    gat_graph_hybrid,
    gcn_graph,
    gcn_graph_hybrid,
    row_normalize_features,
    row_normalize_weights,
    sym_normalize_weights,
    symmetrize,
)
from .hetero import BipartiteGraph, HeteroGraph, Vocab  # noqa: F401
