from .device import resolve_device  # noqa: F401
from .graph import (  # noqa: F401
    EDGE_BLOCK,
    Graph,
    add_self_loops,
    build_graph,
    compute_chunk_spans,
    csr_offsets,
    gcn_graph,
    row_normalize_features,
    row_normalize_weights,
    sym_normalize_weights,
    symmetrize,
)
