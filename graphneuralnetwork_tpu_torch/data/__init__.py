from .planetoid import (  # noqa: F401
    NodeClassificationData,
    load_citeseer,
    load_cora,
    synthetic_citation_graph,
)
