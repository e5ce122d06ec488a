from .acm import (  # noqa: F401
    HeteroNodeData,
    StackedAdjData,
    load_acm_gtn,
    load_acm_han,
    load_imdb_gtn,
    load_imdb_han,
    synthetic_acm,
)
from .jdata import JData, load_jdata, process_jdata  # noqa: F401
from .planetoid import (  # noqa: F401
    NodeClassificationData,
    load_citeseer,
    load_cora,
    synthetic_citation_graph,
)
from .pubmed import (  # noqa: F401
    SampledNodeData,
    load_pubmed,
    load_pubmed_fullbatch,
)
