from .bine import BiNEConfig, train_bine  # noqa: F401
from .embedding import (  # noqa: F401
    LINEConfig,
    SDNEConfig,
    WalkEmbedConfig,
    run_deepwalk,
    run_line,
    run_metapath2vec,
    run_node2vec,
    run_sdne,
    run_struc2vec,
)
from .gatne import GATNEConfig, evaluate_gatne, train_gatne  # noqa: F401
