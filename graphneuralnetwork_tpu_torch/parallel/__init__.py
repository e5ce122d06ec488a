"""Data, graph and tensor parallelism on ``torch.distributed``: the port of
``graphneuralnetwork_tpu/parallel/``, with the tensor-parallel rules
(``tp.py``) and their Megatron-style models (``tp_models.py``) and the
sharded wedge plan (``gtn_sparse.py``). One process per device; NCCL on
CUDA, gloo on the CPU."""

from .sharded import (  # noqa: F401
    ShardedGraph,
    aggregate_sharded,
    partition_graph,
    shard_nodes,
    spmm_sharded,
)
from .halo_attention import gat_halo, gat_halo_attend  # noqa: F401
from .halo import (  # noqa: F401
    HaloGraph,
    boundary_edge_fraction,
    partition_graph_halo,
    partition_graph_halo_clustered,
    segment_max_halo,
    shard_nodes_halo,
    spmm_halo,
)
from .multihost import (  # noqa: F401
    Mesh,
    initialize_distributed,
    is_primary,
    make_mesh,
    process_count,
)
from .tp import (  # noqa: F401
    MODEL_RULES,
    ShardRule,
    apply_tp,
    gcn_param_shardings,
    make_tp_mesh,
    model_param_shardings,
    param_shardings,
    shard_rows,
)
