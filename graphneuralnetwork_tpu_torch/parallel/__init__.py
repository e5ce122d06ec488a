"""Data and graph parallelism on ``torch.distributed``: the port of
``graphneuralnetwork_tpu/parallel/`` but for its tensor-parallel rules
(``tp.py``) and its sharded wedge plan (``gtn_sparse.py``), which are still
to be ported. One process per device; NCCL on CUDA, gloo on the CPU."""

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
