"""Host and device samplers of the sampled GraphSAGE pipeline (the parts of
``graphneuralnetwork_tpu/sampling/`` that it uses)."""

from .alias import build_alias_table, sample_alias  # noqa: F401
from .neighbor import multihop_sampling, sample_neighbors  # noqa: F401
from .skipgram import NegativeSampler  # noqa: F401
from .walks import csr_from_edges, uniform_walks  # noqa: F401
