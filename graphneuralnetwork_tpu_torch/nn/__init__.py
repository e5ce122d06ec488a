from .conv import DenseGATConv, GATConv, GCNConv, SAGEConv  # noqa: F401
from .han import (  # noqa: F401
    HAN,
    DenseHAN,
    DenseHANLayer,
    HANLayer,
    SemanticAttention,
)
from .models import GAT, GCN, DenseGAT, GraphSAGE  # noqa: F401
