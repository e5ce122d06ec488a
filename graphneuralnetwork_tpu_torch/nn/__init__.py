from .conv import GATConv, GCNConv, SAGEConv  # noqa: F401
from .models import GAT, GCN, GraphSAGE  # noqa: F401
