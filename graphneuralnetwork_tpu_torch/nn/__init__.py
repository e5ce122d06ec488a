from .conv import GATConv, GCNConv  # noqa: F401
from .models import GAT, GCN  # noqa: F401
