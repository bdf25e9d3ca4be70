from .store import VecStore
from .flat import FlatIndex
from .hnsw import HNSWIndex
from .kmeans import KMeans
from .pq_table import PQTable
from . import base

__all__ = ["VecStore", "FlatIndex", "HNSWIndex", "KMeans", "PQTable", "base"]
