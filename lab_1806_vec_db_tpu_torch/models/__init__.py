from .store import VecStore
from .flat import FlatIndex
from .hnsw import HNSWIndex
from .ivf import IVFIndex
from .kmeans import KMeans
from .pq_table import PQTable
from . import base

__all__ = ["VecStore", "FlatIndex", "HNSWIndex", "IVFIndex", "KMeans", "PQTable", "base"]
