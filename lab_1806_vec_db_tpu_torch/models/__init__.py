from .store import ScanMode, VecStore
from .flat import FlatIndex
from .hnsw import HNSWIndex
from .ivf import IVFIndex
from .ivfpq import IVFPQIndex
from .kmeans import KMeans
from .pq_table import PQTable
from .pq_codes import PQCodesIndex
from .u8 import FlatIndexU8, U8VecSet
from . import base, native

__all__ = ["ScanMode", "VecStore", "FlatIndex", "HNSWIndex", "IVFIndex", "IVFPQIndex", "KMeans", "PQTable",
           "PQCodesIndex", "FlatIndexU8", "U8VecSet", "base", "native"]
