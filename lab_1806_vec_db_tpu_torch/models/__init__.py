from .store import VecStore
from .flat import FlatIndex
from .hnsw import HNSWIndex
from . import base

__all__ = ["VecStore", "FlatIndex", "HNSWIndex", "base"]
