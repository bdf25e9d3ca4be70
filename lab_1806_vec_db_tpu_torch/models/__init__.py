from .store import VecStore
from .flat import FlatIndex
from . import base

__all__ = ["VecStore", "FlatIndex", "base"]
