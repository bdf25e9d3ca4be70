from . import api

__all__ = ["api"]
