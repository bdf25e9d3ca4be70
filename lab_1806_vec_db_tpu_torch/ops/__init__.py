from . import distance, topk, scan, gather

__all__ = ["distance", "topk", "scan", "gather"]
