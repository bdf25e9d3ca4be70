from . import config, candidates, serde, device, io

__all__ = ["config", "candidates", "serde", "device", "io"]
