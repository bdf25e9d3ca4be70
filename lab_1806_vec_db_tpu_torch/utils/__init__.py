from . import config, candidates, serde, device

__all__ = ["config", "candidates", "serde", "device"]
