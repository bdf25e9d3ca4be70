"""KMeans component class (port of models/kmeans.py).

Parity target: `KMeans` / `KMeansConfig` (reference: src/distance/k_means.rs:14-37)
including the `selected` dim-range restriction (k_means.rs:30,105-109),
`find_nearest` (k_means.rs:166-170) and `find_n_nearest` (k_means.rs:174-191).
The compute runs through `ops/kmeans.py` on the given device; the seed feeds
a `torch.Generator`, so a seed gives other centroids than the JAX package's
(jax.random and torch draw different numbers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kmeans as KM
from ..utils.config import KMeansConfig
from ..utils.device import resolve


class KMeans:
    def __init__(self, config: KMeansConfig, centroids: np.ndarray, device="cuda"):
        self.config = config
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.torch_device = resolve(device)
        self._dev = None

    @classmethod
    def from_numpy(cls, vectors: np.ndarray, config: KMeansConfig, seed: int = 0,
                   device="cuda") -> "KMeans":
        if config.k <= 0:
            raise ValueError("The number of clusters should be greater than 0.")
        dev = resolve(device)
        data = np.asarray(vectors, dtype=np.float32)
        if config.selected is not None:
            lo, hi = config.selected
            if hi > data.shape[1]:
                raise ValueError("selected range out of bounds")
            data = data[:, lo:hi]
        x = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        init = KM.kmeanspp_init(x, len(x), config.k, config.dist, gen)
        cent = KM.lloyd(x, len(x), init, config.max_iter, config.tol, config.dist)
        return cls(config, cent.cpu().numpy(), device=dev)

    def _select(self, v: np.ndarray) -> np.ndarray:
        if self.config.selected is not None:
            lo, hi = self.config.selected
            return v[..., lo:hi]
        return v

    def _device(self) -> torch.Tensor:
        if self._dev is None:
            self._dev = torch.from_numpy(self.centroids).to(self.torch_device)
        return self._dev

    def _rows(self, v) -> torch.Tensor:
        v = self._select(np.atleast_2d(np.asarray(v, np.float32)))
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.torch_device)

    def find_nearest(self, v) -> int:
        return int(KM.find_nearest(self._rows(v), self._device(), self.config.dist)[0])

    def find_nearest_batch(self, vs) -> np.ndarray:
        return KM.find_nearest(self._rows(vs), self._device(), self.config.dist).cpu().numpy()

    def find_n_nearest(self, v, n_probes: int) -> list[int]:
        _, ids = KM.find_n_nearest(self._rows(v), self._device(), n_probes, self.config.dist)
        return [int(x) for x in ids[0].cpu()]
