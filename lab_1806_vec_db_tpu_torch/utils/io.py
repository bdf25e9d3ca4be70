"""Raw vector file IO (port of the raw-file part of
lab_1806_vec_db_tpu/utils/io.py).

Headerless raw binary of `len x dim` scalars, row-major (the reference's
`VecSet::load_raw_file` / `save_raw_file`, src/vec_set.rs:168-192), for the
two table dtypes {float32, uint8} (src/config.rs:20-27).  Loaders return
host numpy arrays; the index layer uploads them.  The fvecs reader and the
rest of the reference module are not ported yet (ROADMAP.md queue 1,
item 15).
"""

from __future__ import annotations

import os

import numpy as np

_DTYPES = {
    "float32": np.float32,
    "uint8": np.uint8,
}


def dtype_from_name(name: str) -> np.dtype:
    try:
        return np.dtype(_DTYPES[name])
    except KeyError:
        raise ValueError(f"Unsupported data_type: {name!r} (expected one of {sorted(_DTYPES)})")


def load_raw(path: str | os.PathLike, dim: int, dtype="float32", limit: int | None = None) -> np.ndarray:
    """An (n, dim) array from a headerless raw file; `limit` caps the rows
    read (`VecDataConfig.limit`), and without it the file must hold whole
    rows."""
    if dim <= 0:
        raise ValueError("dim must be positive")
    dt = np.dtype(dtype) if not isinstance(dtype, str) else dtype_from_name(dtype)
    count = -1 if limit is None else limit * dim
    data = np.fromfile(os.fspath(path), dtype=dt, count=count)
    n = len(data) // dim
    if n * dim != len(data) and limit is None:
        raise ValueError(f"File size {len(data)} elements is not a multiple of dim={dim}")
    return data[: n * dim].reshape(n, dim)


def save_raw(path: str | os.PathLike, vectors: np.ndarray) -> None:
    """Write the rows as a headerless raw file."""
    np.ascontiguousarray(vectors).tofile(os.fspath(path))
