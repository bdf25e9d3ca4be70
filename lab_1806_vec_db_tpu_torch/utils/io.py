"""Raw vector file IO (port of lab_1806_vec_db_tpu/utils/io.py).

- headerless raw binary of `len x dim` scalars, row-major (the reference's
  `VecSet::load_raw_file` / `save_raw_file`, src/vec_set.rs:168-192), for
  the two table dtypes {float32, uint8} (src/config.rs:20-27);
- fvecs records, `u32 dim` then `dim` f32 values per vector
  (src/bin/convert_fvecs.rs:29-48).

Loaders return host numpy arrays; the index layer uploads them.
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


def dtype_to_name(dtype) -> str:
    dtype = np.dtype(dtype)
    for name, dt in _DTYPES.items():
        if np.dtype(dt) == dtype:
            return name
    raise ValueError(f"Unsupported dtype: {dtype}")


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


def load_fvecs(path: str | os.PathLike, limit: int | None = None) -> np.ndarray:
    """An (n, dim) f32 array from an fvecs file (records of u32 dim and dim
    f32 values); `limit` caps the records read.  Every record must have the
    first one's dim."""
    raw = np.fromfile(os.fspath(path), dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.uint32)[0])
    record = 4 + 4 * dim
    n = raw.size // record
    if n * record != raw.size:
        raise ValueError("fvecs file size is not a multiple of the record size")
    if limit is not None:
        n = min(n, limit)
    recs = raw[: n * record].reshape(n, record)
    if not np.all(recs[:, :4].copy().view(np.uint32).reshape(n) == dim):
        raise ValueError("fvecs records have inconsistent dims")
    return recs[:, 4:].copy().view(np.float32).reshape(n, dim)
