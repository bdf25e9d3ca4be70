"""Checkpoint serialization helpers.

The reference serializes whole structures with bincode and writes them
atomically (tmp file then copy — src/database/thread_save.rs:11-21).
Here a checkpoint is a single `.npz`-style zip of named numpy arrays plus a
JSON metadata blob, written atomically via tmp-file + os.replace.

Two checkpoint shapes exist, as in the reference (src/index_algorithm/mod.rs:120-148):
- whole structure (arrays include the vectors)
- index-without-vectors (topology only; vectors stored once as a raw file)
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> None:
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_arrays(path: str | os.PathLike, arrays: dict[str, np.ndarray], meta: dict) -> None:
    """Atomically save named arrays + JSON metadata to one file."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        payload = dict(arrays)
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        )
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_arrays(path: str | os.PathLike) -> tuple[dict[str, np.ndarray], dict]:
    with np.load(os.fspath(path), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8")) if "__meta__" in z.files else {}
    return arrays, meta
