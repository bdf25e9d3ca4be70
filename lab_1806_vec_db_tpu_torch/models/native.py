"""The native (C++) single-query engine (port of models/native.py).

The reference serves one interactive query with a serial C++ search over the
host rows and link arrays.  The port serves a single query on a host
(`device="cpu"`) store with it; a CUDA store answers one query on the card,
where its rows live (`FlatIndex.knn`, `HNSWIndex.knn_with_ef`).  The engine's
source is the package's own copy, `csrc/hnsw_native.cpp` (the reference's
`native/hnsw_native.cpp` with a port header), built at first use with g++
(`native/build.py`'s flags) into `lab_1806_vec_db_tpu_torch/_build/` and
loaded by path as `_vecdb_native`:

    g++ -O3 -std=c++17 -shared -fPIC -fvisibility=hidden -march=native \\
        -funroll-loops -I<python include> csrc/hnsw_native.cpp -o <so>

So a host store's single queries need g++ and the Python headers.  The
library is named by a hash of the source, the flags and the target that
`-march=native` resolves to on this host (`g++ -march=native -Q
--help=target`), so a checkout moved to another CPU builds its own; it is
renamed into place from a private directory, so concurrent first uses (test
workers, threads) never load a half-written file.  A failed build raises with
the compiler's output: the single-query paths do not carry on without it.

Both searches read host arrays that the indexes keep canonical (the store's
f32 rows, HNSW's `links0` and upper levels): nothing is copied per query.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "hnsw_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden", "-march=native",
         "-funroll-loops"]
DIST_CODE = {"l2sqr": 0, "cosine": 1}

_lock = threading.Lock()
_module = None


def _gxx(args: list[str]) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native engine build failed: cannot run g++ ({e})") from e


def _library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_gxx(["-march=native", "-Q", "--help=target"]).stdout.encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"_vecdb_native_{h.hexdigest()[:16]}{suffix}")


def _build(out: str) -> None:
    """Compile the engine into `out` (via a private directory and a rename);
    RuntimeError with g++'s output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        lib_tmp = os.path.join(tmp, os.path.basename(out))
        args = [*FLAGS, f"-I{sysconfig.get_paths()['include']}", SOURCE, "-o", lib_tmp]
        res = _gxx(args)
        if res.returncode != 0:
            raise RuntimeError(f"native engine build failed ({res.returncode}): g++ {' '.join(args)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def module():
    """The loaded `_vecdb_native` extension, building it first if needed."""
    global _module
    with _lock:
        if _module is None:
            path = _library_path()
            if not os.path.exists(path):
                _build(path)
            loader = importlib.machinery.ExtensionFileLoader("_vecdb_native", path)
            spec = importlib.util.spec_from_file_location("_vecdb_native", path, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _module = mod
        return _module


def _query(query, dim: int) -> np.ndarray:
    """One f32 query of `dim` lanes, C-contiguous (the engine reads `dim`
    floats from it unchecked)."""
    q = np.ascontiguousarray(query, dtype=np.float32).reshape(-1)
    if q.shape[0] != dim:
        raise ValueError(f"Dimension mismatch: {q.shape[0]} != {dim}")
    return q


def _array(a: np.ndarray, dtype, what: str) -> np.ndarray:
    """`a` itself when it is a C-contiguous array of `dtype` (the engine
    reads raw buffers unchecked), else ValueError."""
    if not (isinstance(a, np.ndarray) and a.dtype == dtype and a.flags.c_contiguous):
        raise ValueError(f"native engine: {what} must be a C-contiguous {np.dtype(dtype)} array")
    return a


def hnsw_knn_single(index, query: np.ndarray, k: int, ef: int):
    """Serial HNSW search of one query -> (ids, dists) lists: greedy descent
    through the upper levels, then the best-first level-0 beam of width
    max(ef, k), over the index's host rows and links."""
    query = _query(query, index.dim)
    # the store's host rows (materialized once for a device-born store)
    vecs = _array(index.store._host(), np.float32, "the rows")
    links0 = _array(index.links0, np.int32, "links0")
    upper = [(_array(ul.pos, np.int32, "an upper level's pos"),
              _array(ul.links[: max(ul.n, 1)], np.int32, "an upper level's links"))
             for ul in index.upper[: (index.enter_level or 0)]]
    return module().hnsw_knn(vecs, links0, upper, int(index.entry_point), query, int(k),
                             int(max(ef, k)), DIST_CODE[index.dist], len(index.store))


def flat_knn_single(store, query: np.ndarray, k: int):
    """Serial exact scan of one query over the store's host rows -> (ids,
    dists) lists, ties to the lower id."""
    query = _query(query, store.dim)
    vecs = _array(store._host(), np.float32, "the rows")
    return module().flat_knn(vecs, query, len(store), int(k), DIST_CODE[store.dist])
