"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

The sources are compiled at first use into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds): one nvcc per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <obj>.o csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libvecdb_<hash>.so <obj>.o ...

The library lands in `lab_1806_vec_db_tpu_torch/_build/` (git-ignored),
named by a hash of the sources and flags, so an edit to any source triggers a
rebuild and an unchanged tree reuses the library.  Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# facts about the build of this process: seconds spent compiling (0 when
# the library was already built), the library path, nvcc's -Xptxas -v output
# (read back from the build's log file when the library was already built)
build_info: dict = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc") if os.environ.get("CUDA_HOME") else "",
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.vecdb_scan_int8_packed.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.vecdb_scan_int8_packed.restype = I
    lib.vecdb_scan_u8_exact.argtypes = [P] * 5 + [I] * 6 + [P]
    lib.vecdb_scan_u8_exact.restype = I
    lib.vecdb_scan_int8_binned.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.vecdb_scan_int8_binned.restype = I
    lib.vecdb_scan_bf16_chunkmin.argtypes = [P] * 6 + [I] * 7 + [P]
    lib.vecdb_scan_bf16_chunkmin.restype = I
    lib.vecdb_scan_int8_bf16.argtypes = [P] * 8 + [I] * 7 + [P]
    lib.vecdb_scan_int8_bf16.restype = I
    lib.vecdb_gather_dists.argtypes = [P, P, P, P, I, I, I, L, I, P]
    lib.vecdb_gather_dists.restype = I
    lib.vecdb_beam_pre.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.vecdb_beam_pre.restype = I
    lib.vecdb_beam_post.argtypes = [P] * 9 + [I] * 4 + [P]
    lib.vecdb_beam_post.restype = I
    lib.vecdb_traverse.argtypes = [P] * 6 + [I, I, L] + [I] * 6 + [L, I, P]
    lib.vecdb_traverse.restype = I
    lib.vecdb_traverse_ctas_per_sm.argtypes = [I, L, P]
    lib.vecdb_traverse_ctas_per_sm.restype = I
    lib.vecdb_merge_sorted.argtypes = [P] * 8 + [I] * 3 + [P]
    lib.vecdb_merge_sorted.restype = I
    lib.vecdb_adc_chunkmin.argtypes = [P] * 5 + [ctypes.c_float, P, P] + [I] * 8 + [P]
    lib.vecdb_adc_chunkmin.restype = I
    lib.vecdb_adc_chunkmin_binned.argtypes = [P] * 5 + [ctypes.c_float] + [P] * 4 + [I] * 7 + [P]
    lib.vecdb_adc_chunkmin_binned.restype = I
    lib.vecdb_adc_sums_dense.argtypes = [P] * 4 + [I] * 7 + [P]
    lib.vecdb_adc_sums_dense.restype = I
    lib.vecdb_adc_sums_ids.argtypes = [P] * 4 + [I] * 6 + [L] + [I] * 4 + [P]
    lib.vecdb_adc_sums_ids.restype = I
    lib.vecdb_scan_exact_small.argtypes = [P] * 7 + [I] * 7 + [P]
    lib.vecdb_scan_exact_small.restype = I
    lib.vecdb_scan_exact_small_ctas_per_sm.argtypes = [I] * 4 + [P]
    lib.vecdb_scan_exact_small_ctas_per_sm.restype = I
    lib.vecdb_select_survivors.argtypes = [P] * 3 + [I] * 3 + [P]
    lib.vecdb_select_survivors.restype = I
    lib.vecdb_error_string.argtypes = [I]
    lib.vecdb_error_string.restype = ctypes.c_char_p


def _compile_and_link(srcs: list[str], out: str) -> str:
    """Compile every source in parallel, link them into `out`; returns the
    compiler output.  Everything is built under a private directory and
    renamed into place, so concurrent builds never load a half-written
    library."""
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        failed = [p for p, proc in zip(srcs, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {[os.path.basename(p) for p in failed]}:\n{log}")
        lib_tmp = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp, *objs],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(lib_tmp, out)
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [p for p in sources() if p.endswith(".cu")]
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"libvecdb_{_digest(sources())}.so")
        log_path = out[: -len(".so")] + ".log"  # nvcc's report, kept for a later process
        t0 = time.perf_counter()
        if not os.path.exists(out):
            log = _compile_and_link(srcs, out)
            tmp = f"{log_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(log)
            os.replace(tmp, log_path)
        elif os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        else:
            log = ""
        build_info.update(seconds=time.perf_counter() - t0, path=out, log=log)
        lib = ctypes.CDLL(out)
        _declare(lib)
        _lib = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    cudaGetLastError() right after the launch)."""
    if status != 0:
        msg = library().vecdb_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
