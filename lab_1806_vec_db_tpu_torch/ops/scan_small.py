"""The exact small-batch scan: the whole exact kNN of a few queries over an
f32 store in one hand-written kernel, `csrc/scan_exact_small.cu` (no TPU
kernel behind it: the JAX package's `knn_scan` is plain XLA).

`topk.knn_scan` hands a call to `exact_scan_small` where `takes_kernel`
holds: CUDA tensors, f32 contiguous rows on a 16-byte boundary, dim % 4 ==
0, 1 <= k <= K_MAX, 1 <= B <= B_MAX and the B queries within the kernel's
shared memory.  That is a rule of shape, read from the inputs: at large B
the blocked GEMM chain is the right algorithm and keeps the call.  On a CPU
tensor `knn_scan` never comes here.

The contract is `knn_scan`'s: (B, k) f32 distances ascending and (B, k)
int32 ids, rows >= n_valid never read, ties to the lower row id, +inf / -1
past the rows there are, id -1 wherever the distance is not finite.  The
arithmetic is the difference form for l2sqr, sum((q - x)^2) in f32 (no
cancellation, unlike the GEMM chain's q^2 + x^2 - 2 q.x), and for cosine
1 - dot / max(|q| |x|, 1e-10) with |x| the store's cache and |q| as
`distance.dist_cache` defines it.

On a CUDA tensor `exact_scan_small` launches the kernel (a scan and a merge
of the CTAs' lists, one call) and counts it in `exact_scan_small.launches`,
or raises; on a CPU tensor it runs the plain version `exact_scan_small_ref`,
the same arithmetic with one stable selection.  There is no fallback from
one to the other.

B_MAX and K_MAX: K_MAX is the kernel's limit (a warp's list holds an entry a
lane).  B_MAX comes from a sweep on an H100 at 200,000 x 960 against the
chain (PERF.md §6).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import distance as D
from . import topk as T  # topk imports this module: names are read at call time

B_MAX = 16  # queries a call: the sweep's widest batch the kernel wins (PERF.md §6)
K_MAX = 32  # neighbors a query: one entry a lane of a warp's list
_QUERY_FLOATS = 48 * 1024  # B * dim within the kernel's 192 KB of shared memory
_MIN_CTA_ROWS = 64  # fewer rows a CTA only adds lists to merge
_REF_FLOATS = 1 << 22  # (B, rows, dim) elements a block of the plain version


def fits(B: int, dim: int, k: int) -> bool:
    """The shape rule: whether the kernel takes B queries of width dim for k
    neighbors."""
    return 1 <= B <= B_MAX and 1 <= k <= K_MAX and dim > 0 and dim % 4 == 0 and B * dim <= _QUERY_FLOATS


def rows_fit(base: torch.Tensor) -> bool:
    """Whether the kernel reads these rows in place: 2-D f32, contiguous,
    on a 16-byte boundary, with int32 row ids."""
    return (base.dim() == 2 and base.dtype == torch.float32 and base.is_contiguous()
            and base.data_ptr() % 16 == 0 and base.shape[0] < 2**31)


def _on_card(queries: torch.Tensor, base: torch.Tensor) -> bool:
    return queries.is_cuda and base.is_cuda


def takes_kernel(queries: torch.Tensor, base: torch.Tensor, k: int) -> bool:
    """Whether `knn_scan` hands this call to the kernel: CUDA tensors,
    `rows_fit` and `fits`."""
    return (_on_card(queries, base) and rows_fit(base) and queries.dim() == 2
            and queries.shape[1] == base.shape[1] and fits(queries.shape[0], base.shape[1], k))


def plan(n: int, ctas_per_sm: int, sms: int) -> tuple[int, int]:
    """(grid, slab): one wave of CTAs, each a contiguous slab of rows, and
    no CTA under _MIN_CTA_ROWS rows where n allows."""
    grid = max(1, min(ctas_per_sm * sms, -(-n // _MIN_CTA_ROWS)))
    return grid, -(-n // grid)


def exact_scan_small_ref(queries, base, base_cache, n_valid: int, k: int, dist: str):
    """Plain PyTorch version: the kernel's arithmetic (difference-form
    l2sqr; cosine by the cached |x| and |q| in float64), then one stable
    selection by (distance, row id).  A NaN distance counts as +inf.
    Returns ((B, k) f32, (B, k) int32)."""
    D.check_dist(dist)
    q = queries.float()
    B = q.shape[0]
    n = max(0, min(int(n_valid), base.shape[0]))
    d = torch.empty((B, n), dtype=torch.float32, device=q.device)
    qn = D.dist_cache(q, "cosine") if dist == "cosine" else None
    step = max(1, _REF_FLOATS // max(1, B * q.shape[1]))
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        x = base[r0:r1].float()
        if dist == "l2sqr":
            diff = x[None, :, :] - q[:, None, :]
            d[:, r0:r1] = (diff * diff).sum(-1)
        else:
            dots = (x[None, :, :] * q[:, None, :]).sum(-1)
            denom = (qn[:, None] * base_cache[None, r0:r1].float()).clamp_min(1e-10)
            d[:, r0:r1] = 1.0 - dots / denom
    d = torch.where(torch.isnan(d), float("inf"), d)
    kk = min(k, n)
    sd, pos = torch.sort(d, dim=1, stable=True)
    out_d = torch.full((B, k), float("inf"), device=q.device)
    out_i = torch.full((B, k), T.INVALID_ID, dtype=torch.int32, device=q.device)
    out_d[:, :kk] = sd[:, :kk]
    out_i[:, :kk] = pos[:, :kk].to(torch.int32)
    return out_d, torch.where(torch.isfinite(out_d), out_i, T.INVALID_ID)


_ctas: dict = {}  # (device index, B, dim, k, cosine) -> (CTAs a SM, SMs)


def _occupancy(dev: torch.device, B: int, dim: int, k: int, cosine: bool) -> tuple[int, int]:
    key = (dev.index, B, dim, k, cosine)
    got = _ctas.get(key)
    if got is None:
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check(_build.library().vecdb_scan_exact_small_ctas_per_sm(
                B, dim, k, int(cosine), ctypes.byref(n)), "scan_exact_small occupancy")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if n.value < 1:
            raise RuntimeError(f"scan_exact_small: no CTA fits an SM at B {B}, dim {dim}, k {k}")
        got = _ctas[key] = (n.value, sms)
    return got


def exact_scan_small(queries, base, base_cache, n_valid: int, k: int, dist: str):
    """Exact kNN of B <= B_MAX queries -> ((B, k) f32 ascending, (B, k)
    int32), `knn_scan`'s contract (module doc).

    queries (B, dim); base (N_pad, dim) f32 with rows >= n_valid as
    padding; base_cache (N_pad,) f32, |x| (read for cosine only).  CPU
    tensors run the plain version; CUDA tensors launch the kernel and count
    the call in `exact_scan_small.launches`, or raise where `takes_kernel`
    does not hold."""
    D.check_dist(dist)
    dev = base.device
    if dev.type == "cpu":
        return exact_scan_small_ref(queries, base, base_cache, n_valid, k, dist)
    if not takes_kernel(queries, base, k) or queries.device != dev or base_cache.device != dev:
        raise ValueError(
            f"scan_exact_small: queries {tuple(queries.shape)} {queries.dtype} on {queries.device}, "
            f"rows {tuple(base.shape)} {base.dtype} on {dev}, k {k}: outside the kernel's rule")
    B, dim = queries.shape
    n = max(0, min(int(n_valid), base.shape[0]))
    cosine = dist == "cosine"
    q = queries.float().contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    norms = base_cache.float().contiguous() if cosine else base
    ctas_per_sm, sms = _occupancy(dev, B, dim, k, cosine)
    grid, slab = plan(n, ctas_per_sm, sms)
    part = torch.empty(2 * B * grid * k, dtype=torch.float32, device=dev)
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_scan_exact_small(
            q.data_ptr(), base.data_ptr(), norms.data_ptr(), part.data_ptr(),
            part.data_ptr() + 4 * B * grid * k, out_d.data_ptr(), out_i.data_ptr(),
            B, dim, n, k, grid, slab, int(cosine), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "scan_exact_small")
    exact_scan_small.launches += 1
    return out_d, out_i


exact_scan_small.launches = 0
