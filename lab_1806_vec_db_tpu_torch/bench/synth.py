"""Gist-spectrum synthetic data (port of bench/synth.py and of the device
generator in bench.py).

`make(n, dim, seed)` is the reference's host generator, drawn from numpy
with the same calls, so the same arguments give the same bytes in both
packages; `main` is its CLI:

    python -m lab_1806_vec_db_tpu_torch.bench.synth -n 200000 --prefix tmp/gist_200k \
        -q 1000 --gnd tmp/gist_200k_test.local.bin

writes `<prefix>.local.bin`, with `-q` `<prefix>_test.local.bin` (queries
from seed + 1), and with `--gnd` the exact ground truth of that test file
(`<prefix>_gnd.local.npz`, the port's exact scan on `--device`).

`gist_spectrum` is a PCA model of the committed real Gist slice
(data/gist_1000.bin + data/gist_test.bin): rows drawn as Gaussians in its
basis, scaled by its spectrum and clipped to >= 0 like real Gist, reproduce
real-Gist distance contrast at dim 960.  `make_device` draws them on a
device from a seeded `torch.Generator` (the counterpart of the reference's
`jax.random` generator in bench.py; the two give different rows from one
seed, with the same distribution).

`make_fill` is the generator of the lean and codes tiers' ingest
(bench.py:make_fill): a row depends only on (seed, row id), through a
counter-based hash instead of a `torch.Generator`, so any block or any set of
ids can be regenerated after the f32 data is gone; `exact_gt_blocked`
computes exact ground truth that way.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_SPECTRUM_CACHE: dict = {}


def gist_spectrum(dim: int, data_dir: str | None = None):
    """(mean, sqrt-eigenvalue scales, basis) of the committed Gist fixture
    slice, cropped to the first `dim` coordinates.  A pure function of the
    fixture bytes."""
    if dim in _SPECTRUM_CACHE:
        return _SPECTRUM_CACHE[dim]
    if data_dir is None:
        data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")
    parts = []
    for name in ("gist_1000.bin", "gist_test.bin"):
        a = np.fromfile(os.path.join(data_dir, name), dtype=np.float32)
        parts.append(a.reshape(-1, 960)[:, :dim])
    x = np.concatenate(parts).astype(np.float64)
    mu = x.mean(0)
    _, sv, vt = np.linalg.svd(x - mu, full_matrices=False)
    scales = sv / np.sqrt(len(x))
    out = (mu.astype(np.float32), scales.astype(np.float32), vt.astype(np.float32))
    _SPECTRUM_CACHE[dim] = out
    return out


def make(n: int, dim: int, seed: int = 0, kind: str = "gist", n_clusters: int = 256,
         spread: float = 0.35) -> np.ndarray:
    """(n, dim) f32 rows on the host: Gist-spectrum Gaussians clipped at 0
    (kind "gist", dim <= 960), else a clustered Gaussian mixture, from
    `np.random.default_rng(seed)` exactly as the reference draws them."""
    rng = np.random.default_rng(seed)
    if kind == "gist" and dim <= 960:
        mu, scales, vt = gist_spectrum(dim)
        z = rng.standard_normal((n, len(scales)), dtype=np.float32)
        z *= scales
        x = z @ vt
        x += mu
        np.clip(x, 0.0, None, out=x)
        return x
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.standard_normal((n, dim)).astype(np.float32)).astype(np.float32)


def make_device(n: int, dim: int, seed: int, device, block_rows: int = 65536) -> torch.Tensor:
    """(n, dim) f32 Gist-spectrum rows drawn on `device` from a
    `torch.Generator` seeded with `seed`, in blocks of `block_rows` (the
    Gaussian block is the only transient)."""
    device = torch.device(device)
    mu_h, scales_h, vt_h = gist_spectrum(dim)
    mu = torch.from_numpy(mu_h).to(device)
    scales = torch.from_numpy(scales_h).to(device)
    vt = torch.from_numpy(vt_h).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for r0 in range(0, n, block_rows):
        rows = min(block_rows, n - r0)
        z = torch.randn((rows, len(scales_h)), generator=gen, device=device)
        torch.addmm(mu, z * scales, vt, out=out[r0 : r0 + rows]).clamp_(min=0.0)
    return out


_M32 = 0xFFFFFFFF
_GEN_ROWS = 65536  # rows per pass of the row generator (bounds its int64 transients)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 in place, for x in [0, 2^32) held as int64: the
    constant is split in 16-bit halves so no product leaves int64."""
    hi = (x * (c >> 16)).bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return x.mul_(c & 0xFFFF).add_(hi).bitwise_and_(_M32)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 integer hash (shifts 16 / 15 / 16, multipliers
    0x7feb352d and 0x846ca68b) of int64 values in [0, 2^32), in place."""
    x.bitwise_xor_(x >> 16)
    _mul32(x, 0x7FEB352D)
    x.bitwise_xor_(x >> 15)
    _mul32(x, 0x846CA68B)
    return x.bitwise_xor_(x >> 16)


def gaussian_rows(ids: torch.Tensor, n_comp: int, seed: int) -> torch.Tensor:
    """(len(ids), n_comp) standard normals, a pure function of (seed, row id,
    component): counter-based, so any set of rows can be drawn alone.
    Component pair (2j, 2j + 1) of row r is the Box-Muller pair of two
    uniforms from hash(hash(r ^ key) + (2j + h) * 0x9E3779B9), h = 0, 1."""
    dev = ids.device
    key = int(_hash32(torch.tensor([seed & _M32], dtype=torch.int64))[0])
    row_h = _hash32(ids.to(torch.int64).bitwise_and(_M32).bitwise_xor_(key))
    pairs = -(-n_comp // 2)
    ctr = torch.arange(2 * pairs, dtype=torch.int64, device=dev).mul_(0x9E3779B9)
    h = _hash32(row_h[:, None].add(ctr[None, :]).bitwise_and_(_M32)).view(-1, pairs, 2)
    u1 = (h[:, :, 0] >> 8).add_(1).float().mul_(2.0 ** -24)  # (0, 1]
    u2 = (h[:, :, 1] >> 8).float().mul_(2.0 ** -24 * 2.0 * np.pi)
    del h
    r = u1.log_().mul_(-2.0).sqrt_()
    z = torch.stack([r * u2.cos(), r.mul_(u2.sin_())], dim=-1)
    return z.view(ids.shape[0], 2 * pairs)[:, :n_comp]


def make_fill(seed: int, dim: int, device):
    """Row-addressable Gist-spectrum generator -> (fill, queries).

    `fill.row_gen(ids)` returns the rows of an int tensor of ids as an
    (len(ids), dim) f32 tensor on `device`: each row is the Gist-spectrum
    model (`z * scales @ vt + mu`, clipped at 0) of the counter-based
    Gaussians of `gaussian_rows`, so it depends only on (seed, id), and a
    consumer can regenerate any id set (the codes tiers' exact refine draws
    the B x ef candidate rows alone).  `fill(row0, rows)` is
    `fill.row_gen(arange(row0, row0 + rows))`.  `queries(n)` draws n query
    rows from a separate seed."""
    device = torch.device(device)
    mu_h, scales_h, vt_h = gist_spectrum(dim)
    mu = torch.from_numpy(mu_h).to(device)
    scales = torch.from_numpy(scales_h).to(device)
    vt = torch.from_numpy(vt_h).to(device)

    def row_gen(ids: torch.Tensor) -> torch.Tensor:
        ids = torch.as_tensor(ids).to(device).reshape(-1)
        out = torch.empty((ids.shape[0], dim), dtype=torch.float32, device=device)
        for r0 in range(0, ids.shape[0], _GEN_ROWS):
            z = gaussian_rows(ids[r0 : r0 + _GEN_ROWS], len(scales_h), seed).mul_(scales)
            rows = z.shape[0]
            # every product has _GEN_ROWS rows, so a row's bits do not depend
            # on how many rows were drawn with it (a GEMM may change its
            # algorithm, and its rounding, with the row count)
            z = torch.nn.functional.pad(z, (0, 0, 0, _GEN_ROWS - rows))
            out[r0 : r0 + rows] = torch.addmm(mu, z, vt)[:rows].clamp_(min=0.0)
        return out

    def fill(row0: int, rows: int) -> torch.Tensor:
        return row_gen(torch.arange(row0, row0 + rows, dtype=torch.int64, device=device))

    def queries(n_queries: int) -> torch.Tensor:
        return make_device(n_queries, dim, (seed << 32) + (1 << 31), device)

    fill.row_gen = row_gen
    return fill, queries


def exact_gt_blocked(fill, n: int, queries: torch.Tensor, k: int, dist: str,
                     block_rows: int = 131072) -> torch.Tensor:
    """Exact f32 top-k ids (B, k) int32 over rows [0, n) of `fill`, without
    ever holding the whole set: regenerate each block, scan it exactly
    (`topk.knn_scan`), merge a running top-k."""
    from ..ops import distance as D
    from ..ops import topk as T

    B = queries.shape[0]
    best_d = torch.full((B, k), float("inf"), device=queries.device)
    best_i = torch.full((B, k), T.INVALID_ID, dtype=torch.int32, device=queries.device)
    for row0 in range(0, n, block_rows):
        rows = min(block_rows, n - row0)
        v = fill(row0, rows)
        td, ti = T.knn_scan(queries, v, D.dist_cache(v, dist), rows, k, dist)
        ti = torch.where(ti >= 0, ti + row0, ti)
        best_d, best_i = T.merge_topk(best_d, best_i, td, ti, k)
    return best_i


def main(argv=None) -> None:
    import argparse

    from ..utils import io
    from ..utils.candidates import GroundTruth

    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, required=True)
    ap.add_argument("-d", "--dim", type=int, default=960)
    ap.add_argument("--prefix", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-q", "--queries", type=int, default=0,
                    help="also write <prefix>_test.local.bin in-distribution queries")
    ap.add_argument("--gnd", default=None, help="also generate ground truth vs this test set")
    ap.add_argument("--gnd-out", default=None)
    ap.add_argument("--device", default="cuda", help="device of the --gnd exact scan")
    args = ap.parse_args(argv)

    base = make(args.n, args.dim, args.seed)
    out = f"{args.prefix}.local.bin"
    io.save_raw(out, base)
    print(f"Wrote {out}: {base.shape}")
    if args.queries:
        # fresh draws from the same distribution: in-distribution queries
        qs = make(args.queries, args.dim, args.seed + 1)
        qout = f"{args.prefix}_test.local.bin"
        io.save_raw(qout, qs.astype(np.float32))
        print(f"Wrote {qout}: {qs.shape}")
    if args.gnd:
        from ..cli.gen_gnd import exact_ids

        test = io.load_raw(args.gnd, args.dim, "float32")
        GroundTruth(exact_ids(base, test, 10, "l2sqr", args.device)).save(
            args.gnd_out or f"{args.prefix}_gnd.local.npz")
        print(f"Wrote ground truth for {len(test)} queries")


if __name__ == "__main__":
    main()
