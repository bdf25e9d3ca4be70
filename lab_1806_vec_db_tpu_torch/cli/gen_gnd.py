"""Exact ground truth of a test set against a base set (port of
lab_1806_vec_db_tpu/cli/gen_gnd.py; the reference's src/bin/gen_gnd.rs).

The exact f32 scan (`FlatIndex.knn_batch(..., exact=True)`) runs on the
card in batches of 256 queries; `--device cpu` runs it on the CPU.  The
output is the `GroundTruth` npz both packages read.

Usage: python -m lab_1806_vec_db_tpu_torch.cli.gen_gnd --base BASE --test TEST -o OUT
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models import FlatIndex
from ..utils import io
from ..utils.candidates import GroundTruth

BATCH = 256  # queries per exact scan


def exact_ids(base: np.ndarray, test: np.ndarray, k: int, dist: str, device="cuda") -> np.ndarray:
    """(len(test), k) int32 ids of each query's exact top-k over `base`."""
    index = FlatIndex.from_numpy(base, dist, device=device)
    rows = [index.knn_batch(test[s : s + BATCH], k, exact=True)[1] for s in range(0, len(test), BATCH)]
    return np.concatenate(rows, axis=0) if rows else np.zeros((0, k), np.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Generate ground truth by FlatIndex")
    ap.add_argument("-d", "--dim", type=int, default=960)
    ap.add_argument("--base", default="data/gist.local.bin")
    ap.add_argument("--test", default="data/gist_test.bin")
    ap.add_argument("-o", "--out", default="data/gnd.local.npz")
    ap.add_argument("--dist-fn", default="L2Sqr", choices=["L2Sqr", "Cosine"])
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = io.load_raw(args.base, args.dim, "float32")
    print(f"Loaded base set (size: {len(base)}).")
    test = io.load_raw(args.test, args.dim, "float32")
    print(f"Loaded test set (size: {len(test)}).")
    print("Generating ground truth...")
    gt = GroundTruth(exact_ids(base, test, args.k, args.dist_fn.lower(), args.device))
    print(f"Saving ground truth to {args.out}...")
    gt.save(args.out)


if __name__ == "__main__":
    main()
