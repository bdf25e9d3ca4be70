"""The benchmark of lab_1806_vec_db_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  Prints the
checks (each number compared beside its limit) as the last lines of standard
error and one JSON object as the last line of standard output (see
`core.run_cell`).  Exits non-zero, with no result, without a CUDA device, or
when JAX or the JAX package was loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run could write stays in the checkout, at fixed paths, so the
# first run of a checkout builds and later runs find it built
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_args = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    from benchmark import core

    cell = core.Cell(args.workload, core.load_json(os.path.join(ROOT, "BENCHMARK.json")))
    chips = cell.workload["chips"]
    t_harness = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s): torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"start s: interpreter and arguments {t_args - T0:.3f}, import torch {t_torch - t_args:.3f}, "
          f"harness {t_harness - t_torch:.3f}, CUDA check {time.perf_counter() - t_harness:.3f}",
          file=sys.stderr, flush=True)
    out = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    found = core.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, value, limit, sense in out["checks"]:
        print(f"check {name} {value!r} {sense} {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
