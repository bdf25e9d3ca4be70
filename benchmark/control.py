"""The control of a cell's check: the reference one precision below the
configuration's, put in the program's place and judged by the same harness.
A sound check comes out not correct on it.  For float32 rows the reference's
products are in TF32 (`reference.control_topk`).  For uint8 rows (TF32 is
exact on 8-bit integers, so it would pass any uint8 check) it answers with the
reference's exact formula over rows and queries whose lowest bit is cleared:
7-bit values.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 4

prints one JSON line per seed with the check's numbers (the upper readings
the limits in `cells/` are set from).  The benchmark's own runs never run
it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import reference  # noqa: E402


class Control:
    """Answers a cell's calls with `reference.control_topk` on the card, or
    for uint8 rows with `reference.exact_topk` of the values & `U8_MASK`."""

    U8_MASK = 0xFE  # the lowest bit cleared

    def __init__(self, ctx):
        import torch

        rows = ctx.make_rows()
        self.dist, self.k, self.device = ctx.config["dist"], ctx.traffic["k"], ctx.device
        self.u8 = rows.dtype == torch.uint8
        if self.u8:
            self.rows, self.norm = rows & self.U8_MASK, None
            return
        sq = (rows * rows).sum(-1)
        self.norm = sq if self.dist == "l2sqr" else sq.sqrt()
        self.rows = reference.tf32(rows)

    def call(self, q):
        import torch

        qd = torch.from_numpy(q.reshape(-1, q.shape[-1])).to(self.device)
        if self.u8:
            d, i = reference.exact_topk(self.rows, qd & self.U8_MASK, self.k, self.dist)
        else:
            d, i = reference.control_topk(self.rows, self.norm, qd, self.k, self.dist)
        return d.cpu().numpy(), i.cpu().numpy()

    def answers(self, raw, k):
        import numpy as np

        d, i = raw
        return i.astype(np.int64), d.astype(np.float64), np.zeros(len(i), bool)

    def close(self):
        self.rows = self.norm = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload, core.load_json(os.path.join(ROOT, "BENCHMARK.json")))
    for seed in (int(s) for s in args.seeds.split(",")):
        out = core.run_cell(cell, seed, args.seconds, False, "cuda", setup=Control)
        print(json.dumps({"cell": cell.name, "side": "control", "seed": seed,
                          "correct": out["result"]["correct"], **out["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
