"""Convert an fvecs file to headerless raw f32 binary (port of
lab_1806_vec_db_tpu/cli/convert_fvecs.py; the reference's
src/bin/convert_fvecs.rs).

Usage: python -m lab_1806_vec_db_tpu_torch.cli.convert_fvecs INPUT -o OUT [-l LIMIT]
"""

from __future__ import annotations

import argparse

from ..utils import io


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert fvecs to bin")
    ap.add_argument("input_file", help="Path to the input fvecs file")
    ap.add_argument("-o", "--output-file", required=True, help="Path to the output bin file")
    ap.add_argument("-l", "--limit", type=int, default=None)
    args = ap.parse_args(argv)

    print("Converting fvecs to bin...")
    vecs = io.load_fvecs(args.input_file, limit=args.limit)
    if vecs.size:
        print(f"Dimension: {vecs.shape[1]}")
    io.save_raw(args.output_file, vecs)
    print(f"Done! {len(vecs)} vectors written.")


if __name__ == "__main__":
    main()
