"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; top-level module names are compared
whole (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from benchmark import core

FORBIDDEN = {"jax", "jaxlib", "flax", "lab_1806_vec_db_tpu"}
PROGRAM = "lab_1806_vec_db_tpu_torch"


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"{code}\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=core.ROOT, capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.argv = ['run.py']\nsys.path.insert(0, 'benchmark')\nimport run\n"
            "from benchmark import core, check, reference, trace, roofline, control\n"
            "import lab_1806_vec_db_tpu_torch, lab_1806_vec_db_tpu_torch.models\n"
            "from lab_1806_vec_db_tpu_torch import VecDB\n"
            "import glob, os\n"
            "[core.load_reader(os.path.basename(p)[:-3]) for p in glob.glob('benchmark/metrics/*.py')"
            " if not p.endswith('__init__.py')]\n"
            "[core.load_entry(os.path.basename(p)[:-3]) for p in glob.glob('benchmark/entries/*.py')"
            " if not p.endswith('__init__.py')]")
    loaded = _loaded_after(code)
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("from benchmark import reference, check, synth, synth_u8")
    assert not loaded & (FORBIDDEN | {PROGRAM})


def test_no_source_file_imports_jax():
    for dirpath, _, files in os.walk(core.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not {n.split(".")[0] for n in names} & FORBIDDEN, (f, names)
