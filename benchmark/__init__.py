"""The benchmark of `lab_1806_vec_db_tpu_torch` on one NVIDIA H100: see
`run.py` (the one command), `core.py` (a run) and `PERF.md` at the root."""
