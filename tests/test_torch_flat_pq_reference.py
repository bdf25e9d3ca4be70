"""Flat+PQ search (`FlatIndex.knn_pq_batch`) against the plain reference
`benchmark/reference_pq.py`, on the CPU, where every kernel runs its plain
version.  Seeded Gist-spectrum rows (20,000 x 96), a table trained through
the table's defaults function (`table_config`: m 32, 4 bits), 16 queries:

- the table: the program's codes are the reference's encode, its int8 lookup
  the reference's rounding of the reference's lookup (up to entries at a
  rounding boundary);
- the K7 plan (ef 64): every kept candidate is its chunk's ADC minimum under
  the table's scan permutation, its ADC distance the reference's to rtol
  1e-5, the chunks kept the reference's best max(ef, k) (ties allowed), the
  answers the reference's exact rerank of those candidates, and the
  reference's own chunk plan's;
- the dense K8 / K9 plan (ef 200): the candidates are the reference's row
  plan on the program's lookup, the answers the reference's row plan under
  the int8 lookup, and the upstream row plan's but where the two lookups
  keep other candidates;
- the route's spans and counters;
- `table_config` against `VecDB.build_pq_table`: the same `PQConfig`, the
  same refusals.
"""

import numpy as np
import pytest
import torch

from benchmark import reference_pq as R
from benchmark.compare_pq import program_lut
from benchmark import synth
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import FlatIndex, PQTable
from lab_1806_vec_db_tpu_torch.models.pq_table import table_config
from lab_1806_vec_db_tpu_torch.ops import pq as P
from lab_1806_vec_db_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

N, DIM, M, B, K = 20_000, 96, 32, 16, 10
EF_K7, EF_DENSE = 64, 200  # 625 chunks of 32 rows: K7 takes k_out <= 156, the dense sums above


@pytest.fixture(scope="module", params=["l2sqr", "cosine"])
def setup(request):
    dist = request.param
    rows = synth.make_device(N, DIM, 29, "cpu")
    queries = synth.make_device(B, DIM, 30, "cpu")
    pq = PQTable.train(rows, table_config(N, DIM, dist, None, None, M), seed=31, device="cpu")
    flat = FlatIndex.from_numpy(rows.numpy(), dist, device="cpu")
    table = R.Table(pq.codebooks, DIM, dist, pq.rotation, pq.center)
    return dist, rows, queries, pq, flat, table


def test_groups_are_the_upstream_split():
    for dim, m in ((960, 320), (96, 32), (100, 7), (13, 13), (5, 1)):
        assert R.groups(dim, m) == P.pq_groups(dim, m)


def test_codes_are_the_reference_encode(setup):
    """Equal, up to rows whose two nearest centroids tie within float32's
    rounding."""
    dist, rows, _, pq, _, table = setup
    ref = table.encode(rows)
    prog = torch.from_numpy(pq.codes.astype(np.int64))
    diff = (ref != prog).nonzero()
    assert len(diff) <= 1e-4 * prog.numel()
    for r, g in diff.tolist():
        s, e = table.groups[g]
        x = table.transform(rows[r : r + 1])[0, s:e]
        c = table.codebooks[g, :, : e - s]
        d = ((x - c) ** 2).sum(-1) if dist == "l2sqr" else 1 - (c @ x) / (c.norm(dim=1) * x.norm())
        assert float(d[prog[r, g]] - d[ref[r, g]]) <= 1e-6 * float(d.abs().max())


@pytest.mark.parametrize("ef", [EF_K7, EF_DENSE])
def test_lookup_is_the_references_rounding(setup, ef):
    """The f32 lookup is the reference's to rounding; its int8 entries the
    reference's rounding of its own lookup, up to entries that lie within
    1e-3 of a rounding boundary, which may differ by one."""
    _, _, queries, pq, _, table = setup
    lookup, _, _, lut = program_lut(pq, queries, max(ef, K))
    ref_f, _ = table.lookup(queries)
    scale = ref_f.abs().amax(dim=(1, 2))[:, None, None]
    assert ((lookup.double() - ref_f).abs() <= 1e-5 * scale).all()
    ref = R.Lut.of(table, queries, rounded=True)
    torch.testing.assert_close(lut.scales.double(), ref.scales, rtol=1e-6, atol=0)
    off = lut.values != ref.values
    assert ((lut.values - ref.values).abs() <= 1).all()
    frac = (table.lookup(queries)[0] / ref.scales[:, None, None]).frac().abs()
    assert ((frac[off] - 0.5).abs() < 1e-3).all()


def test_k7_plan_against_the_reference(setup):
    dist, rows, queries, pq, flat, table = setup
    k_out = max(EF_K7, K)
    assert pq.takes_k7(k_out)
    lookup, q_norms, lut, ref_lut = program_lut(pq, queries, k_out)
    d, cand = pq.adc_scan(lookup, q_norms, k_out, lut=lut)
    codes = torch.from_numpy(pq.codes.astype(np.int64))
    perm = pq.device_scan()[1].numpy()
    assert np.array_equal(perm, R.scan_perm(N))
    ref = R.chunk_plan(table, rows, queries, K, EF_K7, codes=codes, lut=ref_lut)
    cand = cand.long()
    assert (cand >= 0).all()
    inv = torch.empty(N, dtype=torch.int64)
    inv[torch.from_numpy(perm).long()] = torch.arange(N)
    pos = inv[cand]
    chunk = pos // R.CHUNK
    # each candidate is its chunk's ADC minimum, the lowest position on ties
    assert torch.equal(torch.gather(ref["min_pos"], 1, chunk), pos)
    # its ADC distance is the reference's
    torch.testing.assert_close(d.double(), torch.gather(ref["minima"], 1, chunk), rtol=1e-5, atol=0)
    # the chunks kept are the reference's best k_out, ties at the last place allowed
    last = ref["cand_adc"][:, -1:]
    kept = (chunk[:, :, None] == ref["chunks"][:, None, :]).any(2)
    assert (kept | (torch.gather(ref["minima"], 1, chunk) == last)).all()
    assert (d.double() <= last * (1 + 1e-6)).all()
    # the answers are the reference's exact rerank of those candidates
    got_d, got_i = flat.knn_pq_batch(queries.numpy(), K, EF_K7, pq)
    want_d, want_i = R.rerank(rows, queries, cand, K, dist)
    assert np.array_equal(got_i, want_i.numpy())
    np.testing.assert_allclose(got_d, want_d.numpy(), rtol=1e-5, atol=1e-6)
    # and the reference's own chunk plan's, on its own codes and lookup
    own = R.chunk_plan(table, rows, queries, K, EF_K7)
    assert np.array_equal(got_i, own["ids"].numpy())


def test_dense_plan_against_the_reference(setup):
    """The dense plan is the row plan under the int8 lookup.  Against the
    upstream's row plan (a float lookup) its answers differ only where the
    two lookups keep other candidates near the ef-th place, at most 5% of
    the answered rows: at these seeds 1 of 160 (l2sqr: a row at float ADC rank 207 that the
    int8 lookup keeps, the exact 11th row, in place of the exact 12th) and
    5 of 160 (cosine, whose table's self-test reads 0.378)."""
    dist, rows, queries, pq, flat, table = setup
    k_out = max(EF_DENSE, K)
    assert not pq.takes_k7(k_out)
    lookup, q_norms, lut, ref_lut = program_lut(pq, queries, k_out)
    assert lut is None
    d, cand = pq.adc_scan(lookup, q_norms, k_out)
    codes = torch.from_numpy(pq.codes.astype(np.int64))
    ref = R.row_plan(table, rows, queries, K, EF_DENSE, codes=codes, lut=ref_lut)
    torch.testing.assert_close(d.double(), ref["cand_adc"], rtol=1e-5, atol=1e-6)
    last = ref["cand_adc"][:, -1:]
    same = (cand.long()[:, :, None] == ref["cand"][:, None, :]).any(2)
    assert (same | (d.double() >= last * (1 - 1e-6))).all()
    got_d, got_i = flat.knn_pq_batch(queries.numpy(), K, EF_DENSE, pq)
    want_d, want_i = R.rerank(rows, queries, cand, K, dist)
    assert np.array_equal(got_i, want_i.numpy())
    own = R.row_plan(table, rows, queries, K, EF_DENSE, lut=R.Lut.of(table, queries, rounded=True))
    assert np.array_equal(got_i, own["ids"].numpy())
    upstream = R.row_plan(table, rows, queries, K, EF_DENSE)
    hits = (torch.from_numpy(got_i).long()[:, :, None] == upstream["ids"][:, None, :]).any(2)
    assert int((~hits).sum()) <= 0.05 * B * K
    agree = hits.all(1).numpy()
    np.testing.assert_allclose(got_d[agree], upstream["dists"].numpy()[agree], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ef,route", [(EF_K7, "pq.k7"), (EF_DENSE, "pq.dense")])
def test_spans_of_the_route(setup, ef, route):
    _, _, queries, pq, flat, _ = setup
    with profiling.collect() as spans:
        flat.knn_pq_batch(queries.numpy(), K, ef, pq)
        flat.knn_pq_batch(queries.numpy(), K, ef, pq)
    other = "pq.dense" if route == "pq.k7" else "pq.k7"
    for name in ("flat.knn_pq_batch", "flat.upload", "pq.lookup", "pq.adc", route, "flat.k2", "flat.fetch"):
        assert spans.count[name] == 2, name
    assert spans.count[other] == 0
    assert spans.count["flat.knn_batch"] == 0 and spans.count["flat.k1"] == 0


@pytest.mark.parametrize("args", [(None, None, None), (0.25, 8, 16), (0.5, None, 7), (None, 4, 1)])
def test_table_config_is_what_build_pq_table_trains(args, tmp_path):
    rng = np.random.default_rng(5)
    db = VecDB(str(tmp_path), device="cpu")
    try:
        db.create_table_if_not_exists("t", 24, "cosine")
        db.batch_add("t", rng.standard_normal((300, 24)).astype(np.float32), [{"i": str(i)} for i in range(300)])
        db.build_pq_table("t", *args)
        assert db._inner._table_mgr("t").obj.pq.config == table_config(300, 24, "cosine", *args)
    finally:
        db.close()
    assert table_config(1_000_000, 960, "l2sqr") == table_config(1_000_000, 960, "l2sqr", 0.1, 4, 320)
    cfg = table_config(1_000_000, 960, "l2sqr")
    assert (cfg.m, cfg.n_bits, cfg.k_means_size, cfg.k_means_max_iter, cfg.k_means_tol) == (320, 4, 100_000, 20, 1e-6)


@pytest.mark.parametrize("n,args,message", [
    (0, (None, None, None), "empty table"), (300, (1.5, None, None), "Train proportion"),
    (300, (0.0, None, None), "Train proportion"), (300, (None, 5, None), "n_bits"),
    (300, (None, None, 25), "m must"), (300, (None, None, 0), "m must")])
def test_table_config_refuses_what_build_pq_table_refuses(n, args, message, tmp_path):
    with pytest.raises(RuntimeError, match=message) as want:
        table_config(n, 24, "l2sqr", *args)
    db = VecDB(str(tmp_path), device="cpu")
    try:
        db.create_table_if_not_exists("t", 24, "l2sqr")
        if n:
            db.batch_add("t", np.ones((n, 24), np.float32), [{"i": str(i)} for i in range(n)])
        with pytest.raises(RuntimeError) as got:
            db.build_pq_table("t", *args)
        assert str(got.value) == str(want.value)
    finally:
        db.close()


def test_reference_imports_neither_package_nor_jax():
    import subprocess
    import sys

    code = "import benchmark.reference_pq, sys; print(' '.join(sys.modules))"
    out = subprocess.run([sys.executable, "-c", code], cwd=R.__file__.rsplit("/benchmark/", 1)[0],
                         capture_output=True, text=True, check=True, timeout=300)
    loaded = {m.split(".")[0] for m in out.stdout.split()}
    assert "benchmark" in loaded
    assert not loaded & {"jax", "jaxlib", "lab_1806_vec_db_tpu", "lab_1806_vec_db_tpu_torch"}
