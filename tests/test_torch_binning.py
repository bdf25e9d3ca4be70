"""Query binning of the PyTorch port against the JAX package's
`ops/binning.bin_queries`: the same probe maps (made with numpy) give the same
bins and slots, overflow drops included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import binning as JB
from lab_1806_vec_db_tpu_torch.ops import binning as BN

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _both(probe, nlist, qb):
    jb, js = JB.bin_queries(jnp.asarray(probe), nlist, qb)
    tb, ts = BN.bin_queries(torch.from_numpy(probe), nlist, qb)
    return np.asarray(jb), np.asarray(js), tb.numpy(), ts.numpy()


@pytest.mark.parametrize("B,p,nlist,qb", [(64, 3, 16, 32), (200, 4, 8, 16), (33, 5, 5, 128)])
def test_bin_queries_matches_reference(B, p, nlist, qb):
    rng = np.random.default_rng(B + p)
    probe = np.stack([rng.choice(nlist, size=p, replace=False) for _ in range(B)]).astype(np.int32)
    jb, js, tb, ts = _both(probe, nlist, qb)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    assert tb.dtype == np.int32 and ts.dtype == np.int32


def test_bin_queries_overflow_drops_match():
    """Every query probes list 0 first: only qb pairs survive there, the
    rank-0 pairs before any rank-1 pair, and the dropped pairs read -1."""
    B, qb = 40, 8
    rng = np.random.default_rng(1)
    probe = np.stack([np.r_[0, rng.choice(np.arange(1, 6), 2, replace=False)] for _ in range(B)]).astype(np.int32)
    jb, js, tb, ts = _both(probe, 6, qb)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    assert (ts[:, 0] >= 0).sum() == qb
    assert sorted(tb[0].tolist()) == [b for b in range(B) if ts[b, 0] >= 0]


def test_bin_queries_sentinel_list_for_pads():
    """Pad queries routed to a sentinel list nlist (as the binned search
    does) take none of the real lists' slots."""
    B, B_pad, nlist, qb = 20, 128, 4, 128
    rng = np.random.default_rng(2)
    probe = np.stack([rng.choice(nlist, 2, replace=False) for _ in range(B_pad)]).astype(np.int32)
    probe[B:] = nlist
    jb, js, tb, ts = _both(probe, nlist + 1, qb)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    real = tb[:nlist]
    assert real.max() < B and (ts[:B] >= 0).all()
