"""Inputs for K4 / K5 (`ops/beam_fused.py:beam_pre` / `beam_post`) and K6
(`ops/merge.py:merge_sorted`), as numpy arrays drawn from a
`np.random.Generator`: the states that tests/test_torch_beam.py holds on the
CPU, chip_smoke.py on the card and bench/time_adc.py times.

Each K4 / K5 function returns (beam_d, beam_i, beam_e, ring, selq, nbrs, nd,
nids): the beam (B, W) f32 / int32 / int32 ascending in d, the visited ring
(B, R), the selection (B, 128) with E ids in front, the neighbor tile (B,
EL) and the scored tile (B, W) f32 / int32.  `merge_state` returns K6's
(beam_d, beam_i, beam_e, nd, nids).
"""

from __future__ import annotations

import numpy as np


def random_state(rng, B, W, R, EL, E, ef, N):
    """A lock-step iteration's shapes on uniform draws: a sorted beam with a
    -1 tail past ef, half of it expanded; a ring; the selection; a neighbor
    tile with duplicates of beam / ring / tile entries; a scored tile live
    on every lane with an id, one lane tying the beam exactly."""
    beam_i = rng.integers(0, N, (B, W)).astype(np.int32)
    beam_i[:, ef:] = -1
    beam_d = np.sort(rng.random((B, W)).astype(np.float32), axis=1)
    beam_d[beam_i < 0] = np.inf
    beam_e = (rng.random((B, W)) < 0.5).astype(np.int32)
    beam_e[beam_i < 0] = 0
    ring = rng.integers(-1, N, (B, R)).astype(np.int32)
    selq = np.full((B, 128), -1, np.int32)
    selq[:, :E] = rng.integers(-1, N, (B, E))
    nbrs = rng.integers(-1, N, (B, EL)).astype(np.int32)
    nbrs[:, 3], nbrs[:, 5], nbrs[:, 7] = beam_i[:, 0], ring[:, 2], nbrs[:, 1]
    nids = rng.integers(-1, N, (B, W)).astype(np.int32)
    nd = rng.random((B, W)).astype(np.float32)
    nd[nids < 0] = np.inf
    nd[:, 10] = beam_d[:, 2]  # an exact tie with the beam
    return beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids


def loop_state(rng, B, W, R, EL, E, ef, N):
    """An iteration of the lock-step loop (`ops/beam.py:lockstep`) as the
    HNSW+PQ graph route meets it: a beam sorted on a coarse grid of
    distances (ties), ef / 2 to ef lanes filled, (inf, -1, 0) after, 70% of
    them expanded; a ring with 20% holes; the E selected ids; a neighbor
    tile with 10% -1 and a third of its lanes repeating beam, ring or
    earlier tile ids; a scored tile finite only in its first 0..EL lanes
    (fresh ids first, -1 / +inf after), its distances on the beam's grid."""
    lane = np.arange(W)
    tail = lane[None] >= rng.integers(ef // 2, ef + 1, (B, 1))
    beam_d = np.sort(rng.integers(0, 4096, (B, W)).astype(np.float32) / 64, axis=1)
    beam_d[tail] = np.inf
    beam_i = rng.integers(0, N, (B, W)).astype(np.int32)
    beam_i[tail] = -1
    beam_e = ((rng.random((B, W)) < 0.7) & ~tail).astype(np.int32)
    ring = rng.integers(0, N, (B, R)).astype(np.int32)
    ring[rng.random((B, R)) < 0.2] = -1
    selq = np.full((B, 128), -1, np.int32)
    selq[:, :E] = beam_i[:, :E]
    nbrs = rng.integers(0, N, (B, EL)).astype(np.int32)
    pick = rng.random((B, EL))
    src = np.concatenate([beam_i[:, :EL], ring[:, :EL], np.roll(nbrs, 7, 1)], 1)
    dup = np.take_along_axis(src, rng.integers(0, src.shape[1], (B, EL)), 1)
    nbrs = np.where(pick < 0.33, dup, nbrs)
    nbrs[pick > 0.9] = -1
    fresh = lane[None] < rng.integers(0, EL + 1, (B, 1))
    nids = np.where(fresh, rng.integers(0, N, (B, W)), -1).astype(np.int32)
    nd = np.where(fresh, rng.integers(0, 4096, (B, W)) / 64, np.inf).astype(np.float32)
    return beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids


def edge_state(rng, B, W, R, EL, E, ef, N=5000):
    """The edge cases the kernels meet: distances on a grid of 1/8 (ties
    beam / tile and tile / tile), -inf at the front of a fifth of the beams
    and in 2% of the live tile lanes, a beam filled to a random width <=
    min(ef, W) whose last three live lanes are +inf with ids >= 0, then
    (inf, -1, 0); tiles live (d finite) on a random share of all W lanes
    (past lane 128), every fourth row empty, 5% of the live lanes with id
    -1, dead lanes +inf with ids -1 or >= 0; neighbor tiles drawn from 20
    values (beam, ring and random ids) on odd rows; 30% ring holes."""
    lane = np.arange(W)
    fill = rng.integers(0, min(ef, W) + 1, (B, 1))
    tail = lane[None] >= fill
    beam_d = np.sort(rng.integers(0, 64, (B, W)).astype(np.float32) / 8, axis=1)
    beam_d[:, :2] = np.where(rng.random((B, 1)) < 0.2, -np.inf, beam_d[:, :2])
    beam_d[(lane[None] >= fill - 3) | tail] = np.inf
    beam_i = rng.integers(0, N, (B, W)).astype(np.int32)
    beam_i[tail] = -1
    beam_e = ((rng.random((B, W)) < 0.5) & ~tail).astype(np.int32)
    ring = rng.integers(0, N, (B, R)).astype(np.int32)
    ring[rng.random((B, R)) < 0.3] = -1
    selq = np.full((B, 128), -1, np.int32)
    selq[:, :E] = rng.integers(-1, N, (B, E))
    pool = np.concatenate([beam_i[:, :10], ring[:, :5], rng.integers(-1, N, (B, 5))], 1)
    heavy = np.take_along_axis(pool, rng.integers(0, 20, (B, EL)), 1)
    nbrs = rng.integers(-1, N, (B, EL))
    nbrs = np.where((np.arange(B) % 2 == 1)[:, None], heavy, nbrs).astype(np.int32)
    dead = rng.random((B, W)) >= rng.random((B, 1))
    dead[::4] = True
    nd = rng.integers(0, 64, (B, W)).astype(np.float32) / 8
    nd[~dead & (rng.random((B, W)) < 0.02)] = -np.inf
    nd[dead] = np.inf
    nids = rng.integers(0, N, (B, W)).astype(np.int32)
    nids[(dead & (rng.random((B, W)) < 0.5)) | (~dead & (rng.random((B, W)) < 0.05))] = -1
    return beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids


def merge_state(rng, B, ef, EL, N):
    """K6 inputs shaped like a classic-loop iteration's: a sorted (B, ef)
    beam with an inf / -1 tail and expansion flags (bool), an unsorted (B,
    EL) scored tile with stale (inf, -1) lanes and exact ties with the
    beam."""
    beam_d = np.sort(rng.random((B, ef)).astype(np.float32), axis=1)
    beam_i = rng.integers(0, N, (B, ef)).astype(np.int32)
    fill = rng.integers(ef // 2, ef + 1, B)
    tail = np.arange(ef)[None, :] >= fill[:, None]
    beam_d[tail], beam_i[tail] = np.inf, -1
    beam_e = (rng.random((B, ef)) < 0.5) & ~tail
    nids = rng.integers(-1, N, (B, EL)).astype(np.int32)
    nd = rng.random((B, EL)).astype(np.float32)
    nd[:, 5] = beam_d[:, 3]  # exact ties with the beam
    nd[:, 9] = nd[:, 7]      # and within the tile
    nd[nids < 0] = np.inf
    return beam_d, beam_i, beam_e, nd, nids


# K6's edge cases: name -> (B, ef, EL).  `merge_edge_state` draws each one.
MERGE_EDGE_CASES = {
    "ties": (16, 100, 128),        # exact beam / tile and tile / tile ties
    "signed_zero": (8, 64, 64),    # -0 against +0 in the beam and the tile
    "neg_inf": (8, 64, 128),       # -inf at the beam's front and in the tile
    "inf_tails": (12, 120, 128),   # +inf lanes with ids >= 0 in the beam and the tile
    "nan_tile": (8, 64, 128),      # NaN tile lanes, some with ids >= 0; NaN beam tails
    "stale_tile": (6, 50, 64),     # every tile lane (inf, -1)
    "single_live": (8, 96, 128),   # a beam with one live entry
    "wide_tile": (8, 40, 256),     # EL > ef
    "odd_ef": (8, 181, 128),       # rows 4 * 181 bytes apart: no 16-byte vector lanes
    "one_query": (1, 600, 128),    # B = 1
}
# K6 at its widest shapes (ef + EL = 8,192, the wrapper's limit), on the
# "ties" draw: held on the card only
MERGE_WIDE_SHAPES = ((2, 8064, 128), (2, 4096, 4096), (2, 192, 8000))


def merge_edge_state(rng, case, shape=None, N=5000):
    """K6 inputs for one of MERGE_EDGE_CASES (`shape` = (B, ef, EL)
    overrides its shape).  The base draw: distances on a grid of 1/8 (ties
    beam / tile and tile / tile), a beam filled to a random width in [1, ef]
    then (inf, -1, False), half of it expanded, a tile with 30% stale (inf,
    -1) lanes; each case then edits it as MERGE_EDGE_CASES says."""
    B, ef, EL = MERGE_EDGE_CASES[case] if shape is None else shape
    fill = rng.integers(1, ef + 1, (B, 1))
    tail = np.arange(ef)[None, :] >= fill
    beam_d = np.sort(rng.integers(0, 64, (B, ef)).astype(np.float32) / 8, axis=1)
    beam_i = rng.integers(0, N, (B, ef)).astype(np.int32)
    beam_e = (rng.random((B, ef)) < 0.5) & ~tail
    beam_d[tail], beam_i[tail] = np.inf, -1
    nd = rng.integers(0, 64, (B, EL)).astype(np.float32) / 8
    nids = rng.integers(0, N, (B, EL)).astype(np.int32)
    stale = rng.random((B, EL)) < 0.3
    nd[stale], nids[stale] = np.inf, -1
    if case == "signed_zero":  # the beam's first lanes and a third of the tile are +-0
        beam_d[:, :4] = np.where(rng.random((B, 4)) < 0.5, np.float32(-0.0), np.float32(0.0))
        z = rng.random((B, EL)) < 0.3
        nd[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif case == "neg_inf":
        beam_d[:, :2] = -np.inf
        nd[rng.random((B, EL)) < 0.1] = -np.inf
    elif case == "inf_tails":  # the last three live beam lanes +inf, ids kept; stale tile ids kept on half
        live_inf = (np.arange(ef)[None, :] >= fill - 3) & ~tail
        beam_d[live_inf] = np.inf
        nids[stale & (rng.random((B, EL)) < 0.5)] = rng.integers(0, N)
    elif case == "nan_tile":  # odd rows: the beam's tail NaN (sorted last) and 90% of the tile NaN
        odd = (np.arange(B) % 2 == 1)[:, None]
        beam_d[tail & odd] = np.nan
        nd[rng.random((B, EL)) < np.where(odd, 0.9, 0.2)] = np.nan
    elif case == "stale_tile":
        nd[:], nids[:] = np.inf, -1
    elif case == "single_live":
        beam_d[:, 1:], beam_i[:, 1:], beam_e[:, 1:] = np.inf, -1, False
    return beam_d, beam_i, beam_e, nd, nids
