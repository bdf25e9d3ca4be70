"""K4 and K5: the fused lock-step beam body of the HNSW graph route (port of
ops/pallas_beam.py's `beam_pre` and `beam_post`).

One iteration of the batched level-0 beam search is K4 -> K2 -> K5:

- K4 `beam_pre`: neighbor dedup against the beam, the visited ring and
  earlier lanes of the tile; novel-first compaction (fresh ids to the front
  of the tile, -1 after), the fresh count, and the ring update;
- K2 (`ops/gather.py`) scores the compacted ids;
- K5 `beam_post`: merge of the scored tile into the sorted beam, the ef
  re-mask, and the selection of the next E ids to expand.

Semantics, shared by the kernels (`csrc/beam_pre.cu`, `csrc/beam_post.cu`)
and their plain versions here:

- The visited ring is a SHIFT REGISTER: every iteration shifts it by E lanes
  and writes the ids selected for expansion in front, -1 holes included
  (the reference's documented divergence from the circular ring of the
  classic `ops/beam.py` loop; a ring miss only re-scores a node).
- Merge order is the key (d, rank << 1 | e): beam lane j has rank j, tile
  lane j rank W + j, so ties break toward the beam, then toward the lower
  lane.  Every key is distinct, so any correct merge gives one order: the
  reference's bitonic network (`ops/pallas_merge.py:53-95`) on a sorted
  beam, the kernel's placement of each key by its rank on both sides, and
  the plain version's stable sort of [beam, tile].
- After the merge, lanes >= ef, non-finite distances and ids < 0 become
  (inf, -1, 0); the E lowest-lane unexpanded entries are marked expanded
  and written to sel[0..E), -1 after.

Both kernels only compare and move integers and floats, so on the card they
equal their plain versions bit for bit.  On a CUDA tensor the wrappers
launch the kernel (no fallback); on a CPU tensor they run the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .graph import compact_front, later_duplicates

SEL_LANES = 128  # width of the selection / count rows (the reference's lane tile)
MAX_W = 4096  # widest beam K5 holds in shared memory (2W keys of 12 bytes)


def pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def fresh_mask(nbrs, beam_i, ring) -> torch.Tensor:
    """(B, EL) bool: the tile lanes whose id is >= 0, in neither the beam
    nor the ring, and in no earlier lane of the tile."""
    in_prev = (nbrs[:, :, None] == beam_i[:, None, :]).any(2) | (
        nbrs[:, :, None] == ring[:, None, :]).any(2)
    return (nbrs >= 0) & ~in_prev & ~later_duplicates(nbrs)


def ring_shift(ring: torch.Tensor, selq: torch.Tensor, E: int) -> torch.Tensor:
    """Shift-register ring update: ring' = [selq[:, :E], ring[:, :R - E]]."""
    return torch.cat([selq[:, :E], ring[:, : ring.shape[1] - E]], 1)


def beam_pre_ref(beam_i, ring, selq, nbrs, E: int):
    """Plain PyTorch version of K4 -> (comp (B, W), ring' (B, R), cnt (B, 128))."""
    B, W = beam_i.shape
    fresh = fresh_mask(nbrs, beam_i, ring)
    comp = compact_front(nbrs, fresh, W)
    cnt = fresh.sum(1, dtype=torch.int32)[:, None].expand(B, SEL_LANES).contiguous()
    return comp, ring_shift(ring, selq, E), cnt


def beam_post_ref(beam_d, beam_i, beam_e, nd, nids, ef: int, E: int):
    """Plain PyTorch version of K5 -> (d, i, e (B, W), sel (B, 128))."""
    B, W = beam_d.shape
    d, pos = torch.sort(torch.cat([beam_d, nd], 1), dim=1, stable=True)
    d, pos = d[:, :W], pos[:, :W]
    i = torch.gather(torch.cat([beam_i, nids], 1), 1, pos)
    e = torch.gather(torch.cat([beam_e, torch.zeros_like(beam_e)], 1), 1, pos)
    lane = torch.arange(W, device=d.device)
    alive = (lane < ef) & torch.isfinite(d) & (i >= 0)
    d = torch.where(alive, d, float("inf"))
    i = torch.where(alive, i, -1)
    e = torch.where(alive, e, 0)
    unexp = (e == 0) & (i >= 0)
    selm = unexp & (torch.cumsum(unexp, 1) <= E)
    e = e | selm.to(e.dtype)
    sel = compact_front(i, selm, SEL_LANES)
    return d, i, e, sel


def _check(tensors: dict, dtypes: dict):
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no beam kernel for device {dev}")
    return dev


def beam_pre(beam_i, ring, selq, nbrs, E: int):
    """Dedup + compact a gathered neighbor tile; shift the ring (K4).

    beam_i (B, W) int32 sorted beam ids (-1 padded); ring (B, R) int32;
    selq (B, 128) int32, this iteration's expanded ids in lanes 0..E-1;
    nbrs (B, EL) int32 neighbor ids, -1 invalid, EL a multiple of 32 and
    <= W.  Returns (comp (B, W), ring' (B, R), cnt (B, 128)).  CUDA tensors
    launch the kernel and count it in `beam_pre.launches`."""
    i32 = torch.int32
    dev = _check(dict(beam_i=beam_i, ring=ring, selq=selq, nbrs=nbrs),
                 dict(beam_i=i32, ring=i32, selq=i32, nbrs=i32))
    B, W = beam_i.shape
    R, EL = ring.shape[1], nbrs.shape[1]
    if ring.shape[0] != B or selq.shape != (B, SEL_LANES) or nbrs.shape[0] != B:
        raise ValueError("beam_pre: operands disagree on B or selq is not (B, 128)")
    if not (0 < E <= min(R, SEL_LANES)) or EL % 32 or not 0 < EL <= min(W, 1024):
        raise ValueError(f"beam_pre: need 0 < E <= min(R, 128) and EL a multiple of 32, "
                         f"<= min(W, 1024); got E={E}, EL={EL}, W={W}, R={R}")
    if dev.type == "cpu":
        return beam_pre_ref(beam_i, ring, selq, nbrs, E)
    beam_i, ring, selq, nbrs = (t.contiguous() for t in (beam_i, ring, selq, nbrs))
    comp = torch.empty((B, W), dtype=i32, device=dev)
    ring_out = torch.empty((B, R), dtype=i32, device=dev)
    cnt = torch.empty((B, SEL_LANES), dtype=i32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_beam_pre(
            beam_i.data_ptr(), ring.data_ptr(), selq.data_ptr(), nbrs.data_ptr(),
            comp.data_ptr(), ring_out.data_ptr(), cnt.data_ptr(), B, W, R, EL, E,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "beam_pre")
    beam_pre.launches += 1
    return comp, ring_out, cnt


beam_pre.launches = 0


def beam_post(beam_d, beam_i, beam_e, nd, nids, ef: int, E: int):
    """Merge the scored tile into the beam, re-mask, select the next E (K5).

    beam_d/beam_i/beam_e (B, W) f32/int32/int32, the beam (inf/-1/0
    padded; W a power of two <= 4096); nd/nids (B, W) f32/int32 scored tile
    (inf/-1 on stale lanes; live lanes anywhere in [0, W)).  Returns (d',
    i', e' (B, W), sel (B, 128)).  CUDA tensors launch the kernel and count
    it in `beam_post.launches`.

    Precondition, as for the TPU kernel: each beam row is ascending in d
    (NaN last, as `torch.sort` orders it), so that its keys (d, lane) are
    ascending.  The loop's beams are: K5's output is ascending whenever its
    tile holds no -inf and no finite d with id -1, and the loop gives every
    -1 lane +inf.  The kernel reads only lanes < min(ef, W) of the beam and
    places each key by rank instead of sorting, so it equals this plain
    version only on such beams."""
    i32, f32 = torch.int32, torch.float32
    dev = _check(dict(beam_d=beam_d, beam_i=beam_i, beam_e=beam_e, nd=nd, nids=nids),
                 dict(beam_d=f32, beam_i=i32, beam_e=i32, nd=f32, nids=i32))
    B, W = beam_d.shape
    if any(t.shape != (B, W) for t in (beam_i, beam_e, nd, nids)):
        raise ValueError("beam_post: every operand must be (B, W)")
    if W != pow2(W) or W > MAX_W or not 0 < E <= min(W, SEL_LANES) or ef <= 0:
        raise ValueError(f"beam_post: need W a power of two <= {MAX_W}, 0 < E <= min(W, 128),"
                         f" ef > 0; got W={W}, E={E}, ef={ef}")
    if dev.type == "cpu":
        return beam_post_ref(beam_d, beam_i, beam_e, nd, nids, ef, E)
    beam_d, beam_i, beam_e, nd, nids = (t.contiguous() for t in (beam_d, beam_i, beam_e, nd, nids))
    od = torch.empty((B, W), dtype=f32, device=dev)
    oi = torch.empty((B, W), dtype=i32, device=dev)
    oe = torch.empty((B, W), dtype=i32, device=dev)
    sel = torch.empty((B, SEL_LANES), dtype=i32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_beam_post(
            beam_d.data_ptr(), beam_i.data_ptr(), beam_e.data_ptr(), nd.data_ptr(),
            nids.data_ptr(), od.data_ptr(), oi.data_ptr(), oe.data_ptr(), sel.data_ptr(),
            B, W, ef, E, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "beam_post")
    beam_post.launches += 1
    return od, oi, oe, sel


beam_post.launches = 0
