"""K6: the sorted-beam merge of the classic lock-step loop (port of
ops/pallas_merge.py's `merge_sorted`).

Each iteration of the classic loop (`ops/beam.py:beam_search`, reached on
CUDA with `fused=False`) merges the sorted (B, ef) beam with the scored,
unsorted (B, EL) tile and keeps the ef best.  The order is the key
(d, rank): beam lane j has rank j, tile lane j rank ef + j, so ties go to
the beam, then to the lower lane, `lax.top_k`'s stable order.  Every key is
distinct, so the kernel's merge by rank (`csrc/merge_sorted.cu`: each key's
merged position counted, no sort) and the plain version's stable sort of
[beam, tile] give one result, bit for bit, the +inf and NaN tail included.
The beam must be ascending (NaN last), as the reference requires.

On a CUDA tensor `merge_sorted` launches the kernel (no fallback); on a CPU
tensor it runs `merge_sorted_ref`.
"""

from __future__ import annotations

import torch

from . import _build

MAX_KEYS = 8192  # widest ef + EL the kernel merges (at most 176 KB of shared memory)


def merge_sorted_ref(beam_d, beam_i, beam_e, nd, nids):
    """Plain PyTorch version of K6 -> (d (B, ef) f32, i (B, ef) int32,
    e (B, ef) bool)."""
    ef = beam_d.shape[1]
    d, pos = torch.sort(torch.cat([beam_d, nd], 1), dim=1, stable=True)
    pos = pos[:, :ef]
    i = torch.gather(torch.cat([beam_i, nids], 1), 1, pos)
    e = torch.gather(torch.cat([beam_e, torch.zeros_like(nids, dtype=torch.bool)], 1), 1, pos)
    return d[:, :ef], i, e


def merge_sorted(beam_d, beam_i, beam_e, nd, nids):
    """The ef best of a sorted beam and an unsorted tile (K6).

    beam_d / beam_i / beam_e (B, ef) f32 / int32 / bool, ascending, inf / -1
    / False padded; nd / nids (B, EL) f32 / int32 (inf / -1 on stale lanes).
    Returns (d, i, e) (B, ef).  CUDA tensors launch the kernel and count it
    in `merge_sorted.launches`."""
    B, ef = beam_d.shape
    EL = nd.shape[1]
    if beam_i.shape != (B, ef) or beam_e.shape != (B, ef) or nids.shape != (B, EL):
        raise ValueError("merge_sorted: beam operands must be (B, ef), tile operands (B, EL)")
    if beam_d.dtype != torch.float32 or nd.dtype != torch.float32 or beam_i.dtype != torch.int32 \
            or nids.dtype != torch.int32 or beam_e.dtype != torch.bool:
        raise TypeError("merge_sorted takes f32 distances, int32 ids and a bool flag")
    devs = {t.device for t in (beam_d, beam_i, beam_e, nd, nids)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return merge_sorted_ref(beam_d, beam_i, beam_e, nd, nids)
    if dev.type != "cuda":
        raise RuntimeError(f"no K6 kernel for device {dev}")
    if ef + EL > MAX_KEYS:
        raise ValueError(f"merge_sorted: ef + EL = {ef + EL} exceeds the kernel's {MAX_KEYS} keys")
    # the kernel reads and writes the flags as the bool storage's bytes
    beam_d, beam_i, beam_e, nd, nids = (t.contiguous() for t in (beam_d, beam_i, beam_e, nd, nids))
    od = torch.empty((B, ef), dtype=torch.float32, device=dev)
    oi = torch.empty((B, ef), dtype=torch.int32, device=dev)
    oe = torch.empty((B, ef), dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_merge_sorted(
            beam_d.data_ptr(), beam_i.data_ptr(), beam_e.data_ptr(), nd.data_ptr(), nids.data_ptr(),
            od.data_ptr(), oi.data_ptr(), oe.data_ptr(), B, ef, EL,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "merge_sorted")
    merge_sorted.launches += 1
    return od, oi, oe


merge_sorted.launches = 0
