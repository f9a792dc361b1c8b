"""Host side of the XL route: the chunk sync flags (numpy).

The counterpart of ``_pack_od_xl`` in ``odgi_tpu/ops/pallas_sgd_xl.py``.
A chunk's flag is 1 when its read windows may intersect the previous
chunk's windows; the stream chunk kernels (``csrc/strata_stream.cu``) then
read its drift only after the previous chunk's adds, and prefetch it during
the previous chunk otherwise.  The flags are computed on the TPU kernel's
DMA spans (an A-union span of 4*RC rows at o, a far-B span of 2*RC rows at
o + D//128).  A chunk's A window [128*o, 128*o + CHUNK) and B window
[128*o + D, 128*o + D + CHUNK) lie inside those spans, so a flag of 0 means
the windows of the two chunks are disjoint here too.
"""

from __future__ import annotations

import numpy as np

from .strata_plan import LANE, RC, _pad_to

# Rows of the TPU kernel's A-union span (covers D < 2*CHUNK).
UNION_ROWS = 4 * RC


def pack_od_xl(p: dict) -> np.ndarray:
    """(groups, 4, cgs_pad) i32: rows [o, D, sync, pad] per chunk, as the
    JAX package packs them (cgs_pad = cgs rounded up to LANE; pad chunks
    hold D = 1).  Chunk 0 of every group has sync 0."""
    groups, cgs = p["groups"], p["cgs"]
    cgs_pad = _pad_to(cgs, LANE)
    o = p["o_blk"].astype(np.int64)
    d = p["d_arr"].astype(np.int64)
    r0 = o + (d >> 7)
    a0, a1 = o, o + UNION_ROWS
    b0, b1 = r0, r0 + 2 * RC

    def inter(x0, x1, y0, y1):
        return (x0 < y1) & (y0 < x1)

    prev = np.zeros(len(o), bool)
    prev[1:] = (
        inter(a0[1:], a1[1:], a0[:-1], a1[:-1])
        | inter(a0[1:], a1[1:], b0[:-1], b1[:-1])
        | inter(b0[1:], b1[1:], a0[:-1], a1[:-1])
        | inter(b0[1:], b1[1:], b0[:-1], b1[:-1])
    )
    prev[::cgs] = False
    od = np.zeros((groups, 4, cgs_pad), np.int32)
    od[:, 0, :cgs] = p["o_blk"].reshape(groups, cgs)
    od[:, 1, :cgs] = p["d_arr"].reshape(groups, cgs)
    od[:, 1, cgs:] = 1
    od[:, 2, :cgs] = prev.reshape(groups, cgs)
    return od


def sync_flags(p: dict) -> np.ndarray:
    """i32 (chunks,) sync flag of every chunk of the run, in chunk order."""
    return np.ascontiguousarray(pack_od_xl(p)[:, 2, : p["cgs"]].reshape(-1))
