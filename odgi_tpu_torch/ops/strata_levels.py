"""Conflict levels of the 2D chunk phase (numpy).

Within a merge group the chunks compound in order, but two chunks whose slot
footprints are disjoint commute exactly.  A chunk's footprint is the set of
128-slot blocks of its A window ``[128*o, 128*o + CHUNK)`` and its B window
``[128*o + D, 128*o + D + CHUNK)``: blocks ``o .. o+31`` and
``o + D//128 .. o + (D+CHUNK-1)//128``, a superset of its slots.  A chunk's
level is 1 + the highest level of any earlier chunk of its group whose
footprint shares a block with it (1 when there is none).  Chunks of one
level are then pairwise slot-disjoint and every chunk comes after every
earlier chunk it conflicts with, so running the levels in order, each
level's chunks in any order, gives the sequential result bit for bit.

``chunk_levels`` builds the schedule the leveled kernel
(``csrc/strata_levels.cu``) walks, vectorized across the groups and looped
over a chunk's position in its group; ``chunk_levels_plain`` is the same
rule as a plain per-chunk loop, for the tests.
"""

from __future__ import annotations

import numpy as np

from .strata_plan import CHUNK, LANE, RC


def _footprints(o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """(..., 2*RC + 1) block indices of each chunk's footprint: RC A blocks,
    then the RC or RC + 1 B blocks (the last repeated when the B window is
    block-aligned)."""
    a = o[..., None] + np.arange(RC)
    b0 = o + d // LANE
    b1 = o + (d + CHUNK - 1) // LANE
    b = np.minimum(b0[..., None] + np.arange(RC + 1), b1[..., None])
    return np.concatenate([a, b], axis=-1)


def _schedule(lvl: np.ndarray) -> tuple:
    """perm and lvl_off from the (groups, cgs) levels."""
    groups, cgs = lvl.shape
    order = np.argsort(lvl, axis=1, kind="stable")  # by level, then index
    perm = (order + np.arange(groups)[:, None] * cgs).reshape(-1).astype(np.int32)
    depth = int(lvl.max(initial=0))
    counts = np.bincount((lvl + np.arange(groups)[:, None] * (depth + 1)).reshape(-1),
                         minlength=groups * (depth + 1)).reshape(groups, depth + 1)
    lvl_off = np.cumsum(counts, axis=1) + np.arange(groups)[:, None] * cgs
    return perm, np.ascontiguousarray(lvl_off, dtype=np.int32)


def chunk_levels(p: dict) -> tuple:
    """The leveled schedule of plan `p` (``plan_run``'s dict).

    Returns (perm, lvl_off): perm i32 (chunks,), each group's chunks (by
    global index) sorted by (level, index) in the group's own range
    [g*cgs, (g+1)*cgs); lvl_off i32 (groups, max_depth + 1), where level l
    (1-based) of group g is perm[lvl_off[g, l-1]:lvl_off[g, l]], offsets
    into perm.  lvl_off[g, 0] = g*cgs; rows of shallower groups repeat
    their end."""
    groups, cgs = p["groups"], p["cgs"]
    o = p["o_blk"].astype(np.int64).reshape(groups, cgs)
    d = p["d_arr"].astype(np.int64).reshape(groups, cgs)
    n_blocks = int((o + (d + CHUNK - 1) // LANE).max()) + 1
    last = np.zeros((groups, n_blocks), np.int32)
    lvl = np.empty((groups, cgs), np.int32)
    rows = np.arange(groups)[:, None]
    for c in range(cgs):
        fp = _footprints(o[:, c], d[:, c])
        lv = last[rows, fp].max(axis=1) + 1
        last[rows, fp] = lv[:, None]
        lvl[:, c] = lv
    return _schedule(lvl)


def chunk_levels_plain(p: dict) -> tuple:
    """`chunk_levels` by a plain loop over every chunk and its blocks."""
    groups, cgs = p["groups"], p["cgs"]
    lvl = np.empty((groups, cgs), np.int32)
    for g in range(groups):
        last = {}
        for c in range(cgs):
            j = g * cgs + c
            o, d = int(p["o_blk"][j]), int(p["d_arr"][j])
            blocks = set(range(o, o + RC)) | set(
                range(o + d // LANE, o + (d + CHUNK - 1) // LANE + 1))
            lv = 1 + max((last.get(b, 0) for b in blocks), default=0)
            for b in blocks:
                last[b] = lv
            lvl[g, c] = lv
    return _schedule(lvl)


def depths(lvl_off: np.ndarray) -> np.ndarray:
    """Levels of each group: the non-empty levels of its lvl_off row."""
    return (np.diff(lvl_off, axis=1) > 0).sum(axis=1)
