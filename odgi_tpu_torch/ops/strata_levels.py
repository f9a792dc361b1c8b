"""The schedule of the chunk phase within a merge group (numpy).

Within a merge group the chunks compound in order, but two chunks whose slot
footprints are disjoint commute exactly.  A chunk's footprint is the set of
128-slot blocks of its A window ``[128*o, 128*o + CHUNK)`` and its B window
``[128*o + D, 128*o + D + CHUNK)``: blocks ``o .. o+31`` and
``o + D//128 .. o + (D+CHUNK-1)//128``, a superset of its slots.

- A chunk's level is 1 + the highest level of any earlier chunk of its
  group whose footprint shares a block with it (1 when there is none).
  Chunks of one level are then pairwise slot-disjoint.
- A chunk's predecessors are the last earlier chunk of its group on each
  block of its footprint.  The last chunk on a block ran after every
  earlier chunk on that block, so a chunk that runs after its
  predecessors runs after every earlier chunk it conflicts with; and the
  last chunk on a block holds the block's highest level, so a chunk's
  level is 1 + the highest level of its predecessors.

Any order of a group's chunks in which every chunk comes after every
earlier chunk it conflicts with gives the chain's result bit for bit.  The
order by (level, index), ``perm``, is one: the leveled kernels of
``csrc/strata_levels.cu`` (``strata_chunks_*_levels``) hand its chunks
out in that order, and each chunk waits only for its predecessors.

``chunk_schedule`` builds perm, the level offsets and the predecessor
lists: in C++ (``native/src/strata_schedule.cpp``, built at first use), or,
where g++ is missing, in numpy (``chunk_schedule_numpy``, vectorized across
the groups and looped over a chunk's position in its group; the same
output).  ``chunk_schedule_plain`` is the same rules as a plain per-chunk
loop, for the tests.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..utils.metrics import span
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


def _csr(groups: int, cgs: int, counts: np.ndarray, vals: list) -> tuple:
    """pred_off, pred in global chunk order from the per-position lists:
    counts (cgs, groups), vals[c] the lists of the chunks at position c,
    group by group."""
    n = counts.T.reshape(-1)  # by global chunk index g * cgs + c
    pred_off = np.zeros(groups * cgs + 1, np.int64)
    np.cumsum(n, out=pred_off[1:])
    flat = counts.reshape(-1)  # position-major, as vals
    total = int(flat.sum())
    key = (np.arange(groups)[None, :] * cgs + np.arange(cgs)[:, None]).reshape(-1)
    run0 = np.cumsum(flat) - flat
    dest = np.repeat(pred_off[key], flat) + np.arange(total) - np.repeat(run0, flat)
    pred = np.empty(total, np.int32)
    pred[dest] = np.concatenate(vals) if vals else np.empty(0, np.int32)
    return pred_off.astype(np.int32), pred


@span("strata.chunk_schedule")
def chunk_schedule(p: dict) -> tuple:
    """The schedule of plan `p` (``plan_run``'s dict).

    Returns (perm, lvl_off, pred_off, pred):
    - perm i32 (chunks,): each group's chunks (by global index) sorted by
      (level, index) in the group's own range [g*cgs, (g+1)*cgs);
    - lvl_off i32 (groups, max_depth + 1): level l (1-based) of group g is
      perm[lvl_off[g, l-1]:lvl_off[g, l]], offsets into perm;
      lvl_off[g, 0] = g*cgs; rows of shallower groups repeat their end;
    - pred_off i32 (chunks + 1,), pred i32: the predecessors of chunk j
      are pred[pred_off[j]:pred_off[j+1]] (global indices): the last
      earlier chunk of its group on each block of its footprint, one entry
      a run of blocks with the same last chunk (a chunk can appear twice,
      once a window)."""
    lib = native.schedule_lib()
    if lib is None:
        return chunk_schedule_numpy(p)
    groups, cgs = p["groups"], p["cgs"]
    o = np.ascontiguousarray(p["o_blk"], dtype=np.int32)
    d = np.ascontiguousarray(p["d_arr"], dtype=np.int32)
    lvl = np.empty(groups * cgs, np.int32)
    counts = np.empty(groups * cgs, np.int32)
    pred = np.empty(8 * groups * cgs, np.int32)
    ptr = lambda a: a.ctypes.data
    for _ in range(2):  # once more with room for every entry, if 8 a chunk were too few
        n = lib.odgi_strata_schedule(groups, cgs, ptr(o), ptr(d), ptr(lvl), ptr(counts),
                                     ptr(pred), pred.shape[0])
        if n <= pred.shape[0]:
            break
        pred = np.empty(n, np.int32)
    pred_off = np.zeros(groups * cgs + 1, np.int64)
    np.cumsum(counts, out=pred_off[1:])
    return (*_schedule(lvl.reshape(groups, cgs)), pred_off.astype(np.int32), pred[:n].copy())


def chunk_schedule_numpy(p: dict) -> tuple:
    """`chunk_schedule` in numpy."""
    groups, cgs = p["groups"], p["cgs"]
    o = p["o_blk"].astype(np.int64).reshape(groups, cgs)
    d = p["d_arr"].astype(np.int64).reshape(groups, cgs)
    n_blocks = int((o + (d + CHUNK - 1) // LANE).max()) + 1
    rows = np.arange(groups)[:, None]
    # Each block's last chunk, group g's block b at g * n_blocks + b, packed
    # as (its level << 32) | (its global index + 1); 0: no chunk yet.
    last = np.zeros(groups * n_blocks, np.int64)
    lvl = np.empty((groups, cgs), np.int32)
    ob = o + rows * n_blocks
    ids = rows * cgs + 1
    counts = np.empty((cgs, groups), np.int64)
    vals = []
    keep = np.empty((groups, 2 * RC + 1), bool)
    for c in range(cgs):
        fp = _footprints(ob[:, c], d[:, c])
        lc = last.take(fp)
        lv = (lc.max(axis=1) >> 32) + 1
        lvl[:, c] = lv
        last[fp] = (lv[:, None] << 32) | (ids + c)
        # one entry a run of blocks with the same last chunk, a window each
        np.not_equal(lc[:, 1:], lc[:, :-1], out=keep[:, 1:])
        keep[:, 0] = keep[:, RC] = True
        keep &= lc != 0
        counts[c] = keep.sum(axis=1)
        vals.append(lc[keep])
    pred = [(v & 0xFFFFFFFF) - 1 for v in vals]
    return (*_schedule(lvl), *_csr(groups, cgs, counts, pred))


def chunk_levels(p: dict) -> tuple:
    """(perm, lvl_off) of `chunk_schedule`."""
    return chunk_schedule(p)[:2]


def chunk_schedule_plain(p: dict) -> tuple:
    """`chunk_schedule` by a plain loop over every chunk and its blocks;
    each chunk's predecessors come as the sorted distinct global indices,
    a list a chunk."""
    groups, cgs = p["groups"], p["cgs"]
    lvl = np.empty((groups, cgs), np.int32)
    preds = []
    for g in range(groups):
        last, level = {}, {}
        for c in range(cgs):
            j = g * cgs + c
            o, d = int(p["o_blk"][j]), int(p["d_arr"][j])
            blocks = set(range(o, o + RC)) | set(
                range(o + d // LANE, o + (d + CHUNK - 1) // LANE + 1))
            before = sorted({last[b] for b in blocks if b in last})
            level[c] = 1 + max((level[q] for q in before), default=0)
            for b in blocks:
                last[b] = c
            lvl[g, c] = level[c]
            preds.append([g * cgs + q for q in before])
    return (*_schedule(lvl), preds)


def chunk_levels_plain(p: dict) -> tuple:
    """`chunk_levels` by a plain loop over every chunk and its blocks."""
    return chunk_schedule_plain(p)[:2]


def depths(lvl_off: np.ndarray) -> np.ndarray:
    """Levels of each group: the non-empty levels of its lvl_off row."""
    return (np.diff(lvl_off, axis=1) > 0).sum(axis=1)
