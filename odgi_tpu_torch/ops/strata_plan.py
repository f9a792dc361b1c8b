"""Host plan of the strata PG-SGD scheme (numpy).

The counterpart of the host half of ``odgi_tpu/ops/pallas_sgd.py``: the slot
layout of the step planes (``PallasSgdData.build``, here flat and filled on
the run's device by ``strata_sgd.fill_slots``), the zeta constants, the
learning-rate table, the per-chunk scalars drawn from numpy's Philox stream,
the exact count of valid pairs, and ``plan_run``.  Every output equals the
JAX package's bit for bit, so both packages run the same chunks in the same
order with the same coins.

A chunk is CHUNK = 4096 pairs that share one jump distance D: pair i joins
step slots a = 128*o + i and b = a + D, where o is the chunk's window block.
A pair is valid when both slots lie on the same path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.metrics import span
from .sgd import sgd_schedule
from .zipf import zeta_eta_table

LANE = 128
RC = 32                # rows of LANE pairs per chunk
CHUNK = RC * LANE      # pairs per chunk (one shared jump distance)
TR = 32                # the reference's merge-tile rows; sets the plane pad
MAX_CGS = 4096         # most chunks in one merge group
MERGES_PER_ITER = 1    # one consensus merge per iteration at least

POS, POSEND, HANDLE, PATH = range(4)   # 2D planes
P1_POS, P1_HANDLE, P1_PATH = range(3)  # 1D planes (no pos_end)


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class StrataData:
    """The slot layout of a run: its step count and padded slot count.

    The step planes themselves are filled on the run's device
    (``strata_sgd.fill_slots``): i32 (4, L) [pos, pos_end, handle, path]
    for 2D, (3, L) [pos, handle, path] for 1D, in step order.  Slots past
    the last step keep path = -1, so a window that runs past the end masks
    out through the same path compare that masks cross-path pairs, and
    handle = 2*num_nodes, a dummy endpoint that no merge reads back.
    """

    num_steps: int
    n_blocks: int   # valid 128-aligned window start blocks (= ceil(S/128))
    num_nodes: int
    space: int
    one_d: bool
    num_slots: int  # L: the steps, then room for a window past the last

    @staticmethod
    def build(g, space: int, one_d: bool = False) -> "StrataData":
        S = g.num_steps
        return StrataData(
            num_steps=S,
            n_blocks=max(1, -(-S // LANE)),
            num_nodes=g.num_nodes,
            space=space,
            one_d=one_d,
            num_slots=_pad_to(S + CHUNK + space + 4 * RC * LANE, TR * LANE),
        )


def _zeta_consts(cfg, space: int):
    """(zeta(space), eta(space)) from the quantized table."""
    ze = zeta_eta_table(space, cfg.space_max, cfg.space_quantization_step, cfg.theta)
    if space > cfg.space_max:
        zi = cfg.space_max + 1 + (space - cfg.space_max) // cfg.space_quantization_step
    else:
        zi = space
    zi = min(zi, len(ze) - 1)
    return float(ze[zi, 0]), float(ze[zi, 1])


def _eta_schedule(cfg) -> np.ndarray:
    """Per-iteration learning rate, f32, iter_max entries."""
    etas = sgd_schedule(
        1.0 / cfg.eta_max, 1.0, cfg.iter_max,
        cfg.iter_with_max_learning_rate, cfg.eps,
    )
    return np.asarray(etas[: cfg.iter_max], np.float32)


def _host_chunk_scalars(cfg, data: StrataData, nch: int, one_d: bool):
    """Per-chunk (window block o, jump D, learning rate eta) for `nch`
    chunks per iteration.

    D is the closed-form Zipf inverse over the quantized zeta table with
    probability 1/2 before cooling, else uniform in [1, space); after
    cooling always Zipf.  2D cools at it >= first_cooling, 1D strictly
    after it: the reference's quirk, kept."""
    total = cfg.iter_max * nch
    space = int(data.space)
    zeta_n, eta_z = _zeta_consts(cfg, space)
    alpha = 1.0 / (1.0 - cfg.theta)
    hp = 0.5 ** cfg.theta

    rng = np.random.Generator(np.random.Philox(int(cfg.seed) & 0x7FFFFFFF))
    u = rng.random((3, total))
    coin = rng.integers(0, 2, total)

    o_blk = np.minimum((u[0] * data.n_blocks).astype(np.int32), data.n_blocks - 1)
    x = np.maximum(eta_z * u[1] - eta_z + 1.0, 1e-30)
    powx = np.exp(alpha * np.log(x))
    uz = u[1] * zeta_n
    val = np.where(uz < 1.0, 1.0, np.where(uz < 1.0 + hp, 2.0, 1.0 + space * powx))
    d_zipf = np.clip(np.floor(val), 1, space).astype(np.int32)
    d_unif = (1 + np.floor(u[2] * max(space - 1, 1))).astype(np.int32)

    it = np.arange(total) // nch
    fc = cfg.first_cooling_iteration
    cooling = (it > fc) if one_d else (it >= fc)
    d_arr = np.where(cooling | (coin > 0), d_zipf, d_unif).astype(np.int32)
    eta_arr = _eta_schedule(cfg)[it].astype(np.float32)
    return o_blk, d_arr, eta_arr


def _count_valid(g, o_blk: np.ndarray, d_arr: np.ndarray) -> int:
    """Exact number of valid pairs over all chunks.

    Pair (a, a+D) is valid iff a lies in some path's step range
    [start, end) and a+D < end.  So a chunk's window [o, o+CHUNK) adds,
    for every path it overlaps, max(0, min(o+CHUNK, end-D) - max(o, start)).
    This equals the reference's per-pair boundary count and needs no
    per-pair arrays."""
    starts = g.path_offset[:-1].astype(np.int64)
    ends = g.path_offset[1:].astype(np.int64)
    nonempty = ends > starts
    starts, ends = starts[nonempty], ends[nonempty]
    o = o_blk.astype(np.int64) * LANE
    d = d_arr.astype(np.int64)
    hi = o + CHUNK
    p0 = np.searchsorted(ends, o, side="right")    # first path ending past o
    p1 = np.searchsorted(starts, hi, side="left")  # paths starting before hi
    total = 0
    for k in range(int((p1 - p0).max(initial=0))):
        m = p0 + k < p1
        p = p0[m] + k
        lo_a = np.maximum(o[m], starts[p])
        hi_a = np.minimum(hi[m], ends[p] - d[m])
        total += int(np.maximum(hi_a - lo_a, 0).sum())
    return total


@span("strata.plan")
def plan_run(g, cfg, one_d: bool = False) -> dict:
    """Chunks per iteration, merge groups, the chunk scalars and the exact
    slot and valid-pair counts of one run.

    The chunk count per iteration is raised by the measured valid-pair
    fraction, so that valid updates per iteration reach the reference's
    min_term_updates.  An iteration splits into merge groups of at most
    MAX_CGS chunks; each group ends in one consensus merge."""
    data = StrataData.build(g, int(cfg.space), one_d)
    nch0 = max(1, -(-cfg.min_term_updates // CHUNK))
    o_blk, d_arr, _ = _host_chunk_scalars(cfg, data, nch0, one_d)
    valid0 = _count_valid(g, o_blk, d_arr)
    frac = max(valid0 / max(len(o_blk) * CHUNK, 1), 0.05)
    cpi = max(1, -(-cfg.min_term_updates // int(CHUNK * frac)))
    mpi = max(MERGES_PER_ITER, -(-cpi // MAX_CGS))
    mpi = max(1, min(mpi, cpi))
    cpi = _pad_to(cpi, mpi)
    o_blk, d_arr, eta_arr = _host_chunk_scalars(cfg, data, cpi, one_d)
    valid = _count_valid(g, o_blk, d_arr)
    return dict(
        data=data,
        cpi=cpi,                      # chunks per iteration
        cgs=cpi // mpi,               # chunks per merge group
        groups=cfg.iter_max * mpi,    # merge groups in the run
        o_blk=o_blk,
        d_arr=d_arr,
        eta_arr=eta_arr,
        eta_table=_eta_schedule(cfg),
        total_slots=cfg.iter_max * cpi * CHUNK,
        total_valid=valid,
        valid_frac=valid / max(cfg.iter_max * cpi * CHUNK, 1),
    )
