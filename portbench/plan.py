"""The benchmark's frozen copy of the strata PG-SGD plan arithmetic (numpy).

The roofline count and the plain reference both work a run out from the
graph and the job's seed with these functions, never with the program's
plan objects.  What they compute is what ``odgi sort -Y`` and ``odgi layout``
do at their defaults, in the scheme the program runs:

- the configurations at upstream's defaults (``derive_1d``: 100 iterations,
  min_term_updates = the step count, theta 0.99, space_max 100;
  ``derive_2d``: 30 iterations, 10 x the step count, space_max up to 1000);
- the learning-rate schedule and the quantized zeta table;
- one run's chunks: CHUNK = 4096 pairs sharing a jump D, window block o,
  drawn from numpy's Philox stream of the seed; pair i of a chunk joins
  step slots 128*o + i and 128*o + i + D;
- how many chunks an iteration runs (raised by the valid-pair fraction)
  and how they split into merge groups of at most MAX_CGS chunks;
- within a group, each chunk's conflict level: 1 + the highest level of an
  earlier chunk whose 128-slot blocks it shares.  Chunks of one level touch
  disjoint slots, so running a group level by level gives the result of
  running its chunks one after another.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

LANE = 128
RC = 32
CHUNK = RC * LANE
TR = 32
MAX_CGS = 4096


@dataclass(frozen=True)
class Config:
    iter_max: int
    min_term_updates: int
    eta_max: float
    space: int
    space_max: int
    space_quantization_step: int
    seed: int
    eps: float = 0.01
    theta: float = 0.99
    cooling_start: float = 0.5
    iter_with_max_learning_rate: int = 0

    @property
    def first_cooling_iteration(self) -> int:
        return int(math.floor(self.cooling_start * self.iter_max))


def path_step_counts(f: dict) -> np.ndarray:
    return np.diff(f["path_offset"])


def derive_1d(f: dict, seed: int) -> Config:
    """`odgi sort -Y`'s defaults for the graph fields `f`."""
    counts = path_step_counts(f)
    last = f["path_offset"][1:] - 1
    length = f["step_pos"][last] + f["node_len"][f["step_handle"][last] >> 1]
    space = max(1, int(length.max()))
    space_max = 100
    quant = max(2, -(-(space - space_max) // (max(space_max + 1, 100) - space_max))) \
        if space > space_max else 100
    return Config(iter_max=100, min_term_updates=len(f["step_handle"]),
                  eta_max=float(counts.max()) ** 2, space=space, space_max=space_max,
                  space_quantization_step=quant, seed=seed)


def derive_2d(f: dict, seed: int) -> Config:
    """`odgi layout`'s defaults for the graph fields `f`."""
    max_steps = int(path_step_counts(f).max())
    space = max(1, max_steps)
    return Config(iter_max=30, min_term_updates=10 * len(f["step_handle"]),
                  eta_max=float(max_steps) ** 2, space=space, space_max=min(space, 1000),
                  space_quantization_step=100, seed=seed)


def eta_table(cfg: Config) -> np.ndarray:
    """f32 learning rate of each iteration."""
    eta_max = 1.0 / (1.0 / cfg.eta_max)   # the schedule takes w_min = 1 / eta_max
    eta_min = cfg.eps
    it = cfg.iter_max
    lam = math.log(eta_max / eta_min) / (it - 1) if it > 1 else 0.0
    t = np.arange(it + 1, dtype=np.float64)
    etas = eta_max * np.exp(-lam * np.abs(t - cfg.iter_with_max_learning_rate))
    etas = np.where(np.isfinite(etas), etas, eta_min)
    return np.asarray(etas[:it], np.float32)


def _zetas(space: int, space_max: int, step: int, theta: float) -> np.ndarray:
    n = (space if space <= space_max else space_max + (space - space_max) // step + 1) + 1
    z = np.zeros(n, np.float64)
    running = 0.0
    chunk = 1 << 22
    for lo in range(1, space + 1, chunk):
        hi = min(space + 1, lo + chunk)
        part = running + np.cumsum(np.power(1.0 / np.arange(lo, hi, dtype=np.float64), theta))
        running = part[-1]
        top = min(hi, space_max + 1)
        if lo < top:
            z[lo:top] = part[:top - lo]
        if space > space_max:
            idx = np.arange(lo, hi)
            q = (idx >= space_max) & ((idx - space_max) % step == 0)
            q &= space_max + 1 + (idx - space_max) // step < n
            if q.any():
                z[space_max + 1 + (idx[q] - space_max) // step] = part[q]
    return z


def zeta_consts(cfg: Config) -> tuple:
    """(zeta(space), eta(space)) of the quantized f32 table."""
    space, smax, step = cfg.space, cfg.space_max, cfg.space_quantization_step
    z = _zetas(space, smax, step, cfg.theta)
    s = np.arange(len(z), dtype=np.float64)
    if space > smax:
        s[s > smax] = smax + (s[s > smax] - smax - 1) * step
    s = np.maximum(s, 1.0)
    zeta2 = z[2] if len(z) > 2 else 1.0
    denom = 1.0 - np.divide(zeta2, z, out=np.ones_like(z), where=z != 0)
    denom = np.where(denom == 0.0, 1e-9, denom)
    eta = (1.0 - np.power(2.0 / s, 1.0 - cfg.theta)) / denom
    table = np.stack([z, eta], axis=1).astype(np.float32)
    zi = smax + 1 + (space - smax) // step if space > smax else space
    zi = min(zi, len(table) - 1)
    return float(table[zi, 0]), float(table[zi, 1])


def chunk_scalars(cfg: Config, n_blocks: int, nch: int, one_d: bool) -> tuple:
    """(o, D) i32 of iter_max * nch chunks: window block and jump."""
    total = cfg.iter_max * nch
    space = cfg.space
    zeta_n, eta_z = zeta_consts(cfg)
    alpha = 1.0 / (1.0 - cfg.theta)
    rng = np.random.Generator(np.random.Philox(int(cfg.seed) & 0x7FFFFFFF))
    u = rng.random((3, total))
    coin = rng.integers(0, 2, total)
    o = np.minimum((u[0] * n_blocks).astype(np.int32), n_blocks - 1)
    x = np.maximum(eta_z * u[1] - eta_z + 1.0, 1e-30)
    uz = u[1] * zeta_n
    val = np.where(uz < 1.0, 1.0, np.where(uz < 1.0 + 0.5 ** cfg.theta, 2.0,
                                           1.0 + space * np.exp(alpha * np.log(x))))
    d_zipf = np.clip(np.floor(val), 1, space).astype(np.int32)
    d_unif = (1 + np.floor(u[2] * max(space - 1, 1))).astype(np.int32)
    it = np.arange(total) // nch
    fc = cfg.first_cooling_iteration
    cooling = (it > fc) if one_d else (it >= fc)
    return o, np.where(cooling | (coin > 0), d_zipf, d_unif).astype(np.int32)


def valid_pairs(path_offset: np.ndarray, o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Valid pairs of each chunk: pair (a, a + D) counts when a lies in a
    path's step range [start, end) and a + D < end."""
    starts = path_offset[:-1].astype(np.int64)
    ends = path_offset[1:].astype(np.int64)
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    lo = o.astype(np.int64) * LANE
    d = d.astype(np.int64)
    hi = lo + CHUNK
    p0 = np.searchsorted(ends, lo, side="right")
    p1 = np.searchsorted(starts, hi, side="left")
    out = np.zeros(len(lo), np.int64)
    for k in range(int((p1 - p0).max(initial=0))):
        m = p0 + k < p1
        p = p0[m] + k
        out[m] += np.maximum(np.minimum(hi[m], ends[p] - d[m]) - np.maximum(lo[m], starts[p]), 0)
    return out


def num_slots(num_steps: int, space: int) -> int:
    n = num_steps + CHUNK + space + 4 * CHUNK
    return -(-n // (TR * LANE)) * (TR * LANE)


def plan(f: dict, cfg: Config, one_d: bool) -> dict:
    """One run's chunks: cpi (chunks an iteration), cgs (chunks a group),
    groups, o and D of every chunk in run order, the f32 eta of each
    iteration, and the slot count L."""
    S = len(f["step_handle"])
    n_blocks = max(1, -(-S // LANE))
    nch0 = max(1, -(-cfg.min_term_updates // CHUNK))
    o, d = chunk_scalars(cfg, n_blocks, nch0, one_d)
    frac = max(int(valid_pairs(f["path_offset"], o, d).sum()) / max(len(o) * CHUNK, 1), 0.05)
    cpi = max(1, -(-cfg.min_term_updates // int(CHUNK * frac)))
    mpi = max(1, -(-cpi // MAX_CGS))
    mpi = max(1, min(mpi, cpi))
    cpi = -(-cpi // mpi) * mpi
    o, d = chunk_scalars(cfg, n_blocks, cpi, one_d)
    return dict(cpi=cpi, cgs=cpi // mpi, groups=cfg.iter_max * mpi, o=o, d=d,
                eta=eta_table(cfg), L=num_slots(S, cfg.space))


def levels(p: dict) -> np.ndarray:
    """(groups, cgs) conflict level of every chunk, from 1."""
    groups, cgs = p["groups"], p["cgs"]
    o = p["o"].astype(np.int64).reshape(groups, cgs)
    d = p["d"].astype(np.int64).reshape(groups, cgs)
    n_blocks = int((o + (d + CHUNK - 1) // LANE).max()) + 1
    ob = o + np.arange(groups)[:, None] * n_blocks
    top = np.zeros(groups * n_blocks, np.int64)  # highest level on each block so far
    lvl = np.empty((groups, cgs), np.int64)
    ra, rb = np.arange(RC), np.arange(RC + 1)
    for c in range(cgs):
        oc, dc = ob[:, c], d[:, c]
        b0 = oc + dc // LANE
        b1 = oc + (dc + CHUNK - 1) // LANE
        fp = np.concatenate([oc[:, None] + ra, np.minimum(b0[:, None] + rb, b1[:, None])], 1)
        lv = top.take(fp).max(axis=1) + 1
        lvl[:, c] = lv
        top[fp] = lv[:, None]
    return lvl
