"""The strata PG-SGD scheme on tensors: plain versions and the runs.

The counterpart of ``odgi_tpu/ops/pallas_sgd.py``'s ``_make_kernel_1d`` /
``_make_kernel_2d`` and of their semantic twins ``path_sgd_1d_strata_xla``
/ ``path_sgd_2d_strata_xla``.  Coordinates are replicated per step slot:
``base`` holds each slot's value at the last consensus and ``drift`` what
the slot's replica moved since.  A merge group runs `cgs` chunks in order;
each chunk reads both windows, then adds into the A window, then into the
B window.  The group ends in a consensus merge: per endpoint, sum the drift
of its slots in f64 (ascending slot order), scale by 1/R (R = the node's
step count), add into the f64 node coordinates, broadcast the update into
``base`` and reset ``drift``.

A run takes one of three routes (``ops/strata_route.py``), the
counterparts of the JAX package's three kernel families.  All three compute
the same function, bit for bit:
- ``"resident"`` (``_make_kernel_1d/2d``): the CSR merge;
- ``"xl"`` (``_make_kernel_xl/_xl_1d``): the CSR merge too, which has no
  node cap;
- ``"xxl"`` (``_make_kernel_xxl/_xxl_1d``): nodes relabeled by first visit
  (``ops/strata_xxl.py``) and the blocked sum over the node blocks' CSR
  spans; coordinates are relabeled back at the end.
Every route broadcasts with the same one pass over the slots.
With delta early stop (-j, ``StrataState.run(delta)``) the chunk phase runs
the leveled kernels' tracking instances, which also write each group's
Delta_max (the reference's ``track`` output), and the run stops after the
first iteration whose maximum is at most delta.
On every route the chunk phase runs on the leveled kernels
(``strata_chunks_2d_levels`` / ``strata_chunks_1d_levels``) in the
schedule of ``ops/strata_levels.py``: the group's chunks in conflict-level
order, each after its predecessors, which gives the drift of the chain
kernels ``strata_chunks_2d/1d`` bit for bit; the chain kernels stay as its
reference, off the main path.

Each phase has a plain PyTorch version here and a CUDA kernel behind the
wrappers of ``ops/kernels.py``; the runs call the wrappers, which take
the plain version for CPU tensors and launch the kernel for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native
from ..utils.metrics import count, span
from . import kernels, strata_levels
from .sgd import LAST_RUN
from .strata_plan import (CHUNK, HANDLE, LANE, P1_HANDLE, P1_PATH, P1_POS, PATH, POS, POSEND,
                          StrataData, plan_run)
from .strata_route import ROUTES, graph_route
from .strata_xxl import BlockSchedule, relabel, relabel_coords, unrelabel

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Pair coins: the reference's splitmix-style hash, in exact uint32 arithmetic
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow:
    split c into 16-bit halves (each partial product < 2^48)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def pair_coins(gchunk: int, device=None) -> torch.Tensor:
    """(2, CHUNK) int32 coin words of `_pair_coins` for one chunk's hash
    key `gchunk` (taken mod 2^32), flattened in pair order.  Row 0 picks
    side a's endpoint, row 1 side b's; only bit 0 is used.  Shifts are
    logical: the words are held as uint32 values in int64."""
    i = torch.arange(CHUNK, dtype=torch.int64, device=device)
    key = ((gchunk & _M32) * 0xBB67AE85) & _M32
    h0 = (_mul32(i, 0x9E3779B9) + key) & _M32
    rows = []
    for sel in (0, 1):
        h = (h0 + sel * 0x6A09E667) & _M32
        h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
        h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
        h = h ^ (h >> 16)
        rows.append(torch.where(h >= 2**31, h - 2**32, h))
    return torch.stack(rows).to(torch.int32)


def chunk_coins(gl: int, device=None) -> torch.Tensor:
    """Coins of global chunk `gl`: the key is gl * 1000003 in int32
    wraparound (past gl = 2147 the product wraps)."""
    return pair_coins(gl * 1000003, device)


# ---------------------------------------------------------------------------
# Plain versions of the four kernels
# ---------------------------------------------------------------------------


def _track(dmax, delta, valid) -> None:
    """Raise the one-word `dmax` to the max of |delta| over the valid
    pairs (the reference's Delta_max)."""
    if dmax is not None:
        torch.maximum(dmax, torch.where(valid, delta.abs(), 0.0).max(), out=dmax)


def _chunk_2d(drift, base, planes, o: int, D: int, lr, gl: int, dmax=None) -> None:
    """One 2D chunk, global index `gl` (its coins and eta row), window start
    slot `o` and jump `D`, in place on `drift`: every pair reads both
    windows, then the A adds, then the B adds.  `dmax`: see `_track`."""
    pos0, pos1, path = planes[POS], planes[POSEND], planes[PATH]
    A = slice(o, o + CHUNK)
    B = slice(o + D, o + D + CHUNK)
    coins = chunk_coins(gl, drift.device)
    caf = (coins[0] & 1) == 0
    cbf = (coins[1] & 1) == 0
    a = base[:, A] + drift[:, A]
    b = base[:, B] + drift[:, B]
    pos_a = torch.where(caf, pos0[A], pos1[A])
    pos_b = torch.where(cbf, pos0[B], pos1[B])
    xa = torch.where(caf, a[0], a[1])
    ya = torch.where(caf, a[2], a[3])
    xb = torch.where(cbf, b[0], b[1])
    yb = torch.where(cbf, b[2], b[3])
    valid = (path[A] == path[B]) & (path[A] >= 0)
    term = torch.clamp_min((pos_a - pos_b).abs().to(torch.float32), 1e-9)
    mu = torch.clamp_max(lr / term, 1.0)
    dx = xa - xb
    dx = torch.where(dx == 0.0, 1e-9, dx)
    dy = ya - yb
    # the root in f64, rounded once: the correctly rounded f32 root, as the
    # kernel's sqrtf and XLA's give it (PyTorch's vectorized f32 sqrt on the
    # CPU can be an ulp off)
    mag = torch.sqrt((dx * dx + dy * dy).to(torch.float64)).to(torch.float32)
    delta = mu * (mag - term) * 0.5
    _track(dmax, delta, valid)
    r = torch.where(valid, delta / mag, 0.0)
    rx = r * dx
    ry = r * dy
    zero = torch.zeros_like(rx)
    drift[:, A] += torch.stack([
        torch.where(caf, -rx, zero), torch.where(caf, zero, -rx),
        torch.where(caf, -ry, zero), torch.where(caf, zero, -ry),
    ])
    drift[:, B] += torch.stack([
        torch.where(cbf, rx, zero), torch.where(cbf, zero, rx),
        torch.where(cbf, ry, zero), torch.where(cbf, zero, ry),
    ])


def chunks_2d_plain(drift, base, planes, od, eta, cpi: int, g0: int, cgs: int, dmax=None):
    """Chunks g0..g0+cgs-1 of the 2D scheme, in place on `drift` (4, L) f32.

    base (4, L) f32 [xf, xr, yf, yr]; planes (4, L) i32 [pos, pos_end,
    handle, path]; od (chunks, 2) i32 [window block, D]; eta (iter_max,)
    f32, indexed by gl // cpi.  With `dmax` (one f32 word) also raise it
    to the group's max |delta| over valid pairs."""
    od_h = od.cpu().numpy()
    for gl in range(g0, g0 + cgs):
        _chunk_2d(drift, base, planes, int(od_h[gl, 0]) * LANE, int(od_h[gl, 1]),
                  eta[gl // cpi], gl, dmax)


def chunks_2d_levels_plain(drift, base, planes, od, eta, cpi: int, perm, lvl_off,
                           dmax=None):
    """The chunks perm[lvl_off[0]:lvl_off[-1]] in that order, in place on
    `drift` (`ops/strata_levels.py`: one group's chunks by (level, index),
    the order the leveled kernels hand them out in); the same per-chunk body
    as `chunks_2d_plain`, `dmax` too."""
    od_h = od.cpu().numpy()
    off = lvl_off.cpu().numpy()
    for gl in perm[int(off[0]):int(off[-1])].cpu().tolist():
        _chunk_2d(drift, base, planes, int(od_h[gl, 0]) * LANE, int(od_h[gl, 1]),
                  eta[gl // cpi], gl, dmax)


def _chunk_1d(drift, base, planes, o: int, D: int, lr, dmax=None) -> None:
    """One 1D chunk, window start slot `o` and jump `D`, in place on
    `drift`: no coins; a pair is valid only if also pos_a != pos_b, and its
    weight is 1/d; the A slot subtracts rr, then the B slot adds it."""
    pos, path = planes[P1_POS], planes[P1_PATH]
    d0, b0 = drift[0], base[0]
    A = slice(o, o + CHUNK)
    B = slice(o + D, o + D + CHUNK)
    xa = b0[A] + d0[A]
    xb = b0[B] + d0[B]
    di = pos[A] - pos[B]
    valid = (path[A] == path[B]) & (path[A] >= 0) & (di != 0)
    term = di.abs().to(torch.float32)
    w = torch.ones_like(term) / torch.clamp_min(term, 1e-30)
    mu = torch.clamp_max(lr * w, 1.0)
    dx = xa - xb
    dx = torch.where(dx == 0.0, 1e-9, dx)
    mag = dx.abs()
    delta = mu * (mag - term) * 0.5
    _track(dmax, delta, valid)
    rr = torch.where(valid, delta / mag * dx, 0.0)
    d0[A] -= rr
    d0[B] += rr


def chunks_1d_plain(drift, base, planes, od, eta, cpi: int, g0: int, cgs: int, dmax=None):
    """Chunks g0..g0+cgs-1 of the 1D scheme, in place on `drift` (1, L) f32.

    planes (3, L) i32 [pos, handle, path]; od, eta, dmax as
    `chunks_2d_plain`."""
    od_h = od.cpu().numpy()
    for gl in range(g0, g0 + cgs):
        _chunk_1d(drift, base, planes, int(od_h[gl, 0]) * LANE, int(od_h[gl, 1]),
                  eta[gl // cpi], dmax)


def chunks_1d_levels_plain(drift, base, planes, od, eta, cpi: int, perm, lvl_off,
                           dmax=None):
    """`chunks_2d_levels_plain` for the 1D scheme: the chunks
    perm[lvl_off[0]:lvl_off[-1]] in that order, the body of
    `chunks_1d_plain`, `dmax` too."""
    od_h = od.cpu().numpy()
    off = lvl_off.cpu().numpy()
    for gl in perm[int(off[0]):int(off[-1])].cpu().tolist():
        _chunk_1d(drift, base, planes, int(od_h[gl, 0]) * LANE, int(od_h[gl, 1]),
                  eta[gl // cpi], dmax)


def merge_sum_plain(drift, mi: "MergeIndex", coords, upd):
    """Consensus sums: per endpoint e, acc = sum of its slots' drift in f64
    (2D: plane 2c over slots with endpoint e, plus plane 2c+1 over slots
    whose complement endpoint is e); upd = acc / R; coords += upd.

    coords (nc, E) f64 and upd (nc, E_cap) f64 are written in place."""
    nc, E = coords.shape
    dv = drift.to(torch.float64)
    for ch in range(nc):
        acc = torch.zeros(mi.ecap, dtype=torch.float64, device=drift.device)
        if nc == 1:
            acc.index_add_(0, mi.ep, dv[0])
        else:
            acc.index_add_(0, mi.ep, dv[2 * ch])
            acc_r = torch.zeros_like(acc)
            acc_r.index_add_(0, mi.ep ^ 1, dv[2 * ch + 1])
            acc += acc_r
        u = acc[:E] * mi.recip
        upd[ch, :E] = u
        coords[ch] += u


def _ordered_sums(plane, mi: "MergeIndex", owner):
    """f64 sum of `plane` over the CSR list of endpoint owner[e], for every
    e, one list position after the other: each sum runs over its slots in
    ascending order, as np.bincount and `strata_merge_sum` add them."""
    off = mi.csr_off.to(torch.int64)
    start, n = off[owner], (off[1:] - off[:-1])[owner]
    last = max(int(mi.csr_slot.shape[0]) - 1, 0)
    acc = torch.zeros(owner.shape[0], dtype=torch.float64, device=plane.device)
    for k in range(int(n.max()) if n.numel() else 0):
        slot = mi.csr_slot[torch.clamp(start + k, max=last)].to(torch.int64)
        acc = torch.where(n > k, acc + plane[slot].to(torch.float64), acc)
    return acc


def merge_sum_ordered_plain(drift, mi: "MergeIndex", coords, upd):
    """`merge_sum_plain` with every sum in ascending slot order (a loop over
    the CSR): the exact reference of `strata_merge_sum`'s order, for the
    tests and the card checks, never on the main path."""
    nc, E = coords.shape
    e = torch.arange(E, device=drift.device)
    for ch in range(nc):
        if nc == 1:
            acc = _ordered_sums(drift[0], mi, e)
        else:
            acc = _ordered_sums(drift[2 * ch], mi, e) + _ordered_sums(drift[2 * ch + 1], mi, e ^ 1)
        u = acc * mi.recip
        upd[ch, :E] = u
        coords[ch] += u


def merge_bcast_plain(drift, base, mi: "MergeIndex", upd):
    """base += f32(upd) of each slot's endpoints; drift = 0."""
    if upd.shape[0] == 1:
        base[0] += upd[0][mi.ep].to(torch.float32)
    else:
        epr = mi.ep ^ 1
        base[0] += upd[0][mi.ep].to(torch.float32)
        base[1] += upd[0][epr].to(torch.float32)
        base[2] += upd[1][mi.ep].to(torch.float32)
        base[3] += upd[1][epr].to(torch.float32)
    drift.zero_()


def merge_sum_blocked_plain(drift, mi: "MergeIndex", bsch: BlockSchedule, coords, upd):
    """`merge_sum_plain`, node block by node block of the schedule `bsch`,
    each over its span of the CSR (a block's endpoints own a contiguous run
    of it).  Each endpoint's slots arrive in ascending order, so the f64
    sums equal `merge_sum_plain`'s exactly.  As `strata_merge_sum_blocked`,
    it reads the slots, not the schedule's tiles."""
    nc, E = coords.shape
    dv = drift.to(torch.float64)
    off = mi.csr_off.tolist()
    acc_f = torch.zeros((nc, mi.ecap), dtype=torch.float64, device=drift.device)
    acc_r = torch.zeros_like(acc_f)
    for b in range(bsch.num_blocks):
        lo, hi = min(b * bsch.bs, E), min((b + 1) * bsch.bs, E)
        sl = mi.csr_slot[off[lo]:off[hi]].to(torch.int64)
        idx = mi.ep[sl]
        if nc == 1:
            acc_f[0].index_add_(0, idx, dv[0, sl])
            continue
        for ch in range(nc):
            acc_f[ch].index_add_(0, idx, dv[2 * ch, sl])
            acc_r[ch].index_add_(0, idx ^ 1, dv[2 * ch + 1, sl])
    for ch in range(nc):
        acc = acc_f[ch] if nc == 1 else acc_f[ch] + acc_r[ch]
        u = acc[:E] * mi.recip
        upd[ch, :E] = u
        coords[ch] += u


# ---------------------------------------------------------------------------
# Run state and the 1D/2D runs
# ---------------------------------------------------------------------------


@dataclass
class MergeIndex:
    """Endpoint maps of the consensus merge, built once per graph.

    ep: i32 (L,) endpoint of every slot's forward replica (2D: the packed
        handle 2*node+orient, so slot s's complement replica is ep ^ 1;
        1D: the node); pad slots hold the dummy E (2D: E and E+1).
    csr_off, csr_slot: i32 CSR of endpoint -> ascending list of the real
        slots s with ep[s] == endpoint (the kernel's summation order,
        which is np.bincount's).
    recip: f64 (E,) 1/R per endpoint (0 for step-less nodes).
    block_eps: the endpoints one thread block of `strata_merge_sum` sums
        (`merge_block_eps`).
    """

    ep: torch.Tensor
    csr_off: torch.Tensor
    csr_slot: torch.Tensor
    recip: torch.Tensor
    ecap: int
    block_eps: int

    @staticmethod
    @span("strata.merge_index")
    def build(g, num_slots: int, one_d: bool, device) -> "MergeIndex":
        E = g.num_nodes if one_d else 2 * g.num_nodes
        ep, off, order = merge_csr(g.step_handle, g.num_nodes, num_slots, one_d)
        r = np.diff(off).astype(np.float64)
        if not one_d:  # 1/R of a node on both of its endpoints
            r = np.repeat(r[0::2] + r[1::2], 2)
        recip = np.where(r > 0, 1.0 / np.maximum(r, 1), 0.0)
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
        return MergeIndex(
            ep=t(ep, torch.int32),
            csr_off=t(off, torch.int32),
            csr_slot=t(order, torch.int32),
            recip=t(recip, torch.float64),
            ecap=E + (1 if one_d else 2),
            block_eps=merge_block_eps(off),
        )

    def to(self, device) -> "MergeIndex":
        """The index with its tensors on `device`."""
        return dataclasses.replace(self, ep=self.ep.to(device), csr_off=self.csr_off.to(device),
                                   csr_slot=self.csr_slot.to(device),
                                   recip=self.recip.to(device))


def merge_csr(h: np.ndarray, num_nodes: int, num_slots: int, one_d: bool):
    """(ep, off, slot) i32 of the step handles `h` over E endpoints (the
    node in 1D, the handle in 2D): ep (num_slots,) each slot's endpoint, E
    on the pad slots; off (E+1,) and slot (S,) the CSR of each endpoint's
    slots in ascending order.  A stable counting sort in C++
    (``native/src/strata_steps.cpp``), or numpy's stable argsort where it
    is missing."""
    h = np.ascontiguousarray(h, dtype=np.int64)
    if num_slots < len(h):
        raise ValueError(f"{num_slots} slots hold fewer than the {len(h)} steps")
    lib = native.steps_pass()
    if lib is None:
        return merge_csr_numpy(h, num_nodes, num_slots, one_d)
    E, S = (num_nodes if one_d else 2 * num_nodes), len(h)
    ep = np.empty(num_slots, np.int32)
    off = np.empty(E + 1, np.int32)
    slot = np.empty(S, np.int32)
    if lib.odgi_merge_csr(S, h.ctypes.data, num_nodes, int(one_d), num_slots, ep.ctypes.data,
                          off.ctypes.data, slot.ctypes.data) < 0:
        raise ValueError("a step's node is not below the node count")
    return ep, off, slot


def merge_csr_numpy(h: np.ndarray, num_nodes: int, num_slots: int, one_d: bool):
    """`merge_csr` in numpy."""
    E, key = (num_nodes, h >> 1) if one_d else (2 * num_nodes, h)
    ep = np.full(num_slots, E, np.int32)
    ep[:len(h)] = key
    off = np.zeros(E + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=E), out=off[1:])
    return ep, off.astype(np.int32), np.argsort(key, kind="stable").astype(np.int32)


SUM_TILE = 4096  # CSR entries a thread block of strata_merge_sum stages at once
SUM_THREADS = 256


def merge_block_eps(csr_off: np.ndarray) -> int:
    """Endpoints one thread block of `strata_merge_sum` sums: the largest
    power of two whose lists, at the mean list length, fill at most one
    staged tile of SUM_TILE CSR entries, in [2, SUM_THREADS]."""
    off = np.asarray(csr_off, np.int64)
    mean = float(off[-1] - off[0]) / max(len(off) - 1, 1)
    b = 2
    while b * 2 <= SUM_THREADS and b * 2 * mean <= SUM_TILE:
        b *= 2
    return b


def fill_slots(g, data: StrataData, coords: torch.Tensor):
    """(planes, base): the slot arrays of a run of `g` in the layout `data`,
    filled on `coords`' device from the step table.

    planes: i32 (4, L) [pos, pos_end, handle, path] for 2D, (3, L) [pos,
        handle, path] for 1D; pos_end = pos + the node's length, path from
        ``path_offset``; the pad slots past the last step hold path -1,
        handle 2*num_nodes and pos = pos_end = 0 (see ``StrataData``).
    base: f32 (4, L) [xf, xr, yf, yr] for 2D, (1, L) for 1D: `coords` (f64
        (2, 2N) per endpoint, or (1, N) per node) rounded to f32, at each
        slot's handle h and its complement h ^ 1 (1D: at its node h >> 1);
        0 on the pad slots.

    The step handles and positions are copied once, as int64, and cast on
    the device (on an H100 a host cast to int32 first took longer than the
    wider copy); nothing the size of the slots is built on the host."""
    dev = coords.device
    S, L, one_d = data.num_steps, data.num_slots, data.one_d
    if one_d:
        (r_pos, r_handle, r_path), pad = (P1_POS, P1_HANDLE, P1_PATH), [0, 2 * data.num_nodes, -1]
    else:
        (r_pos, r_handle, r_path), pad = (POS, HANDLE, PATH), [0, 0, 2 * data.num_nodes, -1]
    planes = torch.empty((len(pad), L), dtype=torch.int32, device=dev)
    planes[:, S:] = torch.tensor(pad, dtype=torch.int32, device=dev)[:, None]
    h = torch.as_tensor(g.step_handle, device=dev).to(torch.int32)
    planes[r_handle, :S] = h
    planes[r_pos, :S] = torch.as_tensor(g.step_pos, device=dev)
    # path ids: +1 at every later path's first step (twice where a path
    # between is empty), summed along the steps
    starts = np.asarray(g.path_offset[1:-1])
    starts = torch.as_tensor(starts[starts < S], device=dev)
    marks = torch.zeros(S, dtype=torch.int32, device=dev)
    marks.index_add_(0, starts, torch.ones(starts.shape, dtype=torch.int32, device=dev))
    torch.cumsum(marks, 0, dtype=torch.int32, out=planes[r_path, :S])
    if not one_d:
        node_len = torch.as_tensor(g.node_len, device=dev).to(torch.int32)
        torch.add(planes[POS, :S], torch.index_select(node_len, 0, h >> 1),
                  out=planes[POSEND, :S])
    c32 = coords.to(torch.float32)
    base = torch.empty((1 if one_d else 4, L), dtype=torch.float32, device=dev)
    base[:, S:] = 0.0
    if one_d:
        ends = ((0, h >> 1),)
    else:
        hr = h ^ 1
        ends = ((0, h), (0, hr), (1, h), (1, hr))
    for row, (ch, idx) in enumerate(ends):
        torch.index_select(c32[ch], 0, idx, out=base[row, :S])
    return planes, base


@dataclass
class StrataState:
    """Device tensors of one strata run (see the module docstring).

    On the "xxl" route every graph array (and `coords`) is in the
    relabeled numbering; `order` maps it back."""

    plan: dict
    one_d: bool
    planes: torch.Tensor   # i32 (4 or 3, L)
    base: torch.Tensor     # f32 (4 or 1, L)
    drift: torch.Tensor    # f32 (4 or 1, L)
    od: torch.Tensor       # i32 (chunks, 2)
    eta: torch.Tensor      # f32 (iter_max,)
    mi: MergeIndex
    coords: torch.Tensor   # f64 (2 or 1, E) node coordinates
    upd: torch.Tensor      # f64 (2 or 1, E_cap) last merge's update
    perm: torch.Tensor     # i32 (chunks,) the chunks by (group, level, index)
    lvl_rows: list         # each group's i32 level offsets into perm
    pred_off: torch.Tensor  # i32 (chunks + 1,) offsets into pred
    pred: torch.Tensor      # i32 each chunk's predecessors (strata_levels)
    dmax: torch.Tensor     # f32 (groups,) each tracked group's Delta_max
    route: str = "resident"
    bsch: Optional[BlockSchedule] = None  # "xxl"
    order: Optional[np.ndarray] = None    # "xxl": relabel order

    @staticmethod
    @span("strata.build")
    def build(g, cfg, init: np.ndarray, one_d: bool, device,
              route: str = "resident", plan: Optional[dict] = None) -> "StrataState":
        """`init`: (2N, 2) coordinates for 2D, (N,) positions for 1D, in
        `g`'s numbering.  `plan` replaces `plan_run`'s plan of `g` (the
        sharded run's stacked plan); the "xxl" route, which relabels `g`,
        takes none.  The host work comes first, in its own spans (relabel,
        plan, chunk schedule, merge index, block schedule), then every copy
        to `device`, the step table's among them, and the slot arrays'
        fill there (``fill_slots``; ``strata.upload``)."""
        if route not in ROUTES:
            raise ValueError(f"strata route {route!r} is not one of {ROUTES}")
        order = None
        if route == "xxl":
            if plan is not None:
                raise ValueError("the xxl route relabels the graph and plans it itself")
            with span("strata.relabel"):
                g, order = relabel(g)
                init = relabel_coords(np.asarray(init), order)
        p = plan_run(g, cfg, one_d=one_d) if plan is None else plan
        data = p["data"]
        L = data.num_slots
        if int((p["o_blk"].astype(np.int64) * LANE + CHUNK + p["d_arr"]).max()) > L:
            raise AssertionError("strata plan: a window runs past the planes")
        perm_h, lvl_off, pred_off, pred = strata_levels.chunk_schedule(p)
        mi = MergeIndex.build(g, L, one_d, torch.device("cpu"))
        bsch = BlockSchedule.build(g, one_d, torch.device("cpu")) if route == "xxl" else None
        with span("strata.upload"):
            if one_d:
                coords = np.asarray(init, np.float32).astype(np.float64)[None, :]
            else:
                coords = np.asarray(init, np.float64).T
            od = np.stack([p["o_blk"], p["d_arr"]], axis=1).astype(np.int32)
            mi = mi.to(device)
            t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
            coords_t = t(coords, torch.float64)
            planes, base = fill_slots(g, data, coords_t)
            count("strata.slots_device")
            off_t = t(lvl_off, torch.int32)
            return StrataState(
                plan=p,
                one_d=one_d,
                planes=planes,
                base=base,
                drift=torch.zeros_like(base),
                od=t(od, torch.int32),
                eta=t(p["eta_table"], torch.float32),
                mi=mi,
                coords=coords_t,
                upd=torch.zeros((coords.shape[0], mi.ecap), dtype=torch.float64, device=device),
                perm=t(perm_h, torch.int32),
                lvl_rows=[off_t[gid, :n + 1]
                          for gid, n in enumerate(strata_levels.depths(lvl_off))],
                pred_off=t(pred_off, torch.int32),
                pred=t(pred, torch.int32),
                dmax=torch.zeros(p["groups"], dtype=torch.float32, device=device),
                route=route,
                bsch=None if bsch is None else bsch.to(device),
                order=order,
            )

    def run_group(self, gid: int, track: bool = False) -> None:
        """One merge group: the chunk phase on the leveled kernel (with
        `track`, the tracking instance, into dmax[gid]), then the route's
        consensus merge."""
        chunks = kernels.strata_chunks_1d_levels if self.one_d else kernels.strata_chunks_2d_levels
        kw = dict(dmax=self.dmax[gid:gid + 1]) if track else {}
        chunks(self.drift, self.base, self.planes, self.od, self.eta, self.plan["cpi"],
               self.perm, self.lvl_rows[gid], self.pred_off, self.pred, **kw)
        if self.route == "xxl":
            kernels.strata_merge_sum_blocked(self.drift, self.mi, self.bsch,
                                             self.coords, self.upd)
        else:
            kernels.strata_merge_sum(self.drift, self.mi, self.coords, self.upd)
        kernels.strata_merge_bcast(self.drift, self.base, self.mi, self.upd)

    def merges_per_iteration(self) -> int:
        """The merge groups of one iteration.  Every group lies within one
        iteration (K = 1 iteration a merge, the plan the reference forces
        for delta runs); raise if the plan says otherwise."""
        p = self.plan
        mpi = p["cpi"] // p["cgs"]
        iters = int(self.eta.shape[0])
        if mpi * p["cgs"] != p["cpi"] or p["groups"] != iters * mpi:
            raise AssertionError(f"strata plan: groups {p['groups']} of {p['cgs']} chunks "
                                 f"do not tile {iters} iterations of {p['cpi']}")
        return mpi

    @span("strata.run")
    def run(self, delta: float = 0.0) -> dict:
        """The run's groups in order.  With delta > 0 (-j) the chunk phase
        tracks each group's Delta_max, and the run stops after the first
        iteration whose max over its groups is at most delta: one host
        read an iteration.  Returns dict(iterations, delta_max), the
        per-iteration maxima of a tracked run (else empty)."""
        if delta <= 0:
            for gid in range(self.plan["groups"]):
                self.run_group(gid)
            return dict(iterations=int(self.eta.shape[0]), delta_max=[])
        mpi = self.merges_per_iteration()
        delta_max = []
        for it in range(int(self.eta.shape[0])):
            for gid in range(it * mpi, (it + 1) * mpi):
                self.run_group(gid, track=True)
            delta_max.append(float(self.dmax[it * mpi:(it + 1) * mpi].max()))
            if delta_max[-1] <= delta:
                break
        return dict(iterations=len(delta_max), delta_max=delta_max)


def path_sgd_2d_strata(g, coords0, cfg, device, route: Optional[str] = None) -> torch.Tensor:
    """2D strata run from (2N, 2) `coords0`; f64 (2N, 2) on `device`.
    `route` forces a route (default: `graph_route`); cfg.delta > 0 stops
    early (`StrataState.run`).  The run's iterations and Delta_max values
    go to ``ops.sgd.LAST_RUN``."""
    route = graph_route(g, cfg, one_d=False) if route is None else route
    st = StrataState.build(g, cfg, np.asarray(coords0, np.float64), False,
                           torch.device(device), route)
    LAST_RUN.update(route=route, **st.run(cfg.delta))
    return unrelabel(st.coords.T.contiguous(), st.order)


def path_sgd_1d_strata(g, cfg, x0, device, route: Optional[str] = None) -> torch.Tensor:
    """1D strata run from `x0` (default: node offsets); f64 (N,) on
    `device`.  `route` and cfg.delta as `path_sgd_2d_strata`."""
    route = graph_route(g, cfg, one_d=True) if route is None else route
    x0v = g.node_offset.astype(np.float32) if x0 is None else np.asarray(x0, np.float32)
    st = StrataState.build(g, cfg, x0v, True, torch.device(device), route)
    LAST_RUN.update(route=route, **st.run(cfg.delta))
    return unrelabel(st.coords[0].clone(), st.order)
