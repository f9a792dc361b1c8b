"""Host side of the XXL route: relabel by first visit, node blocks and the
(block, tile) merge schedule (counting passes in C++, numpy where g++ is
missing).

The counterpart of the host half of ``odgi_tpu/ops/pallas_sgd_xxl.py``
(``_locality_order``, the relabel in ``path_sgd_2d_pallas_xxl`` /
``path_sgd_1d_pallas_xxl``, ``_block_geometry``, ``_build_schedule``).  The
blocked sum (``csrc/strata_blocked.cu``) splits the endpoints into blocks
of ``XXL_BS`` and folds each block's span of the merge CSR; the schedule
lists, per block, the step tiles (TR*LANE slots) that hold one of its
endpoints.  Relabeling nodes by first visit along the step table keeps a
block's slots in few tiles, and gives neighbouring slots neighbouring
endpoints, whatever the input ids were.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..utils.metrics import span
from .strata_plan import LANE, TR, _pad_to

# Endpoints per node block; the blocked sum splits each over thread blocks
# of 256 endpoints.  (The TPU kernel's blocks hold 32,768.)  Tests shrink it.
XXL_BS = 2048
# Slots per merge tile.
TILE = TR * LANE
# The JAX package pads the schedule to a multiple of its SMEM batch.
SCHED_BATCH = 512


def locality_order(g) -> np.ndarray:
    """Nodes in order of first appearance along the step table, then the
    nodes no step visits (ascending): one pass over the steps in C++
    (``native/src/strata_steps.cpp``), or in numpy where it is missing."""
    h = np.ascontiguousarray(g.step_handle, dtype=np.int64)
    lib = native.steps_pass()
    if lib is None:
        return locality_order_numpy(h, g.num_nodes)
    order = np.empty(g.num_nodes, np.int64)
    if lib.odgi_first_visit(len(h), h.ctypes.data, g.num_nodes, order.ctypes.data) < 0:
        raise ValueError("a step's node is not below the node count")
    return order


def locality_order_numpy(h: np.ndarray, num_nodes: int) -> np.ndarray:
    """`locality_order` from the step handles `h`, in numpy."""
    vals, idx = np.unique(h >> 1, return_index=True)
    unvisited = np.setdiff1d(np.arange(num_nodes, dtype=np.int64), vals)
    return np.concatenate([vals[np.argsort(idx)], unvisited])


def relabel(g):
    """(g_run, order): `g` renumbered by `locality_order`, and the order
    (None when `g` is in first-visit order already; g_run is g then)."""
    order = locality_order(g)
    if np.array_equal(order, np.arange(g.num_nodes, dtype=np.int64)):
        return g, None
    return g.apply_ordering(order), order


def relabel_coords(coords: np.ndarray, order) -> np.ndarray:
    """(2N, 2) coordinates, or (N,) positions, in g_run's numbering."""
    if order is None:
        return coords
    if coords.ndim == 1:
        return coords[order]
    n = len(order)
    return coords.reshape(n, 2, 2)[order].reshape(2 * n, 2)


def unrelabel(res: torch.Tensor, order) -> torch.Tensor:
    """Inverse of `relabel_coords` for a (2N, 2) or (N,) tensor."""
    if order is None:
        return res
    idx = torch.as_tensor(order, device=res.device)
    out = torch.empty_like(res)
    if res.dim() == 1:
        out[idx] = res
        return out
    n = len(order)
    out.view(n, 2, 2)[idx] = res.reshape(n, 2, 2)
    return out


def block_geometry(idx_count: int, bs: int):
    """(NL node-array rows of LANE, BW rows per block, NB blocks) for
    `idx_count` endpoints in blocks of `bs` (a multiple of LANE)."""
    bw = bs // LANE
    nl = _pad_to(max(-(-idx_count // LANE), 1), max(8, bw))
    return nl, bw, nl // bw


def build_schedule(g, bs: int, one_d: bool):
    """The (block, tile) incidence schedule of the real steps, sorted by
    (block, tile): (sched (8, Kpad) i32 rows [tile, block, first, last,
    safe, 0, 0, 0], K, NB).  `first` / `last` mark a block's first and last
    entry; `safe` marks an entry whose successor reads another tile."""
    idx_count = g.num_nodes + 1 if one_d else 2 * g.num_nodes + 2
    _, _, nb = block_geometry(idx_count, bs)
    t_arr, b_arr = schedule_entries(g.step_handle, g.num_nodes, bs, nb, one_d)
    K = len(t_arr)
    first = np.zeros(K, np.int32)
    last = np.zeros(K, np.int32)
    first[0] = 1
    first[1:] = (b_arr[1:] != b_arr[:-1]).astype(np.int32)
    last[:-1] = first[1:]
    last[-1] = 1
    kpad = _pad_to(max(K, 1), SCHED_BATCH)
    sched = np.zeros((8, kpad), np.int32)
    sched[0, :K] = t_arr
    sched[1, :K] = b_arr
    sched[2, :K] = first
    sched[3, :K] = last
    safe = np.ones(K, np.int32)
    if K > 1:
        safe[:-1] = (t_arr[1:] != t_arr[:-1]).astype(np.int32)
    sched[4, :K] = safe
    return sched, K, nb


def schedule_entries(h: np.ndarray, num_nodes: int, bs: int, nb: int, one_d: bool):
    """(tile, block) i32 (K,): the distinct (endpoint // bs, step // TILE)
    pairs of the step handles `h`, sorted by (block, tile), of `nb` blocks:
    one pass over the steps and a count per block in C++
    (``native/src/strata_steps.cpp``), or in numpy where it is missing."""
    h = np.ascontiguousarray(h, dtype=np.int64)
    lib = native.steps_pass()
    if lib is None:
        return schedule_entries_numpy(h, bs, one_d)
    n_tiles = -(-len(h) // TILE)
    t_arr = np.empty(max(8 * (n_tiles + nb), 1), np.int32)
    b_arr = np.empty_like(t_arr)
    for _ in range(2):  # once more with room for every entry, if the guess was short
        K = lib.odgi_block_schedule(len(h), h.ctypes.data, num_nodes, int(one_d), bs, nb,
                                    t_arr.ctypes.data, b_arr.ctypes.data, len(t_arr))
        if K < 0:
            raise ValueError("a step's node is not below the node count")
        if K <= len(t_arr):
            break
        t_arr, b_arr = np.empty(K, np.int32), np.empty(K, np.int32)
    return t_arr[:K].copy(), b_arr[:K].copy()


def schedule_entries_numpy(h: np.ndarray, bs: int, one_d: bool):
    """`schedule_entries` in numpy."""
    ep = h >> 1 if one_d else h
    tile = np.arange(len(h), dtype=np.int64) // TILE
    n_tiles = int(tile.max()) + 1 if len(tile) else 1
    pairs = np.unique(ep // bs * n_tiles + tile)
    return (pairs % n_tiles).astype(np.int32), (pairs // n_tiles).astype(np.int32)


@dataclass
class BlockSchedule:
    """Device form of the schedule for the blocked merges.

    tile, block: i32 (K,) the entries, sorted by (block, tile);
    blk_off: i32 (NB+1,) entries of block b are blk_off[b]:blk_off[b+1];
    bs: endpoints per block; num_steps: S (slots past S are pad)."""

    tile: torch.Tensor
    block: torch.Tensor
    blk_off: torch.Tensor
    bs: int
    num_steps: int

    @property
    def num_entries(self) -> int:
        return self.tile.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.blk_off.shape[0] - 1

    @staticmethod
    @span("strata.block_schedule")
    def build(g, one_d: bool, device, bs: int | None = None) -> "BlockSchedule":
        bs = XXL_BS if bs is None else bs
        sched, K, nb = build_schedule(g, bs, one_d)
        blk_off = np.searchsorted(sched[1, :K], np.arange(nb + 1), side="left")
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                      device=device)
        return BlockSchedule(tile=t(sched[0, :K]), block=t(sched[1, :K]),
                             blk_off=t(blk_off), bs=bs, num_steps=g.num_steps)

    def to(self, device) -> "BlockSchedule":
        """The schedule with its tensors on `device`."""
        return dataclasses.replace(self, tile=self.tile.to(device), block=self.block.to(device),
                                   blk_off=self.blk_off.to(device))
