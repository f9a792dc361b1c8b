"""Host side of the XXL route: relabel by first visit, node blocks and the
(block, tile) merge schedule (numpy).

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
    nodes no step visits (ascending)."""
    node = (g.step_handle >> 1).astype(np.int64)
    vals, idx = np.unique(node, return_index=True)
    visited = vals[np.argsort(idx)]
    unvisited = np.setdiff1d(np.arange(g.num_nodes, dtype=np.int64), vals)
    return np.concatenate([visited, unvisited])


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
    node = (g.step_handle >> 1).astype(np.int64)
    if one_d:
        ep = node
        idx_count = g.num_nodes + 1
    else:
        ep = 2 * node + (g.step_handle & 1).astype(np.int64)
        idx_count = 2 * g.num_nodes + 2
    _, _, nb = block_geometry(idx_count, bs)
    tile = np.arange(g.num_steps, dtype=np.int64) // TILE
    blk = ep // bs
    n_tiles_tot = int(tile.max()) + 1 if len(tile) else 1
    pairs = np.unique(blk * n_tiles_tot + tile)
    b_arr = (pairs // n_tiles_tot).astype(np.int32)
    t_arr = (pairs % n_tiles_tot).astype(np.int32)
    K = len(pairs)
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
