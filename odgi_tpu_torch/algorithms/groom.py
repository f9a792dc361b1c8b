"""Groom: re-orient nodes to the dominant strand (host).

Walks the graph rightward from the head nodes with a stack (the reference's
deque that pops from the back); the orientation in which a node is first
visited decides whether it is flipped; with target paths, their nodes
seed the walk and take the orientation that makes the target traversal
forward.  The node order is unchanged.  The walk runs in C++
(``native/src/graph_passes.cpp``), or in Python where g++ is missing; each
call counts the path it took (``gs.native`` / ``gs.python``), the nodes it
flips (``groom.flipped``) and its restarts from the lowest unvisited node,
one a node no seed reaches (``groom.restarts``), in
``utils.metrics.TOTALS``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import native
from ..core.graph import GraphTensors
from ..utils.metrics import count, span
from .topological import head_nodes


def groom(g: GraphTensors, target_paths: Optional[Sequence[int]] = None) -> np.ndarray:
    """bool[N] flip mask (True = flip the node's orientation)."""
    n = g.num_nodes
    is_ref = needs_flipping = None
    if target_paths:
        # each node's first step along the target paths, in path order
        h = np.concatenate([g.step_handle[int(g.path_offset[p]):int(g.path_offset[p + 1])]
                            for p in target_paths]).astype(np.int64)
        seeds = h[np.sort(np.unique(h >> 1, return_index=True)[1])]
        is_ref = np.zeros(n, dtype=bool)
        is_ref[seeds >> 1] = True
        needs_flipping = np.zeros(n, dtype=bool)
        needs_flipping[seeds >> 1] = (seeds & 1).astype(bool)
    else:
        seeds = head_nodes(g) << 1
    lib = native.gs_pass()
    if lib is None:
        flipped, restarts = _groom_walk(g, seeds, is_ref, needs_flipping)
    else:
        off, tgt = native.csr_arrays(g.adjacency, n)
        seeds = np.ascontiguousarray(seeds, dtype=np.int64)
        flipped = np.zeros(n, dtype=bool)
        refs = (None, None) if is_ref is None else (is_ref.ctypes.data, needs_flipping.ctypes.data)
        restarts = lib.odgi_groom(2 * n, off.ctypes.data, len(tgt), tgt.ctypes.data,
                                  len(seeds), seeds.ctypes.data, *refs, flipped.ctypes.data)
        if restarts < 0:
            raise ValueError("the adjacency or a seed holds a handle not below 2N")
    count("groom.flipped", int(flipped.sum()))
    count("groom.restarts", restarts)
    return flipped


def _groom_walk(g: GraphTensors, seeds: np.ndarray, is_ref: Optional[np.ndarray],
                needs_flipping: Optional[np.ndarray]) -> tuple:
    """(flip mask, restarts) of the groom walk from `seeds`, in Python."""
    n = g.num_nodes
    adj = g.adjacency
    unvisited = np.ones(n, dtype=bool)
    flipped = np.zeros(n, dtype=bool)
    if is_ref is None:
        is_ref = needs_flipping = np.zeros(n, dtype=bool)
    # the first seed on top; discovered nodes before the remaining seeds
    stack = [int(h) for h in reversed(seeds)]
    targets = adj.targets
    offsets = adj.offsets
    restarts = 0
    while True:
        while stack:
            h = stack.pop()
            r = h >> 1
            if not unvisited[r]:
                continue
            unvisited[r] = False
            if is_ref[r]:
                flipped[r] = needs_flipping[r]
            else:
                flipped[r] = bool(h & 1)
            for nb in targets[offsets[h] : offsets[h + 1]]:
                if unvisited[nb >> 1]:
                    stack.append(int(nb))
        rest = np.nonzero(unvisited)[0]
        if len(rest) == 0:
            break
        stack = [int(rest[0]) << 1]
        restarts += 1
    return flipped, restarts


@span("sort.groom")
def apply_groom(
    g: GraphTensors, target_paths: Optional[Sequence[int]] = None
) -> GraphTensors:
    """Groom and apply the orientation flips (order unchanged)."""
    return g.apply_orientations(groom(g, target_paths))
