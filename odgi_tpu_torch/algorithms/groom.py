"""Groom: re-orient nodes to the dominant strand (host).

Walks the graph rightward from the head nodes with a stack (the reference's
deque that pops from the back); the orientation in which a node is first
visited decides whether it is flipped; with target paths, their nodes
seed the walk and take the orientation that makes the target traversal
forward.  The node order is unchanged.  Each call counts the nodes it
flips (``groom.flipped``) and its restarts from the lowest unvisited node,
one a node no seed reaches (``groom.restarts``), in
``utils.metrics.TOTALS``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.graph import GraphTensors
from ..utils.metrics import count, span
from .topological import head_nodes


def groom(g: GraphTensors, target_paths: Optional[Sequence[int]] = None) -> np.ndarray:
    """bool[N] flip mask (True = flip the node's orientation)."""
    n = g.num_nodes
    adj = g.adjacency
    unvisited = np.ones(n, dtype=bool)
    flipped = np.zeros(n, dtype=bool)

    is_ref = np.zeros(n, dtype=bool)
    needs_flipping = np.zeros(n, dtype=bool)
    seeds = []
    if target_paths:
        for p in target_paths:
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            for h in g.step_handle[lo:hi]:
                h = int(h)
                r = h >> 1
                if not is_ref[r]:
                    is_ref[r] = True
                    seeds.append(h)
                    if h & 1:
                        needs_flipping[r] = True
    else:
        seeds = [int(r) << 1 for r in head_nodes(g)]
    # the first seed on top; discovered nodes before the remaining seeds
    stack = list(reversed(seeds))
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
    count("groom.flipped", int(flipped.sum()))
    count("groom.restarts", restarts)
    return flipped


@span("sort.groom")
def apply_groom(
    g: GraphTensors, target_paths: Optional[Sequence[int]] = None
) -> GraphTensors:
    """Groom and apply the orientation flips (order unchanged)."""
    return g.apply_orientations(groom(g, target_paths))
