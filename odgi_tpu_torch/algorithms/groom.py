"""Groom: re-orient nodes to the dominant strand (host).

Walks the graph rightward from the head nodes with a stack (the reference's
deque that pops from the back); the orientation in which a node is first
visited decides whether it is flipped.  The node order is unchanged.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import GraphTensors
from .topological import head_nodes


def groom(g: GraphTensors) -> np.ndarray:
    """bool[N] flip mask (True = flip the node's orientation)."""
    n = g.num_nodes
    adj = g.adjacency
    unvisited = np.ones(n, dtype=bool)
    flipped = np.zeros(n, dtype=bool)

    seeds = [int(r) << 1 for r in head_nodes(g)]
    # the first seed on top; discovered nodes before the remaining seeds
    stack = list(reversed(seeds))
    targets = adj.targets
    offsets = adj.offsets
    while True:
        while stack:
            h = stack.pop()
            r = h >> 1
            if not unvisited[r]:
                continue
            unvisited[r] = False
            flipped[r] = bool(h & 1)
            for nb in targets[offsets[h] : offsets[h + 1]]:
                if unvisited[nb >> 1]:
                    stack.append(int(nb))
        rest = np.nonzero(unvisited)[0]
        if len(rest) == 0:
            break
        stack = [int(rest[0]) << 1]
    return flipped


def apply_groom(g: GraphTensors) -> GraphTensors:
    """Groom and apply the orientation flips (order unchanged)."""
    return g.apply_orientations(groom(g))
