"""Unchop: merge perfect-neighbor chains into single nodes, the
counterpart of ``odgi_tpu/algorithms/unchop.py``.

Oriented handles (a -> b) merge when every path visit to a continues
directly into b and b carries exactly as many visits, with one edge on
each joining side.  Traversal-pair counts come from one pass over
consecutive step pairs; chains are found by walking the unique-successor
map.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np

from ..core.graph import GraphBuilder, GraphTensors
from .coverage import node_depth


def _perfect_next(g: GraphTensors) -> Dict[int, int]:
    """Map packed handle -> unique perfect successor handle."""
    depth = node_depth(g)
    # traversal-pair counts over both path directions
    counts: Counter = Counter()
    for p in range(g.num_paths):
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        hs = g.step_handle[lo:hi]
        for k in range(len(hs) - 1):
            a, b = int(hs[k]), int(hs[k + 1])
            counts[(a, b)] += 1
            counts[(b ^ 1, a ^ 1)] += 1

    adj = g.adjacency
    nxt: Dict[int, int] = {}
    for h in range(2 * g.num_nodes):
        nb = adj.neighbors(h)
        if len(nb) != 1:
            continue
        b = int(nb[0])
        if (h >> 1) == (b >> 1):
            continue  # self loop
        # unique incoming on b's joining side
        if len(adj.neighbors(b ^ 1)) != 1:
            continue
        da, db = int(depth[h >> 1]), int(depth[b >> 1])
        if da == 0 or da != db:
            continue
        if counts.get((h, b), 0) != da:
            continue
        nxt[h] = b
    return nxt


def unchop(g: GraphTensors) -> GraphTensors:
    """Merge all perfect-neighbor chains (reference: unchop.hpp:23-28)."""
    n = g.num_nodes
    nxt = _perfect_next(g)
    prv = {b: a for a, b in nxt.items()}

    # chain heads: handles in the successor graph with no predecessor.
    used = np.zeros(n, dtype=bool)
    chains: List[List[int]] = []
    for h in list(nxt.keys()) + [b for b in prv.keys()]:
        r = h >> 1
        if used[r]:
            continue
        # rewind to the head
        start = h
        seen = {start}
        while start in prv:
            start = prv[start]
            if start in seen:  # cycle: break arbitrarily here
                break
            seen.add(start)
        if used[start >> 1]:
            continue
        chain = [start]
        used[start >> 1] = True
        cur = start
        while cur in nxt:
            cur = nxt[cur]
            if used[cur >> 1]:
                break
            chain.append(cur)
            used[cur >> 1] = True
        if len(chain) > 1:
            chains.append(chain)
        else:
            used[start >> 1] = True

    in_chain = np.full(n, -1, dtype=np.int64)     # node -> chain idx
    chain_pos = np.zeros(n, dtype=np.int64)
    chain_rev = np.zeros(n, dtype=bool)           # node flipped in chain?
    for ci, chain in enumerate(chains):
        for k, h in enumerate(chain):
            in_chain[h >> 1] = ci
            chain_pos[h >> 1] = k
            chain_rev[h >> 1] = bool(h & 1)

    # Build merged graph: chains become one node; others carry over.
    b = GraphBuilder()
    new_id = 1
    node_map: Dict[int, int] = {}  # old rank -> new rank (for non-chain)
    chain_rank: Dict[int, int] = {}
    for r in range(n):
        ci = in_chain[r]
        if ci < 0:
            node_map[r] = b.add_node(new_id, g.node_seq(r))
            new_id += 1
    for ci, chain in enumerate(chains):
        seq = b"".join(g.node_seq(h >> 1, bool(h & 1)) for h in chain)
        chain_rank[ci] = b.add_node(new_id, seq)
        new_id += 1

    def map_handle(h: int) -> int:
        r, rev = h >> 1, h & 1
        ci = in_chain[r]
        if ci < 0:
            return (node_map[r] << 1) | rev
        # orientation within the chain: if the node sits reversed in the
        # chain, a forward visit to it is a reverse visit to the chain
        crev = rev ^ int(chain_rev[r])
        return (chain_rank[ci] << 1) | crev

    # edges: drop chain-internal, remap the rest (dedup via canonical form)
    for a, t in zip(g.edge_from, g.edge_to):
        a, t = int(a), int(t)
        ra, rt = a >> 1, t >> 1
        if (
            in_chain[ra] >= 0
            and in_chain[ra] == in_chain[rt]
            and abs(chain_pos[ra] - chain_pos[rt]) == 1
        ):
            continue  # internal chain edge
        b.add_edge_handles(map_handle(a), map_handle(t))

    # paths: keep one step per chain traversal.  Perfect-neighbor chains
    # are always traversed end-to-end, so we keep exactly the step that
    # ENTERS the chain: chain[0] when traversing the chain forward, or
    # flip(chain[-1]) when traversing it reverse.  (Comparing against the
    # previous mapped handle would wrongly collapse a path that loops from
    # a chain's end straight back into its start.)
    entry_steps = set()
    for chain in chains:
        entry_steps.add(chain[0])
        entry_steps.add(chain[-1] ^ 1)
    for p in range(g.num_paths):
        pi = b.add_path(g.path_names[p], bool(g.path_circular[p]))
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        for h in g.step_handle[lo:hi]:
            h = int(h)
            if in_chain[h >> 1] >= 0 and h not in entry_steps:
                continue  # mid-chain step of an end-to-end traversal
            b.append_step_handle(pi, map_handle(h))
    return b.build()
