"""The secondary sort orders of the ``sort`` pipeline: codes b, z, w, c, d.

Host graph traversals, a copy of ``odgi_tpu/algorithms/sorts_extra.py``:
breadth- and depth-first orders from the head nodes, the two-way
topological order, the cycle-breaking DFS order and the dagify order.  Each
returns a permutation of the node ranks, equal to ``odgi_tpu``'s.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from ..core.graph import GraphTensors
from .topological import head_nodes, topological_order


def _seeds(g: GraphTensors) -> List[int]:
    heads = list(head_nodes(g))
    if heads:
        return [int(h) for h in heads]
    return list(range(g.num_nodes))


def breadth_first_topological_order(g: GraphTensors, chunk: int = 0) -> np.ndarray:
    """BFS order from head nodes (reference:
    topological_sort.hpp breadth_first_topological_order; 'b' code).
    `chunk` bounds the frontier the reference processes per round — the
    visit order here is plain FIFO, which is the chunk=inf behavior."""
    adj = g.adjacency
    n = g.num_nodes
    seen = np.zeros(n, dtype=bool)
    out: List[int] = []
    q = deque()
    for r in _seeds(g):
        if not seen[r]:
            seen[r] = True
            q.append(r)
        while q:
            cur = q.popleft()
            out.append(cur)
            for side in (cur << 1, (cur << 1) | 1):
                for nb in adj.neighbors(side):
                    nr = int(nb) >> 1
                    if not seen[nr]:
                        seen[nr] = True
                        q.append(nr)
    for r in range(n):
        if not seen[r]:
            out.append(r)
    return np.asarray(out, dtype=np.int64)


def depth_first_topological_order(g: GraphTensors, chunk: int = 0) -> np.ndarray:
    """DFS order from head nodes (reference: 'z' code)."""
    adj = g.adjacency
    n = g.num_nodes
    seen = np.zeros(n, dtype=bool)
    out: List[int] = []
    for r in _seeds(g):
        if seen[r]:
            continue
        stack = [r]
        while stack:
            cur = stack.pop()
            if seen[cur]:
                continue
            seen[cur] = True
            out.append(cur)
            nbs = []
            for side in (cur << 1, (cur << 1) | 1):
                for nb in adj.neighbors(side):
                    nr = int(nb) >> 1
                    if not seen[nr]:
                        nbs.append(nr)
            stack.extend(reversed(nbs))
    for r in range(n):
        if not seen[r]:
            out.append(r)
    return np.asarray(out, dtype=np.int64)


def two_way_topological_order(g: GraphTensors) -> np.ndarray:
    """Two-way topological order (reference: 'w' code /
    two_way_topological_order): average of the head-seeded order and the
    reversed tail-seeded order of the flipped graph — approximated by
    ranking nodes by the mean of forward and reverse topological ranks."""
    fwd = topological_order(g, use_heads=True)
    rev = topological_order(g, use_heads=False)[::-1]
    rank = np.empty(g.num_nodes, dtype=np.float64)
    rank[fwd] = np.arange(g.num_nodes)
    rank2 = np.empty(g.num_nodes, dtype=np.float64)
    rank2[rev] = np.arange(g.num_nodes)
    return np.argsort((rank + rank2) / 2.0, kind="stable").astype(np.int64)


def cycle_breaking_order(g: GraphTensors) -> np.ndarray:
    """DFS-based cycle-breaking sort (reference: cycle_breaking_sort.cpp
    :9-32): run the reference's handle-DFS (dfs.cpp:10-175) from every
    forward handle in rank order; at each handle EXIT record
    (tree_edge_count, postorder_index, node); ascending sort of those
    triples is the order.  Back edges never advance the tree-edge counter,
    which is what breaks cycles."""
    adj = g.adjacency
    N = g.num_nodes
    PRE, CURR, POST = 0, 1, 2
    state = {}
    rank = [None] * N
    i = 0
    j = 0
    for root_rank in range(N):
        root = root_rank << 1
        if state.get(root, PRE) != PRE:
            continue
        state[root] = CURR
        stack = [(root, [int(t) for t in adj.neighbors(root)], 0)]
        while stack:
            h, targets, idx = stack.pop()
            advanced = False
            while idx < len(targets):
                t = targets[idx]
                idx += 1
                if state.get(t, PRE) == PRE:
                    j += 1  # tree edge (tree_fn: ++j)
                    stack.append((h, targets, idx))
                    state[t] = CURR
                    stack.append((t, [int(x) for x in adj.neighbors(t)], 0))
                    advanced = True
                    break
            if not advanced:
                state[h] = POST
                rank[h >> 1] = (j, i, h >> 1)
                i += 1
    order = np.array([r[2] for r in sorted(rank)], dtype=np.int64)
    return order


def dagify_sort_order(g: GraphTensors) -> np.ndarray:
    """Dagify-based sort (reference: dagify_sort.cpp:6-40, 'd' code):
    split strands, unroll cycles into a DAG by SCC duplication
    (dagify.cpp:12-260), topologically sort the DAG, and order original
    nodes by their mean position over forward copies."""
    from .graph_misc import dagify_sort_order_exact

    return dagify_sort_order_exact(g)

