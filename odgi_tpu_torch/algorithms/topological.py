"""Topological ordering of a bidirected graph (host).

The modified Kahn algorithm of ``odgi_tpu/algorithms/topological.py`` with
cycle-breaking seeds and masked edges.  The ready set, the seed set and the
unvisited fallback all pop the minimum node rank first, so the order is
deterministic.  The output is a permutation of node ranks.  The order is
built in C++ (``native/src/graph_passes.cpp``), or in Python where g++ is
missing; each call counts the path it took (``gs.native`` /
``gs.python``), the nodes it takes from the seed set
(``topological_order.seeded``) and from the unvisited fallback
(``topological_order.restarts``) in ``utils.metrics.TOTALS``.
"""

from __future__ import annotations

import heapq
from typing import List, Set

import numpy as np

from .. import native
from ..core.graph import GraphTensors
from ..utils.metrics import count, span


def head_nodes(g: GraphTensors) -> np.ndarray:
    """Ranks of nodes with no edges on their left (forward) side."""
    # left edges of forward node rank r = right edges of handle (r<<1)|1
    deg = g.adjacency.degree_out()
    return np.nonzero(deg[1::2] == 0)[0]


def tail_nodes(g: GraphTensors) -> np.ndarray:
    """Ranks of nodes with no edges on their right (forward) side."""
    deg = g.adjacency.degree_out()
    return np.nonzero(deg[0::2] == 0)[0]


class _MinSet:
    """Set with O(log n) min-pop."""

    def __init__(self):
        self._heap: List[int] = []
        self._set: Set[int] = set()

    def add(self, x: int):
        if x not in self._set:
            self._set.add(x)
            heapq.heappush(self._heap, x)

    def discard(self, x: int):
        self._set.discard(x)

    def __contains__(self, x: int) -> bool:
        return x in self._set

    def __bool__(self) -> bool:
        return bool(self._set)

    def pop_min(self) -> int:
        while True:
            x = heapq.heappop(self._heap)
            if x in self._set:
                self._set.remove(x)
                return x


def _edge_key(a: int, b: int) -> tuple:
    """Canonical directed-edge key: (a, b) and (flip(b), flip(a)) are the
    same bidirected edge."""
    fa, fb = b ^ 1, a ^ 1
    return (fa, fb) if (fa, fb) < (a, b) else (a, b)


@span("sort.topological_order")
def topological_order(
    g: GraphTensors, use_heads: bool = True, use_tails: bool = False
) -> np.ndarray:
    """A topological node-rank order; `use_heads` seeds the ready set with
    the head nodes (the 's' step of the sort pipeline), else `use_tails`
    with the tail nodes."""
    n = g.num_nodes
    if use_heads:
        start = head_nodes(g)
    elif use_tails:
        start = tail_nodes(g)
    else:
        start = np.empty(0, dtype=np.int64)
    lib = native.gs_pass()
    if lib is None:
        order, seeded, restarts = _kahn(g, start)
    else:
        off, tgt = native.csr_arrays(g.adjacency, n)
        start = np.ascontiguousarray(start, dtype=np.int64)
        order = np.empty(n, dtype=np.int64)
        counts = np.zeros(2, dtype=np.int64)
        if lib.odgi_topological_order(2 * n, off.ctypes.data, len(tgt), tgt.ctypes.data,
                                      len(start), start.ctypes.data, order.ctypes.data,
                                      counts.ctypes.data) != n:
            raise ValueError("the adjacency holds a handle not below 2N or an edge "
                             "without its mirror")
        seeded, restarts = int(counts[0]), int(counts[1])
    count("topological_order.seeded", seeded)
    count("topological_order.restarts", restarts)
    return order


def _kahn(g: GraphTensors, start: np.ndarray) -> tuple:
    """(order, seeded, restarts) of the modified Kahn algorithm from the
    ready nodes `start`, in Python."""
    n = g.num_nodes
    if n == 0:
        return np.empty(0, dtype=np.int64), 0, 0
    adj = g.adjacency

    masked: Set[tuple] = set()
    sorted_out: List[int] = []

    s = _MinSet()  # oriented, ready to emit (by rank)
    seeds = _MinSet()
    unvisited = _MinSet()

    for r in start:
        s.add(int(r))
    for r in range(n):
        if r not in s:
            unvisited.add(r)

    seeded = restarts = 0
    while unvisited or s:
        # refill from seeds, then from an arbitrary unvisited node
        while not s and seeds:
            sr = seeds.pop_min()
            if sr in unvisited:
                s.add(sr)
                unvisited.discard(sr)
                seeded += 1
        if not s:
            r = unvisited.pop_min()
            s.add(r)
            restarts += 1

        while s:
            i = s.pop_min()
            h = i << 1  # forward orientation
            sorted_out.append(i)

            # Mask left-side edges into already-visited cycle entry points.
            for nb in adj.neighbors(h ^ 1):
                prev_node = int(nb) ^ 1
                if (prev_node >> 1) not in unvisited:
                    masked.add(_edge_key(prev_node, h))

            # Follow right-side edges.
            for nxt in adj.neighbors(h):
                nxt = int(nxt)
                key = _edge_key(h, nxt)
                if key in masked:
                    continue
                masked.add(key)
                nr = nxt >> 1
                if nr in unvisited:
                    # does nxt still have an unmasked incoming edge?
                    unmasked_incoming = False
                    for pb in adj.neighbors(nxt ^ 1):
                        if _edge_key(int(pb) ^ 1, nxt) not in masked:
                            unmasked_incoming = True
                            break
                    if not unmasked_incoming:
                        s.add(nr)
                        unvisited.discard(nr)
                    elif nr not in seeds:
                        seeds.add(nr)

    return np.asarray(sorted_out, dtype=np.int64), seeded, restarts
