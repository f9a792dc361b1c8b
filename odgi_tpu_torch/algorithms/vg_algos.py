"""The vg helper algorithms the reference vendors under src/algorithms/,
the counterpart of ``odgi_tpu/algorithms/vg_algos.py``: distance_to_head /
distance_to_tail, find_shortest_paths (Dijkstra), sorted_id_ranges,
extend, and a_star.

Host traversals over GraphTensors through the CSR side adjacency (none is
wired into the reference's command line); handles are the packed
``rank << 1 | is_reverse`` ints used across the package.  Each returns
what ``odgi_tpu``'s returns, in the same order.

References: src/algorithms/distance_to_head.cpp:23-55,
distance_to_tail.cpp, find_shortest_paths.cpp:16-82,
sorted_id_ranges.cpp:10-38, extend.cpp:9-31, a_star.hpp:26-217.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_flip


def is_head_node(g: GraphTensors, handle: int) -> bool:
    """No edges on the left/in side of the node's forward orientation
    (reference: distance_to_head.cpp:11-21)."""
    fwd = int(handle) & ~1
    # left of forward h = right of flip(h)
    return len(g.adjacency.neighbors(int(handle_flip(fwd)))) == 0


def is_tail_node(g: GraphTensors, handle: int) -> bool:
    """No edges on the right/out side of the forward orientation
    (reference: distance_to_tail.cpp)."""
    fwd = int(handle) & ~1
    return len(g.adjacency.neighbors(fwd)) == 0


def _distance_directional(g: GraphTensors, handle: int, limit: int,
                          to_head: bool) -> int:
    """Shared DFS for distance_to_head/tail: returns the nt distance
    along the FIRST found path to a head/tail node within `limit`, or -1
    (the reference's recursive first-success semantics,
    distance_to_head.cpp:28-52)."""
    adj = g.adjacency
    seen = set()

    def pred(h: int) -> bool:
        return is_head_node(g, h) if to_head else is_tail_node(g, h)

    def nbrs(h: int) -> List[int]:
        if to_head:
            # leftward: right of flip(h), flipped back
            return [int(handle_flip(x)) for x in adj.neighbors(int(handle_flip(h)))]
        return [int(x) for x in adj.neighbors(int(h))]

    def rec(h: int, limit: int, dist: int) -> int:
        if h in seen:
            return -1
        seen.add(h)
        if limit <= 0:
            return -1
        if pred(h):
            return dist
        for nxt in nbrs(h):
            l = int(g.node_len[nxt >> 1])
            t = rec(nxt, limit - l, dist + l)
            if t != -1:
                return t
        return -1

    return rec(int(handle), int(limit), 0)


def distance_to_head(g: GraphTensors, handle: int, limit: int) -> int:
    """Nt distance from `handle` leftward to a head node, or -1 if none
    within `limit` (reference: distance_to_head.cpp:23-26)."""
    return _distance_directional(g, handle, limit, to_head=True)


def distance_to_tail(g: GraphTensors, handle: int, limit: int) -> int:
    """Nt distance from `handle` rightward to a tail node, or -1
    (reference: distance_to_tail.cpp)."""
    return _distance_directional(g, handle, limit, to_head=False)


def find_shortest_paths(g: GraphTensors, start: int,
                        traverse_leftward: bool = False) -> Dict[int, int]:
    """Dijkstra from the END of `start`: minimum nt distance to every
    reachable handle (reference: find_shortest_paths.cpp:16-82; the
    start handle itself maps to 0 and its length is not counted)."""
    adj = g.adjacency
    node_len = g.node_len

    def nbrs(h: int) -> List[int]:
        if traverse_leftward:
            return [int(handle_flip(x)) for x in adj.neighbors(int(handle_flip(h)))]
        return [int(x) for x in adj.neighbors(int(h))]

    start = int(start)
    distances: Dict[int, int] = {}
    queue: List[Tuple[int, int]] = [(0, start)]
    while queue:
        distance, current = heapq.heappop(queue)
        if current in distances:
            continue
        distances[current] = distance
        if current != start:
            distance += int(node_len[current >> 1])
        for nxt in nbrs(current):
            if nxt not in distances:
                heapq.heappush(queue, (distance, nxt))
    return distances


def sorted_id_ranges(g: GraphTensors) -> List[Tuple[int, int]]:
    """Coalesce the graph's sorted node ids into inclusive (lo, hi)
    ranges (reference: sorted_id_ranges.cpp:10-38)."""
    ids = np.sort(np.asarray(g.node_id, np.int64))
    ranges: List[Tuple[int, int]] = []
    for i in ids.tolist():
        if ranges and ranges[-1][1] + 1 == i:
            ranges[-1] = (ranges[-1][0], i)
        else:
            ranges.append((i, i))
    return ranges


def extend(source: GraphTensors, into) -> None:
    """Copy any nodes/edges of `source` missing from `into` (a mutable
    compat graph; reference: extend.cpp:9-31)."""
    for r in range(source.num_nodes):
        nid = int(source.node_id[r])
        if not into.has_node(nid):
            into.create_handle(source.node_seq_str(r), nid)
    ids = source.node_id
    for fh, th in zip(source.edge_from, source.edge_to):
        left = into.get_handle(int(ids[int(fh) >> 1]), bool(int(fh) & 1))
        right = into.get_handle(int(ids[int(th) >> 1]), bool(int(th) & 1))
        if not into.has_edge(left, right):
            into.create_edge(left, right)


# pos_t = (handle, offset-in-handle-orientation)
Pos = Tuple[int, int]


def a_star(
    g: GraphTensors,
    pos_1: Pos,
    pos_2: Pos,
    dist_heuristic: Optional[Callable[[int, int], int]] = None,
    find_min: bool = True,
    extremal_distance: Optional[int] = None,
) -> List[int]:
    """A* search for the min (or max) nt-length path of handles from
    pos_1 to pos_2 (reference: a_star.hpp:26-217, monotonic-heuristic
    min case; the max case explores under the extremal bound).

    Positions are (packed handle, offset); the traveled distance counts
    the nucleotides strictly between the two positions.  Returns the
    handle path including both endpoints' handles, or [] if there is no
    path (or none within/beyond `extremal_distance`)."""
    adj = g.adjacency
    node_len = g.node_len
    h1, off1 = int(pos_1[0]), int(pos_1[1])
    h2, off2 = int(pos_2[0]), int(pos_2[1])
    if dist_heuristic is None:
        dist_heuristic = lambda h, target: 0  # noqa: E731 (Dijkstra)
    if extremal_distance is None:
        extremal_distance = (2**62) if find_min else -(2**62)

    # same-handle special case: forward offset order
    if h1 == h2 and off1 <= off2:
        d = off2 - off1
        if (find_min and d <= extremal_distance) or (
            not find_min and d >= extremal_distance
        ):
            return [h1]

    sign = 1 if find_min else -1
    start_gap = int(node_len[h1 >> 1]) - off1  # nts left in the start handle
    # search history for traceback: (handle, predecessor index)
    history: List[Tuple[int, int]] = []
    # best known distance per handle (min case closes handles; max case
    # bounds revisits by the extremal distance)
    closed: Dict[int, int] = {}
    best: Optional[List[int]] = None

    queue: List[Tuple[int, int, int]] = []  # (priority, hist_idx placeholder)
    history.append((h1, -1))
    heapq.heappush(
        queue, (sign * (0 + dist_heuristic(h1, h2)), 0, 0)
    )  # (priority, distance, hist_idx)

    while queue:
        _, distance, idx = heapq.heappop(queue)
        h, _pred = history[idx]
        if find_min and h in closed and closed[h] <= distance:
            continue
        if find_min:
            closed[h] = distance
        if find_min and distance > extremal_distance:
            break
        if h == h2 and idx != 0:
            # distance = nts from pos_1 to the START of h2; the span
            # between the positions adds pos_2's offset
            total = distance + off2
            ok = (
                total <= extremal_distance
                if find_min
                else total >= extremal_distance
            )
            if ok:
                path = []
                j = idx
                while j != -1:
                    path.append(history[j][0])
                    j = history[j][1]
                path.reverse()
                if find_min:
                    return path
                best = path
                continue
        # expand rightward: dist(next) = dist(h) + len(h); the start
        # contributes only the nts past its offset
        new_dist = start_gap if idx == 0 else distance + int(node_len[h >> 1])
        if not find_min and new_dist > 4 * abs(extremal_distance) + 10**6:
            continue  # max-case runaway guard on cyclic graphs
        for nxt in adj.neighbors(h):
            nxt = int(nxt)
            history.append((nxt, idx))
            heapq.heappush(
                queue,
                (
                    sign * (new_dist + dist_heuristic(nxt, h2)),
                    new_dist,
                    len(history) - 1,
                ),
            )
    return best if best is not None else []
