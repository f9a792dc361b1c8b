"""Reference-semantics position translation machinery for `odgi position`.

Host-side pointer-chasing (BFS coordinate search, path-jaccard context
ranking) over the flat step tensor — kept off-device by design (SURVEY §7:
graph-local search is not kernel work).  Faithful reimplementation of:

- the bounded breadth-first search (reference: src/algorithms/bfs.cpp:10-70
  — despite the name it pops from the back of its deque, so traversal is
  depth-first in follow_edges order; we reproduce that order exactly),
- get_position / get_immediate / adj_last_node offset bookkeeping
  (reference: src/subcommand/position_main.cpp:545-733),
- path-jaccard candidate ranking with walk-distance truncation and the
  median-of-ties deterministic selection (reference:
  src/algorithms/path_jaccard.cpp:8-386).

Host code (Python and numpy): a copy of ``odgi_tpu/algorithms/liftover.py``
with the same results.  It imports nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_flip, handle_rank


class PositionContext:
    """Per-graph lookup structures for reference-parity position queries."""

    def __init__(self, g: GraphTensors):
        self.g = g
        # per-packed-handle neighbor lists in edge-insertion order
        # (reference: node_t edge records are appended at create_edge time,
        # so follow_edges enumerates in insertion order)
        n2 = 2 * g.num_nodes
        adj: List[List[int]] = [[] for _ in range(n2)]
        for a, b in zip(g.edge_from.tolist(), g.edge_to.tolist()):
            adj[a].append(b)
            fb, fa = b ^ 1, a ^ 1
            if not (fb == a and fa == b):  # self-inverse edge stored once
                adj[fb].append(fa)
        self.adj = adj
        # steps on each node, ascending global step index (= node-local
        # insertion order when paths are appended in file order)
        order = np.argsort(handle_rank(g.step_handle), kind="stable")
        ranks = handle_rank(g.step_handle)[order]
        counts = np.bincount(ranks, minlength=g.num_nodes)
        offs = np.zeros(g.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        self._steps_sorted = order
        self._steps_offs = offs

    def steps_on_node(self, rank: int) -> np.ndarray:
        return self._steps_sorted[self._steps_offs[rank] : self._steps_offs[rank + 1]]

    def follow_edges(self, handle: int, go_left: bool) -> List[int]:
        if go_left:
            return [t ^ 1 for t in self.adj[handle ^ 1]]
        return list(self.adj[handle])

    # -- step helpers -------------------------------------------------------

    def has_prev(self, s: int) -> bool:
        return s - 1 >= int(self.g.path_offset[self.g.step_path[s]])

    def has_next(self, s: int) -> bool:
        return s + 1 < int(self.g.path_offset[self.g.step_path[s] + 1])

    def step_len(self, s: int) -> int:
        return int(self.g.node_len[int(self.g.step_handle[s]) >> 1])


@dataclass
class LiftResult:
    path_offset: int = 0
    ref_hit: int = -1  # global step index
    walked_to_hit_ref: int = 0
    is_rev_vs_ref: bool = False
    used_bidirectional: bool = False


def bfs(
    ctx: PositionContext,
    handle_fn,  # (handle, root, length, depth) -> None
    seen_handle_fn,  # handle -> bool
    break_fn,  # () -> bool
    sources: Sequence[int],
    bidirectional: bool,
    bp_limit: int,
) -> None:
    """Deque traversal identical to reference bfs.cpp:10-70 (push_back /
    pop_back; sources seeded via push_front)."""
    todo: List[Tuple[int, int, int, int]] = []
    for rank, h in enumerate(sources):
        todo.insert(0, (h, rank, 0, 0))
    while todo:
        handle, root, length, depth = todo.pop()
        if seen_handle_fn(handle):
            continue
        handle_fn(handle, root, length, depth)
        length += int(ctx.g.node_len[handle >> 1])
        depth += 1
        if break_fn():
            return
        if not bp_limit or length < bp_limit:
            for nxt in ctx.follow_edges(handle, False):
                todo.append((nxt, root, length, depth))
            if bidirectional:
                for nxt in ctx.follow_edges(handle, True):
                    todo.append((nxt, root, length, depth))


def get_graph_pos(
    ctx: PositionContext, path: int, offset: int, tag: str = "position"
) -> Tuple[Tuple[int, bool, int], int]:
    """Path offset -> ((node_id, is_rev, node_offset), step) with the
    reference's inclusive-end rule (position_main.cpp:486-505:
    walked + len - 1 >= offset).  Returns node_id 0 when out of range."""
    import sys

    g = ctx.g
    lo, hi = int(g.path_offset[path]), int(g.path_offset[path + 1])
    offs = g.step_pos[lo:hi]
    k = int(np.searchsorted(offs, offset, side="right")) - 1
    if k >= 0 and lo + k < hi:
        s = lo + k
        h = int(g.step_handle[s])
        if offset <= int(offs[k]) + int(g.node_len[h >> 1]) - 1:
            return (int(g.node_id[h >> 1]), bool(h & 1), offset - int(offs[k])), s
    walked = int(g.path_length[path])
    print(
        f"[odgi::{tag}] warning: position {g.path_names[path]}:{offset} "
        f"outside of path. Walked {walked}",
        file=__import__("sys").stderr,
    )
    return (0, False, 0), -1


def _set_adj_last_node(
    ctx: PositionContext,
    ref_hit: int,
    h_bfs: int,
    used_bidirectional: bool,
    d_bfs: int,
    pos: Tuple[int, bool, int],
) -> Tuple[bool, int]:
    """(rev_vs_ref, adj_last_node) — position_main.cpp:552-585."""
    g = ctx.g
    hit_handle = int(g.step_handle[ref_hit])
    rev_vs_ref = bool(hit_handle & 1) == bool(h_bfs & 1)
    node_len = int(g.node_len[h_bfs >> 1])
    if d_bfs == 0 or (d_bfs == node_len and used_bidirectional):
        adj = (node_len - pos[2]) if rev_vs_ref else pos[2]
    else:
        adj = 0 if rev_vs_ref else node_len
    return rev_vs_ref, adj


def get_immediate(
    ctx: PositionContext,
    path_set: Set[int],
    pos: Tuple[int, bool, int],
) -> List[LiftResult]:
    """All ref-path steps directly on the queried node
    (position_main.cpp:600-633)."""
    g = ctx.g
    rank = g.id_to_rank[pos[0]]
    h = (rank << 1) | int(pos[1])
    out: List[LiftResult] = []
    for s in ctx.steps_on_node(rank):
        s = int(s)
        p = int(g.step_path[s])
        if p not in path_set:
            continue
        hit_handle = int(g.step_handle[s])
        rev_vs_ref = bool(hit_handle & 1) != bool(h & 1)
        adj = (int(g.node_len[rank]) - pos[2]) if rev_vs_ref else pos[2]
        out.append(
            LiftResult(
                path_offset=int(g.step_pos[s]) + adj,
                ref_hit=s,
                walked_to_hit_ref=0,
                is_rev_vs_ref=rev_vs_ref,
            )
        )
    return out


def get_position(
    ctx: PositionContext,
    path_set: Set[int],
    pos: Tuple[int, bool, int],  # (node_id, is_rev, offset)
    target_step: int,
    path_jaccard: bool,
    search_radius: int,
    walking_dist: int,
    lift: LiftResult,
) -> bool:
    """BFS search for the nearest ref-path anchor
    (position_main.cpp:635-733)."""
    g = ctx.g
    rank = g.id_to_rank[pos[0]]
    start_handle = (rank << 1) | int(pos[1])
    seen: Set[int] = set()
    found: List = []  # [ref_hit, h_bfs, d_bfs]

    def handle_fn(h, r, l, d):
        seen.add(h)
        for s in ctx.steps_on_node(h >> 1):
            s = int(s)
            if int(g.step_path[s]) in path_set:
                lift.walked_to_hit_ref += l
                found.append([s, h, d])
                return

    for try_bidirectional in (False, True):
        if try_bidirectional:
            lift.used_bidirectional = True
            seen.discard(start_handle ^ 1)
        bfs(
            ctx,
            handle_fn,
            lambda h: h in seen,
            lambda: bool(found),
            [start_handle ^ 1],
            try_bidirectional,
            search_radius,
        )
        if found:
            break
    if not found:
        lift.path_offset = -1
        return False
    ref_hit, h_bfs, d_bfs = found[0]
    rev_vs_ref, adj = _set_adj_last_node(
        ctx, ref_hit, h_bfs, lift.used_bidirectional, d_bfs, pos
    )
    if path_jaccard:
        ref_path = int(g.step_path[ref_hit])
        candidates = [
            int(s)
            for s in ctx.steps_on_node(h_bfs >> 1)
            if int(g.step_path[int(s)]) == ref_path
        ]
        ranked = jaccard_indices_from_steps(ctx, walking_dist, target_step, candidates)
        ref_hit = ranked[0][0]
        rev_vs_ref, adj = _set_adj_last_node(
            ctx, ref_hit, h_bfs, lift.used_bidirectional, d_bfs, pos
        )
    lift.ref_hit = ref_hit
    lift.is_rev_vs_ref = rev_vs_ref
    lift.path_offset = int(g.step_pos[ref_hit]) + adj
    return True


# ---------------------------------------------------------------------------
# Path jaccard (path_jaccard.cpp)
# ---------------------------------------------------------------------------


def collect_nodes_in_walking_dist(
    ctx: PositionContext, dist_prev: int, dist_next: int, start_step: int
) -> Dict[int, int]:
    """Multiset of node ids within the walk window, empty if the path is
    too short to cover both distances (path_jaccard.cpp:172-220)."""
    g = ctx.g
    counts: Dict[int, int] = {}
    cur_id = int(g.node_id[int(g.step_handle[start_step]) >> 1])
    total = 0
    walked = 0
    s = start_step
    while ctx.has_prev(s) and walked < dist_prev:
        s -= 1
        nid = int(g.node_id[int(g.step_handle[s]) >> 1])
        counts[nid] = counts.get(nid, 0) + 1
        walked += ctx.step_len(s)
    total += walked
    walked = 0
    s = start_step
    while ctx.has_next(s) and walked < dist_next:
        s += 1
        nid = int(g.node_id[int(g.step_handle[s]) >> 1])
        counts[nid] = counts.get(nid, 0) + 1
        walked += ctx.step_len(s)
    total += walked
    counts[cur_id] = counts.get(cur_id, 0) + 1
    if total < dist_prev + dist_next:
        return {}
    return counts


def _jaccard(ctx: PositionContext, query: Dict[int, int], target: Dict[int, int]) -> float:
    g = ctx.g
    union = dict(query)
    for nid, c in target.items():
        union[nid] = max(c, union.get(nid, 0))
    inter_len = 0
    union_len = 0
    for nid, c in union.items():
        ln = int(g.node_len[g.id_to_rank[nid]])
        union_len += ln * c
        if nid in target and nid in query:
            inter_len += ln * min(target[nid], query[nid])
    return inter_len / union_len if union_len else 0.0


def _find_min_max_walk_dist(
    ctx: PositionContext, walking_dist: int, cur_step: int, targets: Sequence[int]
) -> Tuple[int, int]:
    """path_jaccard.cpp:349-385 — note the truncation limit shrinks as
    steps are processed (order-dependent, reproduced exactly)."""
    mn, mx = walking_dist, walking_dist
    for start in list(targets) + [cur_step]:
        walked_prev = 0
        s = start
        while ctx.has_prev(s) and walked_prev < mx:
            s -= 1
            walked_prev += ctx.step_len(s)
        walked_next = 0
        s = start
        while ctx.has_next(s) and walked_next < mx:
            s += 1
            walked_next += ctx.step_len(s)
        mn = min(min(walked_prev, walked_next), mn)
        mx = min(max(walked_prev, walked_next), mx)
    return mn, mx


def jaccard_indices_from_steps(
    ctx: PositionContext,
    walking_dist: int,
    cur_step: int,
    targets: Sequence[int],
) -> List[Tuple[int, float]]:
    """Ranked (step, jaccard) list, best first, with the reference's
    median-of-ties deterministic pick swapped to front
    (path_jaccard.cpp:8-170)."""
    mn, mx = _find_min_max_walk_dist(ctx, walking_dist, cur_step, targets)
    indices: List[Tuple[int, float]] = []
    if mn >= walking_dist and mx >= walking_dist:
        query_set = collect_nodes_in_walking_dist(ctx, walking_dist, walking_dist, cur_step)
        for t in targets:
            target_set = collect_nodes_in_walking_dist(ctx, walking_dist, walking_dist, t)
            indices.append((t, _jaccard(ctx, query_set, target_set)))
    else:
        q_mn_mx = collect_nodes_in_walking_dist(ctx, mn, mx, cur_step)
        q_mx_mn = collect_nodes_in_walking_dist(ctx, mx, mn, cur_step)
        for t in targets:
            t_mn_mx = collect_nodes_in_walking_dist(ctx, mn, mx, t)
            t_mx_mn = collect_nodes_in_walking_dist(ctx, mx, mn, t)
            cands = [0.0, 0.0, 0.0, 0.0]
            if q_mn_mx:
                if t_mn_mx:
                    cands[0] = _jaccard(ctx, q_mn_mx, t_mn_mx)
                if t_mx_mn:
                    cands[1] = _jaccard(ctx, q_mn_mx, t_mx_mn)
            if q_mx_mn:
                if t_mn_mx:
                    cands[2] = _jaccard(ctx, q_mx_mn, t_mn_mx)
                if t_mx_mn:
                    cands[3] = _jaccard(ctx, q_mx_mn, t_mx_mn)
            indices.append((t, max(cands)))
    # stable sort by jaccard desc (std::sort on equal keys — candidate
    # order is node-local step order, which Python's stable sort keeps)
    indices.sort(key=lambda x: -x[1])
    if not indices:
        return indices
    best_j = indices[0][1]
    ties = sorted([sj for sj in indices if sj[1] == best_j], key=lambda x: x[0])
    final = ties[len(ties) // 2]
    pos = indices.index(final)
    indices[0], indices[pos] = indices[pos], indices[0]
    return indices
