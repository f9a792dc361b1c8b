"""Path-Jaccard context mapping (reference: src/algorithms/path_jaccard.{hpp,cpp}).

Given a query step and candidate target steps, ranks the targets by the
Jaccard similarity of the node multisets visited within a nucleotide
walking distance around each step.  Used by `odgi tips` and
`odgi position` for picking the best reference mapping.

The reference walks step-by-step through per-node linked lists
(path_jaccard.cpp:167-221).  In our flat CSR layout a walk along a path
is a contiguous slice of the step arrays, so each "collect nodes within
distance d" is two `searchsorted` calls on the path's cumulative
positions plus one `bincount` — no pointer chasing.

Host code (Python and numpy): a copy of
``odgi_tpu/algorithms/path_jaccard.py`` with the same results.  It imports
nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import GraphTensors


def _walk_window(g: GraphTensors, step: int, dist_prev: int, dist_next: int):
    """Step-index range [a, b) covered by walking from `step` backward
    until >= dist_prev bp and forward until >= dist_next bp, mirroring
    collect_nodes_in_walking_dist (path_jaccard.cpp:167-221): a previous
    step j is included iff the distance walked before adding it
    (pos[step] - pos[j+1]) is < dist_prev, a next step k iff
    (pos[k] - pos[step+1]) < dist_next.

    Returns (a, b, walked_prev, walked_next); the window always includes
    `step` itself.
    """
    p = int(g.step_path[step])
    lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
    pos = g.step_pos
    # prev: a step j < t is included iff the distance already walked before
    # adding it, pos[t] - pos[j+1], is < dist_prev; i.e. the included set is
    # {j : pos[j+1] > pos[t] - dist_prev}.  Find the first index i in
    # [lo, t] with pos[i] > target; then a = max(lo, i-1).
    target = int(pos[step]) - dist_prev
    i = int(np.searchsorted(pos[lo : step + 1], target, side="right")) + lo
    a = max(lo, min(i - 1, step))
    walked_prev = int(pos[step] - pos[a])
    # next: a step k > t is included iff pos[k] - pos[t+1] < dist_next.
    if step + 1 < hi:
        base = int(pos[step + 1])
        b = (
            int(np.searchsorted(pos[step + 1 : hi], base + dist_next, side="left"))
            + step
            + 1
        )
        if b < hi:
            end_pos = int(pos[b])
        else:
            end_pos = int(pos[hi - 1]) + int(g.node_len[int(g.step_handle[hi - 1]) >> 1])
        walked_next = end_pos - base
    else:
        b = step + 1
        walked_next = 0
    return a, b, walked_prev, walked_next


def collect_nodes_in_walking_dist(
    g: GraphTensors, dist_prev: int, dist_next: int, step: int
) -> Dict[int, int]:
    """Node-rank -> visit-count multiset within walking distance of `step`.

    Returns {} when the path is too short to walk the full distance in
    both directions (the reference's emptiness signal,
    path_jaccard.cpp:216-219).
    """
    a, b, walked_prev, walked_next = _walk_window(g, step, dist_prev, dist_next)
    if walked_prev + walked_next < dist_prev + dist_next:
        return {}
    ranks = (g.step_handle[a:b] >> 1).astype(np.int64)
    out: Dict[int, int] = {}
    uniq, cnt = np.unique(ranks, return_counts=True)
    for r, c in zip(uniq.tolist(), cnt.tolist()):
        out[r] = c
    return out


def _jaccard(g: GraphTensors, qset: Dict[int, int], tset: Dict[int, int]) -> float:
    """Length-weighted multiset Jaccard (path_jaccard.cpp:309-347):
    intersection takes min counts, union takes max counts, each node
    weighted by its sequence length."""
    if not qset or not tset:
        return 0.0
    inter = 0
    union = 0
    keys = set(qset) | set(tset)
    for r in keys:
        qc = qset.get(r, 0)
        tc = tset.get(r, 0)
        L = int(g.node_len[r])
        inter += L * min(qc, tc)
        union += L * max(qc, tc)
    return inter / union if union else 0.0


def _min_max_walk_dist(
    g: GraphTensors, walking_dist: int, query_step: int, target_steps: List[int]
) -> Tuple[int, int]:
    """find_min_max_walk_dist_from_query_targets (path_jaccard.cpp:349-386):
    the min/max actually walkable distance over the query + all targets,
    capped at walking_dist."""
    mn, mx = walking_dist, walking_dist
    for s in [*target_steps, query_step]:
        a, b, wp, wn = _walk_window(g, s, mx, mx)
        mn = min(mn, wp, wn)
        mx = min(mx, max(wp, wn))
    return mn, mx


def jaccard_indices_from_steps(
    g: GraphTensors,
    walking_dist: int,
    query_step: int,
    target_steps: List[int],
) -> List[Tuple[int, float]]:
    """Rank `target_steps` by Jaccard context similarity to `query_step`
    (reference: jaccard_indices_from_step_handles, path_jaccard.cpp:9-165).

    Returns [(step, jaccard)] sorted best-first; ties on the best jaccard
    are broken deterministically by smallest path position
    (path_jaccard.cpp:128-163 picks the tied target with the lowest
    position).
    """
    if not target_steps:
        return []
    mn, mx = _min_max_walk_dist(g, walking_dist, query_step, target_steps)
    results: List[Tuple[int, float]] = []
    if mn >= walking_dist and mx >= walking_dist:
        qset = collect_nodes_in_walking_dist(g, walking_dist, walking_dist, query_step)
        for t in target_steps:
            tset = collect_nodes_in_walking_dist(g, walking_dist, walking_dist, t)
            results.append((t, _jaccard(g, qset, tset)))
    else:
        q_mm = collect_nodes_in_walking_dist(g, mn, mx, query_step)
        q_xm = collect_nodes_in_walking_dist(g, mx, mn, query_step)
        for t in target_steps:
            t_mm = collect_nodes_in_walking_dist(g, mn, mx, t)
            t_xm = collect_nodes_in_walking_dist(g, mx, mn, t)
            cand = [
                _jaccard(g, q_mm, t_mm),
                _jaccard(g, q_mm, t_xm),
                _jaccard(g, q_xm, t_mm),
                _jaccard(g, q_xm, t_xm),
            ]
            results.append((t, max(cand)))
    results.sort(key=lambda st: -st[1])
    # deterministic tie-break: among the best-jaccard ties, put the target
    # with the smallest path position first
    best = results[0][1]
    ties = [r for r in results if r[1] == best]
    if len(ties) > 1:
        pick = min(ties, key=lambda st: int(g.step_pos[st[0]]))
        idx = results.index(pick)
        results[0], results[idx] = results[idx], results[0]
    return results
