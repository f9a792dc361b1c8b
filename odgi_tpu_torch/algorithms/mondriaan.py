"""Sparse-matrix partition sort, the counterpart of
``odgi_tpu/algorithms/mondriaan.py`` (the reference's experimental
Mondriaan sort, src/algorithms/mondriaan_sort.{hpp,cpp}, which no
subcommand reaches).

Recursive balanced bisection of the weighted node adjacency (BFS seeding
and one boundary-refinement sweep, a light Kernighan-Lin) in place of the
external Mondriaan partitioner: a node order that keeps each part
contiguous and heavy edges (weighted by path depth or id delta) inside
parts.  Host code with ``odgi_tpu``'s ``np.random.default_rng(seed)``
draws, so the order equals its own.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.graph import GraphTensors


def _edge_weights(g: GraphTensors, by_depth: bool, by_delta: bool):
    """Per-edge weights between node RANKS (symmetric, deduped)."""
    a = np.asarray(g.edge_from, np.int64) >> 1
    b = np.asarray(g.edge_to, np.int64) >> 1
    w = np.ones(len(a), np.float64)
    if by_depth and g.num_steps:
        # number of path traversals across each consecutive node pair
        sh = g.step_handle >> 1
        same_path = g.step_path[1:] == g.step_path[:-1]
        u = np.minimum(sh[:-1], sh[1:])[same_path]
        v = np.maximum(sh[:-1], sh[1:])[same_path]
        key = u * g.num_nodes + v
        uniq, cnt = np.unique(key, return_counts=True)
        ek = np.minimum(a, b) * g.num_nodes + np.maximum(a, b)
        idx = np.searchsorted(uniq, ek)
        hit = (idx < len(uniq))
        hit[hit] &= uniq[idx[hit]] == ek[hit]
        add = np.zeros(len(ek), np.float64)
        add[hit] = cnt[idx[hit]]
        w = w + add
    if by_delta:
        ids = np.asarray(g.node_id, np.int64)
        w = w / (1.0 + np.abs(ids[a] - ids[b]))
    return a, b, w


def mondriaan_sort(
    g: GraphTensors,
    n_parts: int = 2,
    eps: float = 0.03,
    weight_by_edge_depth: bool = False,
    weight_by_edge_delta: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Node order (array of ranks) grouping each of `n_parts` partitions
    contiguously; partitions balance node counts within ~eps and cut few
    heavy edges.  Mirrors the reference signature
    (mondriaan_sort.hpp:36-40) minus the external-tool plumbing."""
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, np.int64)
    a, b, w = _edge_weights(g, weight_by_edge_depth, weight_by_edge_delta)
    # symmetric CSR over ranks
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    ww = np.concatenate([w, w])
    order = np.argsort(src, kind="stable")
    src, dst, ww = src[order], dst[order], ww[order]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    rng = np.random.default_rng(seed)

    def bisect(nodes: np.ndarray, parts_left: int) -> List[np.ndarray]:
        if parts_left <= 1 or len(nodes) <= 1:
            return [nodes]
        in_set = np.zeros(n, bool)
        in_set[nodes] = True
        half = len(nodes) // 2
        # BFS-grow one side from a pseudo-peripheral seed
        side = np.zeros(n, np.int8)  # 1 = part A, 2 = part B
        seed_node = int(nodes[rng.integers(len(nodes))])
        frontier = [seed_node]
        side[seed_node] = 1
        grown = 1
        while frontier and grown < half:
            nxt = []
            for u in frontier:
                for k in range(offsets[u], offsets[u + 1]):
                    v = int(dst[k])
                    if in_set[v] and side[v] == 0:
                        side[v] = 1
                        grown += 1
                        nxt.append(v)
                        if grown >= half:
                            break
                if grown >= half:
                    break
            frontier = nxt
        # disconnected remainder fills A up to half
        for u in nodes:
            if grown >= half:
                break
            if side[u] == 0:
                side[u] = 1
                grown += 1
        for u in nodes:
            if side[u] == 0:
                side[u] = 2
        # one KL-style refinement sweep: move boundary nodes with
        # positive gain while balance permits
        balance_slack = max(1, int(eps * len(nodes)))
        size_a = grown
        for u in nodes:
            gain = 0.0
            for k in range(offsets[u], offsets[u + 1]):
                v = int(dst[k])
                if not in_set[v]:
                    continue
                gain += ww[k] if side[v] != side[u] else -ww[k]
            if gain > 0:
                if side[u] == 1 and size_a - 1 >= half - balance_slack:
                    side[u] = 2
                    size_a -= 1
                elif side[u] == 2 and size_a + 1 <= half + balance_slack:
                    side[u] = 1
                    size_a += 1
        part_a = nodes[side[nodes] == 1]
        part_b = nodes[side[nodes] == 2]
        if len(part_a) == 0 or len(part_b) == 0:
            return [nodes]
        k1 = parts_left // 2
        return bisect(part_a, parts_left - k1) + bisect(part_b, k1)

    parts = bisect(np.asarray(sorted(range(n)), np.int64), int(n_parts))
    return np.concatenate(parts)
