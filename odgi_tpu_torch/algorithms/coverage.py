"""Node depth (host, numpy): the counterpart of
``odgi_tpu/algorithms/coverage.py`` (``odgi depth``, and ``unchop``'s
depth test).  Bincounts over the flat step table."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_rank


def node_depth(
    g: GraphTensors, paths: Optional[Sequence[int]] = None
) -> np.ndarray:
    """i64[N]: number of path steps on each node (reference: depth.cpp
    get_depth_count; `odgi depth -d`)."""
    steps = g.step_handle
    if paths is not None:
        mask = np.isin(g.step_path, np.asarray(list(paths)))
        steps = steps[mask]
    return np.bincount(handle_rank(steps), minlength=g.num_nodes).astype(np.int64)


def node_depth_unique(
    g: GraphTensors, paths: Optional[Sequence[int]] = None
) -> np.ndarray:
    """i64[N]: number of distinct paths touching each node
    (reference: depth.cpp unique-path depth)."""
    ranks = handle_rank(g.step_handle)
    sp = g.step_path
    if paths is not None:
        mask = np.isin(sp, np.asarray(list(paths)))
        ranks, sp = ranks[mask], sp[mask]
    pairs = np.unique(np.stack([ranks, sp.astype(np.int64)], axis=1), axis=0)
    return np.bincount(pairs[:, 0], minlength=g.num_nodes).astype(np.int64)


def node_degree(g: GraphTensors) -> Tuple[np.ndarray, np.ndarray]:
    """(in_degree, out_degree) per node rank in forward orientation
    (reference: degree.cpp; in = edges on the node's left side, out = on
    the right side)."""
    deg = g.adjacency.degree_out()  # per packed handle
    out_deg = deg[0::2]
    in_deg = deg[1::2]
    return in_deg.astype(np.int64), out_deg.astype(np.int64)


def depth_histogram(depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(depth values, node counts) summary."""
    vals, counts = np.unique(depth, return_counts=True)
    return vals, counts


def path_windows_bed(
    g: GraphTensors,
    per_node_value: np.ndarray,
    window_bp: int,
    paths: Optional[Sequence[int]] = None,
):
    """Windowed mean of a per-node value over each path, BED rows
    (reference: depth.hpp:28-41 windowed depth; same scheme for degree).

    Yields (path_name, start, end, mean_value) with node values weighted
    by the portion of the node inside the window (approximated at node
    granularity: each step contributes len(node) at its position).
    """
    sel = range(g.num_paths) if paths is None else paths
    for p in sel:
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        if hi == lo:
            continue
        ranks = handle_rank(g.step_handle[lo:hi])
        lens = g.node_len[ranks].astype(np.int64)
        starts = g.step_pos[lo:hi]
        vals = per_node_value[ranks].astype(np.float64)
        total = int(starts[-1] + lens[-1])
        edges = np.arange(0, total + window_bp, window_bp)
        idx = np.searchsorted(edges, starts, side="right") - 1
        wsum = np.bincount(idx, weights=vals * lens, minlength=len(edges) - 1)
        wlen = np.bincount(idx, weights=lens.astype(np.float64), minlength=len(edges) - 1)
        for w in range(len(edges) - 1):
            if wlen[w] > 0:
                yield (
                    g.path_names[p],
                    int(edges[w]),
                    int(min(edges[w + 1], total)),
                    wsum[w] / wlen[w],
                )


def path_range_mean_depth(g: GraphTensors, path_ranges, depth_per_node: np.ndarray):
    """Mean depth over each (path, start, end) range, base-exact
    (reference: src/algorithms/depth.cpp:100-215 for_each_path_range_depth):
    per range, the sum over covered bases of the covering node's depth,
    with partial nodes weighted by overlap, divided by the range length.
    Yields (range, mean_depth) in input order."""
    # group ranges per path; prefix-sum depth*len per path once
    by_path = {}
    for i, r in enumerate(path_ranges):
        by_path.setdefault(r.path, []).append((i, r))
    out = [None] * len(path_ranges)
    for p, items in by_path.items():
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        ranks = handle_rank(g.step_handle[lo:hi])
        lens = g.node_len[ranks].astype(np.int64)
        offs = g.step_pos[lo:hi].astype(np.int64)
        d = depth_per_node[ranks].astype(np.float64)
        prefix = np.zeros(len(d) + 1, dtype=np.float64)
        np.cumsum(d * lens, out=prefix[1:])
        total_len = int(offs[-1] + lens[-1]) if len(d) else 0

        def F(x: int) -> float:
            if x <= 0 or len(d) == 0:
                return 0.0
            if x >= total_len:
                return float(prefix[-1])
            k = int(np.searchsorted(offs, x, side="right")) - 1
            return float(prefix[k] + d[k] * (x - int(offs[k])))

        for i, r in items:
            span = max(r.end - r.start, 1)
            out[i] = (r, (F(r.end) - F(r.start)) / span)
    for item in out:
        if item is not None:
            yield item
