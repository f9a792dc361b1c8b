"""Node degree (host, numpy): the counterpart of
``odgi_tpu/algorithms/degree.py`` (``odgi degree``, and the depth and
degree windows): prefix sums over the flat step table."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_rank


def node_degree_sides(g: GraphTensors) -> Tuple[np.ndarray, np.ndarray]:
    """(in_degree, out_degree) per node rank: edge count on the node's left
    and right side (reference: graph.get_degree(h, true/false))."""
    deg = g.adjacency.degree_out()
    return deg[1::2].astype(np.int64), deg[0::2].astype(np.int64)


def node_total_degree(g: GraphTensors) -> np.ndarray:
    i, o = node_degree_sides(g)
    return i + o


def considered_node_mask(g: GraphTensors, paths_mask: np.ndarray) -> np.ndarray:
    """bool[N]: nodes with at least one step of a considered path
    (reference: degree.cpp:41-57 'consider')."""
    sel = paths_mask[g.step_path]
    return (
        np.bincount(
            handle_rank(g.step_handle[sel]), minlength=g.num_nodes
        )
        > 0
    )


def effective_degree(g: GraphTensors, paths_mask: np.ndarray) -> np.ndarray:
    """Per-node degree, zeroed on nodes untouched by considered paths."""
    return np.where(considered_node_mask(g, paths_mask), node_total_degree(g), 0)


def path_range_means(
    g: GraphTensors,
    per_node_value: np.ndarray,
    ranges: Sequence,  # of cli.region.PathRange
) -> List[float]:
    """Length-weighted mean of a per-node value over each path range
    (reference: degree.cpp for_each_path_range_degree — Σ value·overlap /
    (end-start), where overlap is the node/range intersection).

    Ranges whose [start, end) extends past the path end contribute only
    the covered part but still divide by (end-start), exactly like the
    reference.
    """
    out = []
    for r in ranges:
        lo, hi = int(g.path_offset[r.path]), int(g.path_offset[r.path + 1])
        offs = g.step_pos[lo:hi].astype(np.int64)
        ranks = handle_rank(g.step_handle[lo:hi])
        lens = g.node_len[ranks].astype(np.int64)
        ends = offs + lens
        vals = per_node_value[ranks].astype(np.float64)
        cum = np.concatenate([[0.0], np.cumsum(vals * lens)])
        s, e = r.start, r.end
        k0 = int(np.searchsorted(ends, s, side="right"))
        k1 = int(np.searchsorted(offs, e, side="left"))
        if k1 <= k0:
            out.append(0.0)
            continue
        total = cum[k1] - cum[k0]
        # trim partial overlap at both ends
        if s > offs[k0]:
            total -= vals[k0] * (s - offs[k0])
        if e < ends[k1 - 1]:
            total -= vals[k1 - 1] * (ends[k1 - 1] - e)
        out.append(total / (e - s))
    return out


def windows_in_out(
    g: GraphTensors,
    paths: Iterable[int],
    node_in_bounds: np.ndarray,  # bool[N]
    merge_len: int,
):
    """Yield (path, start, end) BED intervals of in-bounds runs along each
    path, merging runs whose start is < merge_len past the previous end
    (reference: extract.cpp:407-469 windows_in_out)."""
    for p in paths:
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        if hi == lo:
            continue
        ranks = handle_rank(g.step_handle[lo:hi])
        offs = g.step_pos[lo:hi].astype(np.int64)
        lens = g.node_len[ranks].astype(np.int64)
        mask = node_in_bounds[ranks]
        if not mask.any():
            continue
        # run boundaries over the step mask
        m = mask.astype(np.int8)
        starts = np.flatnonzero(np.diff(np.concatenate([[0], m])) == 1)
        stops = np.flatnonzero(np.diff(np.concatenate([m, [0]])) == -1)
        merged: List[List[int]] = []
        for a, b in zip(starts, stops):
            s, e = int(offs[a]), int(offs[b] + lens[b])
            if merged and (s - merged[-1][1]) < merge_len:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        for s, e in merged:
            yield p, s, e


def node_unique_path_count(g: GraphTensors, paths_mask: np.ndarray) -> np.ndarray:
    """i64[N]: number of distinct considered paths with a step on each node
    (reference: degree_main.cpp get_graph_node_degree unique_paths)."""
    sel = paths_mask[g.step_path]
    ranks = handle_rank(g.step_handle[sel])
    sp = g.step_path[sel].astype(np.int64)
    if len(ranks) == 0:
        return np.zeros(g.num_nodes, dtype=np.int64)
    pairs = np.unique(ranks.astype(np.int64) * g.num_paths + sp)
    return np.bincount(
        (pairs // g.num_paths).astype(np.int64), minlength=g.num_nodes
    ).astype(np.int64)


def node_self_step_count(g: GraphTensors) -> np.ndarray:
    """i64[S]: for each step, the number of steps of the SAME path on that
    step's node (reference: degree_main.cpp self_degree inner loop)."""
    ranks = handle_rank(g.step_handle).astype(np.int64)
    keys = ranks * g.num_paths + g.step_path.astype(np.int64)
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    return counts[inv]
