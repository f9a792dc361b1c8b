"""Weakly-connected components over GraphTensors (host, scipy)."""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..core.graph import GraphTensors, handle_rank


def weak_component_ids(g: GraphTensors) -> np.ndarray:
    """i32[N]: weakly-connected component index per node rank, renumbered
    so that components are ordered by their mean external node id."""
    n = g.num_nodes
    if n == 0:
        return np.empty(0, dtype=np.int32)
    src = handle_rank(g.edge_from)
    dst = handle_rank(g.edge_to)
    data = np.ones(len(src), dtype=np.int8)
    adj = coo_matrix((data, (src, dst)), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    sums = np.bincount(labels, weights=g.node_id.astype(np.float64), minlength=ncomp)
    counts = np.bincount(labels, minlength=ncomp)
    avg = sums / np.maximum(counts, 1)
    order = np.argsort(avg, kind="stable")
    remap = np.empty(ncomp, dtype=np.int32)
    remap[order] = np.arange(ncomp, dtype=np.int32)
    return remap[labels]


def weak_components(g: GraphTensors) -> List[np.ndarray]:
    """List of node-rank arrays, one per weak component (ordered)."""
    labels = weak_component_ids(g)
    ncomp = int(labels.max()) + 1 if len(labels) else 0
    return [np.nonzero(labels == c)[0] for c in range(ncomp)]


def num_self_loops(g: GraphTensors) -> int:
    """Number of edges whose two ends are the same node."""
    return int(np.sum(handle_rank(g.edge_from) == handle_rank(g.edge_to)))
