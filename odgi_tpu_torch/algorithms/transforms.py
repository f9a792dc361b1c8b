"""Graph transforms of the sort command: path orders.

The counterpart of ``odgi_tpu/algorithms/transforms.py``, so far only
``prefix_and_id_ordered_paths`` (`odgi sort -L/-M/-A/-R/-D`); the other
transforms wait for ROADMAP.md queue 1 item 13.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.graph import GraphTensors, handle_rank


def prefix_and_id_ordered_paths(
    g: GraphTensors, delim: str = "", avg: bool = False, rev: bool = False
) -> np.ndarray:
    """Path permutation sorted by the min (or, with `avg`, the mean) node id
    a path visits, binned by name prefix up to `delim` in first-seen prefix
    order; `rev` reverses each bin.  The reference's 'max' variant (-M) is
    the min key reversed."""
    ids = g.node_id[handle_rank(g.step_handle)].astype(np.float64)
    prefix_order: List[str] = []
    bins = {}
    for p in range(g.num_paths):
        name = g.path_names[p]
        prefix = name.split(delim)[0] if delim else ""
        if prefix not in bins:
            bins[prefix] = []
            prefix_order.append(prefix)
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        if hi == lo:
            key = float("inf")
        elif avg:
            key = float(ids[lo:hi].mean())
        else:
            key = float(ids[lo:hi].min())
        bins[prefix].append((key, p))
    order = []
    for prefix in prefix_order:
        b = sorted(bins[prefix])
        if rev:
            b.reverse()
        order.extend(p for _, p in b)
    return np.asarray(order, dtype=np.int64)
