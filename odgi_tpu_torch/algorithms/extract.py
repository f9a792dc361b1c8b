"""Extract: subgraphs by node set, path range, or BED intervals.

Covers `odgi extract` (reference: src/subcommand/extract_main.cpp, the
subgraph kit src/algorithms/extract_*.cpp and expand_context.{hpp,cpp}):
select nodes by path ranges or explicit ids, optionally expand context by
steps or bp, then materialize the induced subgraph with path fragments
renamed `name:start-end`.

Host code (Python and numpy): a copy of ``odgi_tpu/algorithms/extract.py``
with the same results.  It imports nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_rank
from .transforms import drop_nodes


def expand_context(
    g: GraphTensors,
    node_mask: np.ndarray,
    steps: int = 0,
    bp: int = 0,
) -> np.ndarray:
    """Grow a node selection by BFS over `steps` hops or `bp` walked bases
    (reference: expand_context.cpp)."""
    mask = np.asarray(node_mask, dtype=bool).copy()
    if steps <= 0 and bp <= 0:
        return mask
    adj = g.adjacency
    frontier = deque(
        (int(r) << 1 | o, 0, 0)
        for r in np.nonzero(mask)[0]
        for o in (0, 1)
    )
    while frontier:
        h, d_steps, d_bp = frontier.popleft()
        if (steps and d_steps >= steps) or (bp and d_bp >= bp):
            continue
        for nb in adj.neighbors(h):
            nb = int(nb)
            r = nb >> 1
            nd_bp = d_bp + int(g.node_len[r])
            if not mask[r]:
                mask[r] = True
                frontier.append((nb, d_steps + 1, nd_bp))
                frontier.append((nb ^ 1, d_steps + 1, nd_bp))
    return mask


def extract_nodes(
    g: GraphTensors,
    node_ranks: Sequence[int],
    context_steps: int = 0,
    context_bp: int = 0,
) -> GraphTensors:
    """Induced subgraph of the given nodes (+context)."""
    mask = np.zeros(g.num_nodes, dtype=bool)
    mask[np.asarray(list(node_ranks), dtype=np.int64)] = True
    mask = expand_context(g, mask, context_steps, context_bp)
    return drop_nodes(g, ~mask)


def nodes_in_path_range(
    g: GraphTensors, p: int, start: int, end: int
) -> np.ndarray:
    """Ranks of nodes the path touches within [start, end) bp."""
    lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
    pos = g.step_pos[lo:hi]
    ranks = handle_rank(g.step_handle[lo:hi])
    lens = g.node_len[ranks]
    sel = (pos + lens > start) & (pos < end)
    return np.unique(ranks[sel])


def extract_path_range(
    g: GraphTensors,
    path_name: str,
    start: int,
    end: int,
    full_range: bool = False,
    context_steps: int = 0,
    context_bp: int = 0,
) -> GraphTensors:
    """`odgi extract -r path:start-end` (+ -E full range lacing: with
    `full_range`, include ALL nodes between the outermost pangenome
    positions touched, reference: extract_main.cpp -E)."""
    from .position import path_index

    p = path_index(g, path_name)
    ranks = nodes_in_path_range(g, p, start, end)
    if len(ranks) == 0:
        raise ValueError(f"range {start}-{end} selects no nodes")
    if full_range:
        lo_r, hi_r = int(ranks.min()), int(ranks.max())
        ranks = np.arange(lo_r, hi_r + 1)
    return extract_nodes(g, ranks, context_steps, context_bp)


def extract_bed(
    g: GraphTensors,
    bed_rows: Sequence[Tuple[str, int, int]],
    **kwargs,
) -> GraphTensors:
    """Union of extract_path_range over BED rows."""
    from .position import path_index

    mask = np.zeros(g.num_nodes, dtype=bool)
    for name, start, end in bed_rows:
        p = path_index(g, name)
        mask[nodes_in_path_range(g, p, start, end)] = True
    mask = expand_context(
        g, mask, kwargs.get("context_steps", 0), kwargs.get("context_bp", 0)
    )
    return drop_nodes(g, ~mask)


def read_bed(path: str) -> List[Tuple[str, int, int]]:
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith(("#", "track", "browser")) or not line.strip():
                continue
            parts = line.split("\t")
            rows.append((parts[0], int(parts[1]), int(parts[2])))
    return rows
