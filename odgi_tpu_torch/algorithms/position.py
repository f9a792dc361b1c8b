"""Position mapping: path <-> graph <-> pangenome coordinate translation.

Covers `odgi position` and `odgi panpos` (reference:
src/subcommand/position_main.cpp:29-56 and the XP index queries
src/algorithms/xp.hpp:100-131): translate path positions to graph
positions, lift positions between paths sharing nodes, and compute
pangenome (linearized) offsets.  BFS search with a bp radius finds the
nearest reference-path anchor when the queried node is not on the
reference (position_main.cpp's default 10kb search).

Host code (Python and numpy): a copy of ``odgi_tpu/algorithms/position.py``
with the same results.  It imports nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_is_reverse, handle_rank


def path_index(g: GraphTensors, name: str) -> int:
    try:
        return g.path_names.index(name)
    except ValueError:
        raise KeyError(f"path {name!r} not in graph") from None


def path_pos_to_graph(
    g: GraphTensors, p: int, pos: int
) -> Tuple[int, int, bool]:
    """(node_rank, offset_in_node, is_reverse) of path position `pos`
    (reference: XP::get_step_at_position + offset math)."""
    lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
    if hi == lo or pos < 0 or pos >= int(g.path_length[p]):
        raise IndexError(f"position {pos} outside path {g.path_names[p]}")
    s = lo + int(np.searchsorted(g.step_pos[lo:hi], pos, side="right")) - 1
    h = int(g.step_handle[s])
    off = pos - int(g.step_pos[s])
    rank, rev = h >> 1, bool(h & 1)
    if rev:
        off = int(g.node_len[rank]) - 1 - off
    return rank, off, rev


def pangenome_pos(g: GraphTensors, rank: int, offset: int = 0) -> int:
    """Linearized pangenome offset of a node position (reference:
    xp.hpp get_pangenome_pos; `odgi panpos`)."""
    return int(g.node_offset[rank]) + offset


def panpos(g: GraphTensors, path_name: str, pos: int) -> int:
    """`odgi panpos` / the HTTP server's one query
    (reference: server_main.cpp:22-60)."""
    rank, off, rev = path_pos_to_graph(g, path_index(g, path_name), pos)
    if rev:
        off = int(g.node_len[rank]) - 1 - off
    return pangenome_pos(g, rank, off)


def steps_on_node(g: GraphTensors, rank: int) -> np.ndarray:
    """Global step indices touching a node (cached per-graph CSR)."""
    key = "steps_on_node_csr"
    if key not in g._cache:
        order = np.argsort(handle_rank(g.step_handle), kind="stable")
        ranks = handle_rank(g.step_handle)[order]
        counts = np.bincount(ranks, minlength=g.num_nodes)
        offsets = np.zeros(g.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        g._cache[key] = (offsets, order)
    offsets, order = g._cache[key]
    return order[offsets[rank] : offsets[rank + 1]]


def graph_pos_to_paths(
    g: GraphTensors, rank: int, offset: int = 0
) -> List[Tuple[int, int, bool]]:
    """All (path, position, step_is_reverse) of a graph position."""
    out = []
    for s in steps_on_node(g, rank):
        h = int(g.step_handle[s])
        rev = bool(h & 1)
        off = int(g.node_len[rank]) - 1 - offset if rev else offset
        out.append((int(g.step_path[s]), int(g.step_pos[s]) + off, rev))
    return out


def lift_position(
    g: GraphTensors,
    src_path: int,
    pos: int,
    dst_paths: Sequence[int],
    search_radius_bp: int = 10000,
) -> Optional[Tuple[int, int, bool, int]]:
    """Translate a position on src_path onto the nearest position on any
    of dst_paths (reference: position_main.cpp -r/-R translation with BFS
    coordinate search, default 10 kb radius).

    Returns (dst_path, dst_pos, dst_is_rev, walked_bp) or None.
    """
    rank, off, rev = path_pos_to_graph(g, src_path, pos)
    dst_set = set(int(d) for d in dst_paths)

    def on_dst(r):
        hits = [
            (p, pp, prv)
            for (p, pp, prv) in graph_pos_to_paths(g, r, 0)
            if p in dst_set
        ]
        return hits

    # path_pos_to_graph returns `off` in node-forward coordinates; adjust
    # by the destination step's orientation.
    def dst_hit(r, node_fwd_off):
        for s in steps_on_node(g, r):
            h = int(g.step_handle[s])
            p = int(g.step_path[s])
            if p not in dst_set:
                continue
            prv = bool(h & 1)
            o = int(g.node_len[r]) - 1 - node_fwd_off if prv else node_fwd_off
            return p, int(g.step_pos[s]) + o, prv
        return None

    hit = dst_hit(rank, off)
    if hit:
        p, pp, prv = hit
        return p, pp, prv, 0
    if search_radius_bp <= 0:
        return None

    # BFS outward over node sides until a dst-path node is found
    adj = g.adjacency
    seen = {rank}
    q = deque([(rank << 1, 0), ((rank << 1) | 1, 0)])
    while q:
        h, walked = q.popleft()
        if walked > search_radius_bp:
            continue
        for nb in adj.neighbors(h):
            nb = int(nb)
            r = nb >> 1
            if r in seen:
                continue
            seen.add(r)
            hits = on_dst(r)
            if hits:
                p, pp, prv = hits[0]
                return p, pp, prv, walked
            q.append((nb, walked + int(g.node_len[r])))
            q.append((nb ^ 1, walked + int(g.node_len[r])))
    return None
