"""Graph transforms (host): flip, the prune family, explode, squeeze, and
the path orders of sort; the counterpart of
``odgi_tpu/algorithms/transforms.py``.

`drop_nodes` rebuilds the graph without the masked nodes and splits each
path around them into fragments named ``name:start-end``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.graph import GraphBuilder, GraphTensors, handle_is_reverse, handle_rank
from .components import weak_component_ids


def flip_paths(g: GraphTensors, min_flip_fraction: float = 0.5) -> GraphTensors:
    """Flip paths that travel mostly in reverse (reference: flip.cpp:
    a path flips when the bp on reverse-oriented steps exceed forward bp;
    flipped paths reverse their step order and orientations)."""
    new_steps = g.step_handle.copy()
    new_pos = g.step_pos.copy()
    for p in range(g.num_paths):
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        hs = g.step_handle[lo:hi]
        if len(hs) == 0:
            continue
        lens = g.node_len[handle_rank(hs)].astype(np.int64)
        rev_bp = int(lens[handle_is_reverse(hs)].sum())
        if rev_bp * 2 > int(lens.sum()):
            flipped = (hs[::-1] ^ 1).astype(np.int64)
            new_steps[lo:hi] = flipped
            fl = g.node_len[handle_rank(flipped)]
            cum = np.cumsum(fl) - fl
            new_pos[lo:hi] = cum
    return dataclasses.replace(
        g, step_handle=new_steps, step_pos=new_pos, _cache={}
    )


def drop_nodes(g: GraphTensors, drop_mask: np.ndarray) -> GraphTensors:
    """Remove the masked nodes, their edges, and break paths around them.

    Paths crossing a removed node are split into fragments named
    `name:start-end` like the reference's subsetting tools.
    """
    keep = ~np.asarray(drop_mask, dtype=bool)
    n = g.num_nodes
    new_rank = np.cumsum(keep) - 1
    b = GraphBuilder()
    for r in range(n):
        if keep[r]:
            b.add_node(int(new_rank[r]) + 1, g.node_seq(r))
    ef, et = g.edge_from, g.edge_to
    ok = keep[handle_rank(ef)] & keep[handle_rank(et)]
    for a, t in zip(ef[ok], et[ok]):
        a, t = int(a), int(t)
        b.add_edge_handles(
            int(new_rank[a >> 1] << 1) | (a & 1),
            int(new_rank[t >> 1] << 1) | (t & 1),
        )
    for p in range(g.num_paths):
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        hs = g.step_handle[lo:hi]
        pos = g.step_pos[lo:hi]
        frag = []
        frag_start = 0

        def emit(frag, frag_start):
            if not frag:
                return
            end = int(pos[frag[-1][0]]) + int(
                g.node_len[frag[-1][1] >> 1]
            )
            name = g.path_names[p]
            if frag_start != 0 or frag[-1][0] != hi - lo - 1:
                name = f"{name}:{int(pos[frag[0][0]])}-{end}"
            pi = b.add_path(name)
            for _, h in frag:
                b.append_step_handle(
                    pi, int(new_rank[h >> 1] << 1) | (h & 1)
                )

        for k, h in enumerate(hs):
            h = int(h)
            if keep[h >> 1]:
                frag.append((k, h))
            else:
                emit(frag, frag_start)
                frag = []
                frag_start = k + 1
        emit(frag, frag_start)
    return b.build()


def prune_high_degree(g: GraphTensors, max_degree: int) -> GraphTensors:
    """Drop nodes whose total degree exceeds max_degree
    (reference: remove_high_degree.cpp)."""
    deg = g.adjacency.degree_out()
    total = deg[0::2] + deg[1::2]
    return drop_nodes(g, total > max_degree)


def prune_low_depth(g: GraphTensors, min_depth: int) -> GraphTensors:
    """Drop nodes covered by fewer than min_depth path steps
    (reference: prune.cpp coverage pruning)."""
    from .coverage import node_depth

    return drop_nodes(g, node_depth(g) < min_depth)


def cut_tips(g: GraphTensors, min_tip_bp: Optional[int] = None) -> GraphTensors:
    """Remove tip nodes: nodes with no edges on one side that no path
    anchors (reference: cut_tips.cpp — removes degree-0-side nodes)."""
    deg = g.adjacency.degree_out()
    is_tip = (deg[0::2] == 0) | (deg[1::2] == 0)
    if min_tip_bp is not None:
        is_tip &= g.node_len <= min_tip_bp
    # never drop the only node of a component
    comp = weak_component_ids(g)
    sizes = np.bincount(comp)
    is_tip &= sizes[comp] > 1
    return drop_nodes(g, is_tip)


def explode(g: GraphTensors) -> List[GraphTensors]:
    """Split into one graph per weakly-connected component
    (reference: explode_main.cpp)."""
    comp = weak_component_ids(g)
    ncomp = int(comp.max()) + 1 if len(comp) else 0
    out = []
    for c in range(ncomp):
        out.append(drop_nodes(g, comp != c))
    return out


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


def squeeze(graphs: Sequence[GraphTensors]) -> GraphTensors:
    """Concatenate graphs into one, offsetting ids
    (reference: squeeze_main.cpp)."""
    b = GraphBuilder()
    next_id = 1
    for gi, g in enumerate(graphs):
        base = next_id
        for r in range(g.num_nodes):
            b.add_node(next_id, g.node_seq(r))
            next_id += 1
        for a, t in zip(g.edge_from, g.edge_to):
            a, t = int(a), int(t)
            b.add_edge_handles(
                ((base - 1 + (a >> 1)) << 1) | (a & 1),
                ((base - 1 + (t >> 1)) << 1) | (t & 1),
            )
        for p in range(g.num_paths):
            name = g.path_names[p]
            pi = b.add_path(name, bool(g.path_circular[p]))
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            for h in g.step_handle[lo:hi]:
                h = int(h)
                b.append_step_handle(pi, ((base - 1 + (h >> 1)) << 1) | (h & 1))
    return b.build()
