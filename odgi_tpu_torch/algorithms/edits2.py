"""Graph edits and generators (host, numpy): crush, break cycles,
unitigs, chop_at and inject, cover, differential-privacy sampling and
procbed; the counterpart of ``odgi_tpu/algorithms/edits2.py``.

`unitigs` and `diff_priv` draw from ``np.random.default_rng(seed)`` with
the same calls in the same order, so one seed gives the same bytes in
both packages.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterable, List, Optional, TextIO, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_flip


def _rebuild_with_sequences(g: GraphTensors, seqs: List[bytes]) -> GraphTensors:
    """Replace every node's sequence (lengths may change); recompute
    seq arrays and step positions."""
    import dataclasses

    n = g.num_nodes
    node_len = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_offset = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(node_len, out=seq_offset[1:])
    seq = (
        np.frombuffer(b"".join(seqs), dtype=np.uint8).copy()
        if n
        else np.empty(0, dtype=np.uint8)
    )
    step_pos = np.zeros(g.num_steps, dtype=np.int64)
    if g.num_steps:
        lens = node_len[g.step_handle >> 1]
        cum = np.cumsum(lens) - lens
        step_pos = cum - cum[g.path_offset[g.step_path]]
    return dataclasses.replace(
        g,
        node_len=node_len,
        seq_offset=seq_offset,
        seq=seq,
        step_pos=step_pos,
        _cache={},
    )


def crush_n(g: GraphTensors) -> GraphTensors:
    """Collapse runs of N in every node sequence to a single N
    (reference: src/algorithms/crush_n.cpp — `odgi crush`)."""
    # vectorized: drop bytes that are 'N' AND preceded by 'N' within a node
    is_n = g.seq == ord("N")
    prev_n = np.zeros_like(is_n)
    prev_n[1:] = is_n[:-1]
    # first byte of each node never has an in-node predecessor
    prev_n[g.seq_offset[:-1][g.node_len > 0]] = False
    keep = ~(is_n & prev_n)
    seqs = []
    kept = g.seq[keep]
    # new lengths per node = keep-count per node
    node_of_byte = np.repeat(np.arange(g.num_nodes), g.node_len)
    new_len = np.bincount(node_of_byte[keep], minlength=g.num_nodes)
    off = np.zeros(g.num_nodes + 1, dtype=np.int64)
    np.cumsum(new_len, out=off[1:])
    seqs = [kept[off[i] : off[i + 1]].tobytes() for i in range(g.num_nodes)]
    return _rebuild_with_sequences(g, seqs)


# ---------------------------------------------------------------------------
# break cycles (reference: src/algorithms/break_cycles.cpp, `odgi break`)
# ---------------------------------------------------------------------------


def edges_inducing_cycles(
    g: GraphTensors, max_cycle_size: int = 0, max_search_bp: int = 0
) -> List[Tuple[int, int]]:
    """Greedy cycle-edge detection: BFS from each handle in both
    orientations; an edge closing back onto the BFS root is a cycle edge
    (break_cycles.cpp:9-82).  The BFS stops when the frontier's minimum
    path length exceeds max_cycle_size or seen_bp exceeds max_search_bp."""
    adj = g.adjacency
    node_len = g.node_len
    to_remove: set = set()

    def removed(e):
        a, b = e
        return (a, b) in to_remove or (int(handle_flip(b)), int(handle_flip(a))) in to_remove

    for rank in range(g.num_nodes):
        for root in (rank << 1, (rank << 1) | 1):
            seen_bp = 0
            max_depth = 0
            last_min_len = 0
            curr_min_len = math.inf
            seen = {root}
            q = deque([(root, 0, int(node_len[rank]), 0)])  # handle, root#, len, depth
            while q:
                h, _, length, depth = q.popleft()
                if depth > max_depth:
                    max_depth = depth
                    last_min_len = curr_min_len
                    curr_min_len = length
                else:
                    curr_min_len = min(curr_min_len, length)
                seen_bp += int(node_len[h >> 1])
                if (max_cycle_size and last_min_len != math.inf and last_min_len > max_cycle_size) or (
                    max_search_bp and seen_bp > max_search_bp
                ):
                    break
                for nxt in adj.neighbors(h):
                    nxt = int(nxt)
                    e = (h, nxt)
                    if nxt == root:
                        to_remove.add(e)
                        continue
                    if removed(e):
                        continue
                    if nxt not in seen:
                        seen.add(nxt)
                        q.append(
                            (nxt, 0, length + int(node_len[nxt >> 1]), depth + 1)
                        )
    return sorted(to_remove)


def break_cycles(
    g: GraphTensors,
    max_cycle_size: int = 0,
    max_search_bp: int = 0,
    iter_max: int = 1,
) -> Tuple[GraphTensors, int]:
    """Remove cycle-inducing edges until none found or iter_max reached;
    paths are dropped when any edge was removed (break_main.cpp:100-106).
    Returns (graph, removed_edge_count)."""
    import dataclasses

    removed_total = 0
    for _ in range(max(1, iter_max)):
        edges = edges_inducing_cycles(g, max_cycle_size, max_search_bp)
        if not edges:
            break
        drop = set(edges)
        keep = np.ones(g.num_edges, dtype=bool)
        for i in range(g.num_edges):
            a, b = int(g.edge_from[i]), int(g.edge_to[i])
            if (a, b) in drop or (b ^ 1, a ^ 1) in drop:
                keep[i] = False
        removed_total += int((~keep).sum())
        g = dataclasses.replace(
            g,
            edge_from=g.edge_from[keep],
            edge_to=g.edge_to[keep],
            _cache={},
        )
    if removed_total:
        g = dataclasses.replace(
            g,
            path_names=(),
            path_circular=np.zeros(0, dtype=bool),
            path_offset=np.zeros(1, dtype=np.int64),
            step_handle=np.empty(0, dtype=np.int64),
            step_pos=np.empty(0, dtype=np.int64),
            _cache={},
        )
    return g, removed_total


# ---------------------------------------------------------------------------
# unitigs (reference: src/subcommand/unitig_main.cpp)
# ---------------------------------------------------------------------------


def unitigs(
    g: GraphTensors,
    min_begin_node_length: int = 0,
    sample_to: int = 0,
    sample_plus: int = 0,
    seed: Optional[int] = None,
) -> Iterable[Tuple[List[int], int]]:
    """Yield (handles, length) unitigs: maximal unary paths extended from
    each unvisited node (unitig_main.cpp:95-178), optionally extended by a
    random walk to reach a target length (:130-178)."""
    adj = g.adjacency
    node_len = g.node_len
    seen = np.zeros(g.num_nodes, dtype=bool)
    if min_begin_node_length:
        seen[node_len < min_begin_node_length] = True
    rng = np.random.default_rng(seed)

    def degree(h):
        return adj.offsets[h + 1] - adj.offsets[h]

    for rank in range(g.num_nodes):
        if seen[rank]:
            continue
        seen[rank] = True
        start = rank << 1
        unitig = deque([start])
        in_unitig = {start}
        # extend right while out-degree == 1
        curr = start
        while degree(curr) == 1:
            curr = int(adj.neighbors(curr)[0])
            if curr in in_unitig:
                break
            unitig.append(curr)
            seen[curr >> 1] = True
            in_unitig.add(curr)
        # extend left while in-degree == 1 (follow left = right of flip)
        curr = start
        while degree(curr ^ 1) == 1:
            curr = int(adj.neighbors(curr ^ 1)[0]) ^ 1
            if curr in in_unitig:
                break
            unitig.appendleft(curr)
            seen[curr >> 1] = True
            in_unitig.add(curr)
        length = int(sum(node_len[h >> 1] for h in unitig))
        to_add = 0
        if sample_plus:
            to_add = sample_plus * 2
        if sample_to > length:
            to_add = sample_to - length
        added_fwd = 0
        curr = unitig[-1]
        while added_fwd < to_add // 2 and degree(curr) > 0:
            nbrs = adj.neighbors(curr)
            j = int(rng.integers(0, len(nbrs) + 1))
            j = min(j, len(nbrs) - 1)
            h = int(nbrs[j])
            unitig.append(h)
            added_fwd += int(node_len[h >> 1])
            curr = h
        added_rev = 0
        curr = unitig[0]
        while added_rev < to_add // 2 and degree(curr ^ 1) > 0:
            nbrs = adj.neighbors(curr ^ 1)
            j = int(rng.integers(0, len(nbrs) + 1))
            j = min(j, len(nbrs) - 1)
            h = int(nbrs[j]) ^ 1
            unitig.appendleft(h)
            added_rev += int(node_len[h >> 1])
            curr = h
        length += added_fwd + added_rev
        yield list(unitig), length


def write_unitigs(
    g: GraphTensors,
    out: TextIO,
    fake_fastq: bool = False,
    min_begin_node_length: int = 0,
    sample_to: int = 0,
    sample_plus: int = 0,
    seed: Optional[int] = None,
) -> None:
    """FASTA/FASTQ unitig output (unitig_main.cpp:179-205)."""
    num = 0
    for handles, length in unitigs(
        g, min_begin_node_length, sample_to, sample_plus, seed
    ):
        num += 1
        head = "@" if fake_fastq else ">"
        path = ",".join(
            f"{int(g.node_id[h >> 1])}{'-' if h & 1 else '+'}" for h in handles
        )
        out.write(f"{head}unitig{num} length={length} path={path}\n")
        seq = b"".join(g.node_seq(h >> 1, bool(h & 1)) for h in handles)
        out.write(seq.decode("ascii") + "\n")
        if fake_fastq:
            out.write("+\n" + "I" * len(seq) + "\n")


# ---------------------------------------------------------------------------
# chop_at + inject (reference: src/algorithms/inject.cpp, `odgi inject`)
# ---------------------------------------------------------------------------


def chop_at(g: GraphTensors, cut_points: Dict[int, List[int]]) -> GraphTensors:
    """Split nodes at forward-strand offsets (reference: chop_at used by
    inject.cpp:135).  cut_points: node rank -> sorted unique offsets in
    (0, len).  Steps expand into oriented piece chains."""
    n = g.num_nodes
    piece_bounds: List[np.ndarray] = []
    pieces = np.ones(n, dtype=np.int64)
    for r, cuts in cut_points.items():
        pieces[r] = len(cuts) + 1
    new_n = int(pieces.sum())
    base = np.cumsum(pieces) - pieces

    new_len = np.empty(new_n, dtype=np.int64)
    for r in range(n):
        if pieces[r] == 1:
            new_len[base[r]] = g.node_len[r]
        else:
            cuts = cut_points[r]
            bounds = [0, *cuts, int(g.node_len[r])]
            for i in range(pieces[r]):
                new_len[base[r] + i] = bounds[i + 1] - bounds[i]
    new_off = np.zeros(new_n + 1, dtype=np.int64)
    np.cumsum(new_len, out=new_off[1:])
    new_seq = g.seq.copy()  # same bytes, same order

    def map_end(h):
        h = np.asarray(h)
        r = h >> 1
        rev = h & 1
        piece = np.where(rev == 1, base[r], base[r] + pieces[r] - 1)
        return (piece << 1) | rev

    def map_start(h):
        h = np.asarray(h)
        r = h >> 1
        rev = h & 1
        piece = np.where(rev == 1, base[r] + pieces[r] - 1, base[r])
        return (piece << 1) | rev

    ef = map_end(g.edge_from) if g.num_edges else g.edge_from
    et = map_start(g.edge_to) if g.num_edges else g.edge_to
    chain_from, chain_to = [], []
    for r in np.nonzero(pieces > 1)[0]:
        rr = np.arange(base[r], base[r] + pieces[r] - 1)
        chain_from.append(rr << 1)
        chain_to.append((rr + 1) << 1)
    if chain_from:
        ef = np.concatenate([ef, *chain_from])
        et = np.concatenate([et, *chain_to])

    # expand steps: forward step -> pieces in order fwd; reverse step ->
    # pieces in REVERSE order, each reversed
    S = g.num_steps
    step_counts = pieces[g.step_handle >> 1] if S else np.zeros(0, np.int64)
    total = int(step_counts.sum())
    new_steps = np.empty(total, dtype=np.int64)
    w = 0
    for s in range(S):
        h = int(g.step_handle[s])
        r, rev = h >> 1, h & 1
        k = int(pieces[r])
        if rev:
            rr = np.arange(base[r] + k - 1, base[r] - 1, -1)
        else:
            rr = np.arange(base[r], base[r] + k)
        new_steps[w : w + k] = (rr << 1) | rev
        w += k
    new_path_off = np.zeros(g.num_paths + 1, dtype=np.int64)
    if S:
        per_path = np.add.reduceat(step_counts, g.path_offset[:-1])
        # reduceat mishandles empty paths; recompute safely
        per_path = np.array(
            [
                int(step_counts[g.path_offset[p] : g.path_offset[p + 1]].sum())
                for p in range(g.num_paths)
            ],
            dtype=np.int64,
        )
        np.cumsum(per_path, out=new_path_off[1:])
    step_pos = np.zeros(total, dtype=np.int64)
    if total:
        lens = new_len[new_steps >> 1]
        cum = np.cumsum(lens) - lens
        sp = np.repeat(np.arange(g.num_paths, dtype=np.int64), np.diff(new_path_off))
        step_pos = cum - cum[new_path_off[sp]]

    return GraphTensors(
        node_len=new_len,
        seq_offset=new_off,
        seq=new_seq,
        node_id=np.arange(1, new_n + 1, dtype=np.int64),
        edge_from=ef.astype(np.int64),
        edge_to=et.astype(np.int64),
        path_names=g.path_names,
        path_circular=g.path_circular,
        path_offset=new_path_off,
        step_handle=new_steps,
        step_pos=step_pos,
    )


def inject_ranges(
    g: GraphTensors,
    intervals: List[Tuple[str, int, int, str]],
) -> GraphTensors:
    """Turn BED intervals (path, start, end, name) over existing paths into
    new embedded paths (reference: inject.cpp:9-260, `odgi inject`).

    Cuts nodes at interval boundaries, then appends one new path per
    interval name covering the steps in [start, end)."""
    name_to_idx = {n: i for i, n in enumerate(g.path_names)}
    by_path: Dict[int, List[Tuple[int, int, str]]] = {}
    ordered_names: List[str] = []
    for pname, start, end, iname in intervals:
        if pname not in name_to_idx:
            continue
        by_path.setdefault(name_to_idx[pname], []).append((start, end, iname))
        ordered_names.append(iname)
    if len(set(ordered_names)) != len(ordered_names):
        raise ValueError("duplicate annotation path name in BED")

    # 1) find cut offsets (forward strand) at interval starts/ends that
    #    fall inside nodes
    cut_points: Dict[int, List[int]] = {}
    for p, ivals in by_path.items():
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        pos = g.step_pos[lo:hi]
        handles = g.step_handle[lo:hi]
        lens = g.node_len[handles >> 1]
        for start, end, _ in ivals:
            for bound in (start, end):
                # step containing `bound` (or ending exactly at it)
                k = int(np.searchsorted(pos, bound, side="right")) - 1
                if k < 0 or k >= hi - lo:
                    continue
                off_in_node = bound - int(pos[k])
                L = int(lens[k])
                if 0 < off_in_node < L:
                    h = int(handles[k])
                    fwd_off = L - off_in_node if h & 1 else off_in_node
                    cut_points.setdefault(h >> 1, []).append(int(fwd_off))
    for r in cut_points:
        cut_points[r] = sorted(set(cut_points[r]))
    g2 = chop_at(g, cut_points) if cut_points else g

    # 2) walk each source path in the chopped graph and emit sub-paths
    new_names = list(g2.path_names)
    new_circ = list(g2.path_circular)
    new_steps: List[np.ndarray] = [
        g2.step_handle[g2.path_offset[p] : g2.path_offset[p + 1]]
        for p in range(g2.num_paths)
    ]
    for p, ivals in by_path.items():
        lo, hi = int(g2.path_offset[p]), int(g2.path_offset[p + 1])
        pos = g2.step_pos[lo:hi]
        handles = g2.step_handle[lo:hi]
        lens = g2.node_len[handles >> 1]
        ends = pos + lens
        for start, end, iname in ivals:
            a = int(np.searchsorted(pos, start, side="left"))
            b = int(np.searchsorted(ends, end, side="right"))
            if a >= hi - lo or b <= a:
                # boundary not at a node edge -> reference errors out
                if int(pos[min(a, hi - lo - 1)]) != start:
                    raise ValueError(
                        f"injection start for interval {iname} not at node boundary"
                    )
            new_names.append(iname)
            new_circ.append(False)
            new_steps.append(handles[a:b])

    path_offset = np.zeros(len(new_names) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in new_steps], out=path_offset[1:])
    step_handle = (
        np.concatenate(new_steps) if path_offset[-1] else np.empty(0, np.int64)
    )
    step_pos = np.zeros(len(step_handle), dtype=np.int64)
    if len(step_handle):
        lens = g2.node_len[step_handle >> 1]
        cum = np.cumsum(lens) - lens
        sp = np.repeat(
            np.arange(len(new_names), dtype=np.int64), np.diff(path_offset)
        )
        step_pos = cum - cum[path_offset[sp]]
    import dataclasses

    return dataclasses.replace(
        g2,
        path_names=tuple(new_names),
        path_circular=np.asarray(new_circ, dtype=bool),
        path_offset=path_offset,
        step_handle=step_handle.astype(np.int64),
        step_pos=step_pos,
        _cache={},
    )


# ---------------------------------------------------------------------------
# cover (reference: src/algorithms/cover.cpp, `odgi cover`)
# ---------------------------------------------------------------------------


def path_cover(
    g: GraphTensors,
    num_paths_per_component: int = 16,
    node_window_size: int = 2,
    min_node_depth: int = 0,
    ignore_paths: bool = False,
) -> GraphTensors:
    """Greedy path cover (gbwtgraph-inspired; cover.cpp:236-340): per weak
    component, repeatedly grow a path from the least-covered node,
    extending at each end toward the neighbor whose k-node window has the
    lowest coverage."""
    from .components import weak_component_ids
    from .coverage import node_depth

    adj = g.adjacency
    comp = weak_component_ids(g)
    n = g.num_nodes
    depth0 = (
        np.zeros(n, dtype=np.int64)
        if ignore_paths
        else node_depth(g).astype(np.int64)
    )
    node_cov = depth0.copy()
    new_paths: List[Tuple[str, List[int]]] = []
    path_cov: Dict[Tuple[int, ...], int] = {}

    def window_key(handles: List[int]) -> Tuple[int, ...]:
        fwd = tuple(handles)
        rev = tuple(h ^ 1 for h in reversed(handles))
        return min(fwd, rev)

    k = max(2, node_window_size)
    count = 0
    for c in np.unique(comp):
        members = np.nonzero(comp == c)[0]
        limit = num_paths_per_component if num_paths_per_component else len(members)
        min_depth = (
            np.iinfo(np.int64).max if num_paths_per_component else min_node_depth
        )
        for _ in range(limit):
            # least-covered node in component (ties: smallest rank)
            local = members[np.argmin(node_cov[members])]
            if node_cov[local] >= min_depth:
                break
            path = deque([int(local) << 1])
            node_cov[local] += 1
            success = True
            while success and len(path) < len(members):
                success = False
                # forward extension
                nbrs = adj.neighbors(path[-1])
                if len(nbrs):
                    success = True
                    best_h, best_c = None, None
                    for h in map(int, nbrs):
                        if len(path) + 1 < k:
                            cscore = int(node_cov[h >> 1])
                        else:
                            win = window_key([*list(path)[-(k - 1) :], h])
                            cscore = path_cov.get(win, 0)
                        if best_c is None or cscore < best_c:
                            best_c, best_h = cscore, h
                    if len(path) + 1 >= k:
                        win = window_key([*list(path)[-(k - 1) :], best_h])
                        path_cov[win] = path_cov.get(win, 0) + 1
                    node_cov[best_h >> 1] += 1
                    path.append(best_h)
                if len(path) >= len(members):
                    break
                # backward extension
                nbrs = adj.neighbors(path[0] ^ 1)
                if len(nbrs):
                    success = True
                    best_h, best_c = None, None
                    for hh in map(int, nbrs):
                        h = hh ^ 1
                        if len(path) + 1 < k:
                            cscore = int(node_cov[h >> 1])
                        else:
                            win = window_key([h, *list(path)[: k - 1]])
                            cscore = path_cov.get(win, 0)
                        if best_c is None or cscore < best_c:
                            best_c, best_h = cscore, h
                    if len(path) + 1 >= k:
                        win = window_key([best_h, *list(path)[: k - 1]])
                        path_cov[win] = path_cov.get(win, 0) + 1
                    node_cov[best_h >> 1] += 1
                    path.appendleft(best_h)
            count += 1
            new_paths.append((f"Path_{count}", list(path)))

    # append the generated paths
    import dataclasses

    names = [*g.path_names, *(n for n, _ in new_paths)]
    circ = np.concatenate([g.path_circular, np.zeros(len(new_paths), bool)])
    steps_list = [
        g.step_handle[g.path_offset[p] : g.path_offset[p + 1]]
        for p in range(g.num_paths)
    ] + [np.asarray(s, dtype=np.int64) for _, s in new_paths]
    path_offset = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in steps_list], out=path_offset[1:])
    step_handle = (
        np.concatenate(steps_list) if path_offset[-1] else np.empty(0, np.int64)
    )
    step_pos = np.zeros(len(step_handle), dtype=np.int64)
    if len(step_handle):
        lens = g.node_len[step_handle >> 1]
        cum = np.cumsum(lens) - lens
        sp = np.repeat(np.arange(len(names), dtype=np.int64), np.diff(path_offset))
        step_pos = cum - cum[path_offset[sp]]
    return dataclasses.replace(
        g,
        path_names=tuple(names),
        path_circular=circ,
        path_offset=path_offset,
        step_handle=step_handle,
        step_pos=step_pos,
        _cache={},
    )


# ---------------------------------------------------------------------------
# differential-privacy sampling (reference: src/algorithms/diffpriv.cpp)
# ---------------------------------------------------------------------------


def diff_priv(
    g: GraphTensors,
    epsilon: float = 0.01,
    target_coverage: float = 1.0,
    min_haplotype_freq: int = 2,
    bp_limit: int = 10000,
    seed: Optional[int] = None,
    write_samples: Optional[TextIO] = None,
) -> GraphTensors:
    """ε-differentially-private subpath sampling via the exponential
    mechanism (diffpriv.cpp:7-180, `odgi priv`): sample a start node
    weighted by length, extend step-range groups choosing the next node
    with probability ∝ exp(ε·log1p(count) / (2·Δu)), and emit a sampled
    haplotype once it reaches bp_limit with frequency >= min_haplotype_freq.

    Returns a graph with the same nodes/edges and ONLY the sampled paths.
    """
    rng = np.random.default_rng(seed)
    graph_bp = int(g.total_length)
    target_length = int(graph_bp * target_coverage)
    # steps sorted by node for for_each_step_on_handle
    order = np.argsort(g.step_handle >> 1, kind="stable")
    sorted_nodes = (g.step_handle[order] >> 1).astype(np.int64)
    node_step_off = np.searchsorted(sorted_nodes, np.arange(g.num_nodes + 1))

    sampled = 0
    haps: List[List[int]] = []  # step-index ranges expanded to handles
    # bail out when sampling cannot make progress (e.g. all haplotype
    # frequencies < min_haplotype_freq — the reference would spin forever,
    # diffpriv.cpp:25-95; we stop after a bounded number of dry attempts)
    dry_attempts = 0
    max_dry = max(1000, 10 * g.num_nodes)

    def steps_on_node(r: int) -> np.ndarray:
        return order[node_step_off[r] : node_step_off[r + 1]]

    cum_len = g.node_offset  # cumulative node starts
    while sampled < target_length and g.num_steps and dry_attempts < max_dry:
        before = sampled
        pos = int(rng.integers(0, graph_bp))
        r = int(np.searchsorted(cum_len, pos, side="right")) - 1
        ranges = [(int(s), int(s)) for s in steps_on_node(r)]
        walk_length = int(g.node_len[r])
        while ranges:
            nexts: Dict[int, List[Tuple[int, int]]] = {}
            for a, b in ranges:
                p = int(g.step_path[b])
                if b + 1 < int(g.path_offset[p + 1]):
                    h = int(g.step_handle[b + 1])
                    nexts.setdefault(h, []).append((a, b + 1))
            if not nexts:
                break
            keys = sorted(nexts)
            weights = []
            for h in keys:
                cnt = len(nexts[h])
                u = math.log1p(cnt)
                d_u = u - math.log1p(cnt - 1)
                weights.append(math.exp((epsilon * u) / (2 * d_u)))
            total = sum(weights)
            d = rng.random() * total
            x = 0.0
            opt = keys[-1]
            for h, w in zip(keys, weights):
                if x + w >= d:
                    opt = h
                    break
                x += w
            ranges = nexts[opt]
            walk_length += int(g.node_len[opt >> 1])
            if len(ranges) < min_haplotype_freq:
                break
            if walk_length >= bp_limit:
                a, b = ranges[int(rng.integers(0, len(ranges)))]
                sampled += walk_length
                haps.append(list(range(a, b + 1)))
                break
        dry_attempts = dry_attempts + 1 if sampled == before else 0

    # build output graph: same nodes/edges, paths = sampled haplotypes
    import dataclasses

    names = tuple(f"hap{i+1}" for i in range(len(haps)))
    steps_list = [g.step_handle[np.asarray(h, dtype=np.int64)] for h in haps]
    if write_samples is not None:
        for name, s in zip(names, steps_list):
            walk = "".join(
                ("<" if int(h) & 1 else ">") + str(int(g.node_id[int(h) >> 1]))
                for h in s
            )
            write_samples.write(f"{name}\t{walk}\n")
    path_offset = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in steps_list], out=path_offset[1:])
    step_handle = (
        np.concatenate(steps_list) if len(names) and path_offset[-1] else np.empty(0, np.int64)
    )
    step_pos = np.zeros(len(step_handle), dtype=np.int64)
    if len(step_handle):
        lens = g.node_len[step_handle >> 1]
        cum = np.cumsum(lens) - lens
        sp = np.repeat(np.arange(len(names), dtype=np.int64), np.diff(path_offset))
        step_pos = cum - cum[path_offset[sp]]
    return dataclasses.replace(
        g,
        path_names=names,
        path_circular=np.zeros(len(names), dtype=bool),
        path_offset=path_offset,
        step_handle=step_handle.astype(np.int64),
        step_pos=step_pos,
        _cache={},
    )


# ---------------------------------------------------------------------------
# procbed (reference: src/algorithms/procbed.cpp, `odgi procbed`)
# ---------------------------------------------------------------------------


def procbed_adjust(
    g: GraphTensors, bed_lines: Iterable[str], out: TextIO
) -> None:
    """Adjust BED records from full-genome space into an extracted
    subgraph's subpath space (procbed.cpp:9-121): subpaths named
    `base:start-end` (PanSN-ish) clip and shift the records."""
    subpaths: Dict[str, List[Tuple[int, int]]] = {}
    for p, name in enumerate(g.path_names):
        base, start, end = name, 0, int(g.path_length[p])
        c = name.find(":")
        if c != -1:
            d = name.find("-", c)
            if d != -1:
                try:
                    start = int(name[c + 1 : d])
                    end = int(name[d + 1 :])
                    base = name[:c]
                except ValueError:
                    pass
        subpaths.setdefault(base, []).append((start, end))
    for v in subpaths.values():
        v.sort()
    for line in bed_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        vals = line.split("\t")
        if len(vals) < 4:
            raise ValueError(f"BED line lacks interval fields: {line}")
        ref, b_start, b_end, key = vals[0], int(vals[1]), int(vals[2]), vals[3]
        for r_start, r_end in subpaths.get(ref, []):
            if b_start >= r_start and b_end > r_start and r_end >= b_end:
                out.write(
                    f"{ref}:{r_start}-{r_end}\t{b_start - r_start}\t"
                    f"{b_end - r_start}\t{key}\n"
                )
