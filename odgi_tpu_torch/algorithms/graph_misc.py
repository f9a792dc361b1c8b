"""Graph algorithms of the long tail: split_strands, acyclicity, walk
counts, the shortest cycle, the Eades feedback-arc-set order, the non-path
linear SGD order and dagify.

Host code (Python and numpy), a copy of ``odgi_tpu/algorithms/graph_misc.py``
with the same outputs: ``stats --is-acyclic / --count-walks /
--shortest-cycle`` and the sort codes d, e and l reach it.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import GraphBuilder, GraphTensors


def split_strands(g: GraphTensors) -> Tuple[GraphTensors, Dict[int, Tuple[int, bool]]]:
    """Forward/reverse node doubling (reference: split_strands.cpp:9-62):
    every node becomes a forward copy (id 2r+1) and a reverse-complement
    copy (id 2r+2); each edge becomes two forward-only edges.  Returns
    (new graph, {new_id: (old_id, was_reverse)})."""
    b = GraphBuilder()
    translation: Dict[int, Tuple[int, bool]] = {}
    for r in range(g.num_nodes):
        fwd_id = 2 * r + 1
        rev_id = 2 * r + 2
        b.add_node(fwd_id, g.node_seq(r, False))
        b.add_node(rev_id, g.node_seq(r, True))
        translation[fwd_id] = (int(g.node_id[r]), False)
        translation[rev_id] = (int(g.node_id[r]), True)

    def image(h: int) -> int:
        r, rev = int(h) >> 1, int(h) & 1
        return 2 * r + 2 if rev else 2 * r + 1

    for a, bb in zip(g.edge_from, g.edge_to):
        b.add_edge(image(a), False, image(bb), False)
        b.add_edge(image(int(bb) ^ 1), False, image(int(a) ^ 1), False)
    return b.build(), translation


def single_stranded_orientation(g: GraphTensors) -> Optional[np.ndarray]:
    """bool[N] orientation making every edge non-inverting, or None when a
    reversing cycle exists (reference: is_acyclic.cpp:11-20 uses this to
    rule out reversing cycles)."""
    adj = g.adjacency
    orient = np.full(g.num_nodes, -1, dtype=np.int8)
    for r0 in range(g.num_nodes):
        if orient[r0] >= 0:
            continue
        orient[r0] = 0
        stack = [r0]
        while stack:
            r = stack.pop()
            h = (r << 1) | int(orient[r])
            for side in (h, h ^ 1):
                for t in adj.neighbors(side):
                    tr, trev = int(t) >> 1, int(t) & 1
                    want = trev if side == h else trev ^ 1
                    if orient[tr] < 0:
                        orient[tr] = want
                        stack.append(tr)
                    elif orient[tr] != want:
                        return None
    return orient.astype(bool)


def is_directed_acyclic(g: GraphTensors) -> bool:
    """Tip-peeling check (reference: is_acyclic.cpp:22-87)."""
    adj = g.adjacency
    N = g.num_nodes
    deg = adj.degree_out()           # per packed handle
    start_deg = deg[1::2].copy()     # left degree of forward node
    end_deg = deg[0::2].copy()       # right degree
    alive = np.ones(N, dtype=bool)
    stack: List[int] = []
    for r in range(N):
        if start_deg[r] == 0:
            stack.append(r << 1)
        if end_deg[r] == 0:
            stack.append((r << 1) | 1)
    while stack:
        h = stack.pop()
        r = h >> 1
        if not alive[r]:
            continue
        alive[r] = False
        for t in adj.neighbors(h):
            tr = int(t) >> 1
            if not alive[tr]:
                continue
            if int(t) & 1:
                end_deg[tr] -= 1
                if end_deg[tr] == 0:
                    stack.append((tr << 1) | 1)
            else:
                start_deg[tr] -= 1
                if start_deg[tr] == 0:
                    stack.append(tr << 1)
    return not alive.any()


def is_acyclic(g: GraphTensors) -> bool:
    """No reversing cycles AND no directed cycles
    (reference: is_acyclic.cpp:11-20)."""
    if single_stranded_orientation(g) is None:
        return False
    return is_directed_acyclic(g)


def count_walks(g: GraphTensors) -> int:
    """Source-to-sink walk count by topological DP
    (reference: count_walks.cpp:9-62); caps at 2^63-1 on overflow."""
    from .topological import topological_order

    adj = g.adjacency
    N = g.num_nodes
    if N == 0:
        return 0
    deg = adj.degree_out()
    count = {}
    sinks = []
    for r in range(N):
        h = r << 1
        if deg[h ^ 1] == 0:  # no left neighbors: source
            count[h] = 1
        if deg[h] == 0:
            sinks.append(h)
    cap = (1 << 63) - 1
    for r in topological_order(g):
        h = int(r) << 1
        c = count.get(h, 0)
        if c == 0:
            continue
        for t in adj.neighbors(h):
            t = int(t)
            nxt = count.get(t, 0) + c
            if nxt > cap:
                return cap
            count[t] = nxt
    return sum(count.get(h, 0) for h in sinks)


def eades_order(g: GraphTensors) -> np.ndarray:
    """Eades-Lin-Smyth greedy feedback-arc-set layout over forward handles
    (reference: eades_algorithm.cpp:11-250): peel sources to the left,
    sinks to the right, otherwise take the max out-minus-in-degree node."""
    adj = g.adjacency
    N = g.num_nodes
    if N == 0:
        return np.empty(0, dtype=np.int64)
    in_deg = {}
    out_deg = {}
    sources = []
    sinks = []
    bucket_of: Dict[int, int] = {}
    buckets: Dict[int, set] = {}
    placed = np.zeros(N, dtype=bool)
    for r in range(N):
        h = r << 1
        i_d = len(adj.neighbors(h ^ 1))
        o_d = len(adj.neighbors(h))
        if i_d == 0:
            sources.append(r)
        elif o_d == 0:
            sinks.append(r)
        else:
            in_deg[r] = i_d
            out_deg[r] = o_d
            bk = o_d - i_d
            bucket_of[r] = bk
            buckets.setdefault(bk, set()).add(r)

    def rebucket(r, d_in, d_out):
        buckets[bucket_of[r]].discard(r)
        if d_in == 0:
            del in_deg[r], out_deg[r], bucket_of[r]
            sources.append(r)
            return
        if d_out == 0:
            del in_deg[r], out_deg[r], bucket_of[r]
            sinks.append(r)
            return
        in_deg[r], out_deg[r] = d_in, d_out
        bk = d_out - d_in
        bucket_of[r] = bk
        buckets.setdefault(bk, set()).add(r)

    left: List[int] = []
    right: List[int] = []

    def drop_node(r):
        placed[r] = True
        h = r << 1
        for t in adj.neighbors(h):        # outgoing: targets lose an in-edge
            tr = int(t) >> 1
            if not placed[tr] and tr in bucket_of:
                rebucket(tr, in_deg[tr] - 1, out_deg[tr])
        for t in adj.neighbors(h ^ 1):    # incoming: sources lose an out-edge
            tr = int(t) >> 1
            if not placed[tr] and tr in bucket_of:
                rebucket(tr, in_deg[tr], out_deg[tr] - 1)

    while len(left) + len(right) < N:
        while sources:
            r = sources.pop()
            if placed[r]:
                continue
            left.append(r)
            drop_node(r)
        if len(left) + len(right) >= N:
            break
        if sinks:
            r = sinks.pop()
            if placed[r]:
                continue
            right.append(r)
            drop_node(r)
            continue
        # max-delta bucket
        bk = max(k for k, v in buckets.items() if v)
        r = next(iter(buckets[bk]))
        buckets[bk].discard(r)
        del in_deg[r], out_deg[r], bucket_of[r]
        left.append(r)
        drop_node(r)

    return np.array(left + right[::-1], dtype=np.int64)


def shortest_cycle_length(g: GraphTensors, source: Optional[int] = None) -> int:
    """Shortest cycle length in bp (reference: shortest_cycle.cpp:9-204):
    Eades layout + Bellman-Ford over feedback edges, or Dijkstra when
    feedback edges outnumber log |V|.  Returns 2^63-1 when acyclic."""
    adj = g.adjacency
    INF = (1 << 63) - 1
    layout = eades_order(g)
    index = {int(r): i for i, r in enumerate(layout)}
    feedback = []
    for i, r in enumerate(layout):
        for t in adj.neighbors(int(r) << 1):
            j = index[int(t) >> 1]
            if i >= j:
                feedback.append((i, j))

    def dijkstra(src_rank: int) -> int:
        dist = {}
        q = [(0, src_rank << 1)]
        while q:
            d, h = heapq.heappop(q)
            if h in dist:
                continue
            dist[h] = d
            thru = d + int(g.node_len[h >> 1])
            for t in adj.neighbors(h):
                if int(t) not in dist:
                    heapq.heappush(q, (thru, int(t)))
        best = INF
        for t in adj.neighbors((src_rank << 1) ^ 1):
            prev = int(t) ^ 1
            if prev in dist:
                best = min(best, dist[prev] + int(g.node_len[prev >> 1]))
        return best

    def bellman_ford(src_rank: int) -> int:
        n = len(layout)
        src_idx = index[src_rank]
        dp = [INF] * n
        dp[src_idx] = 0
        best = INF
        changed = True
        for _ in range(len(feedback) + 1):
            if not changed:
                break
            changed = False
            for i, r in enumerate(layout):
                if dp[i] == INF:
                    continue
                thru = dp[i] + int(g.node_len[int(r)])
                for t in adj.neighbors(int(r) << 1):
                    j = index[int(t) >> 1]
                    if i < j:
                        if j == src_idx:
                            if thru < best:
                                best = thru
                                changed = True
                        elif thru < dp[j]:
                            dp[j] = thru
                            changed = True
            for i, j in feedback:
                if dp[i] == INF:
                    continue
                thru = dp[i] + int(g.node_len[int(layout[i])])
                if j == src_idx:
                    if thru < best:
                        best = thru
                        changed = True
                elif thru < dp[j]:
                    dp[j] = thru
                    changed = True
        return best

    log_n = max(1, int(np.ceil(np.log2(max(len(layout), 2)))))
    use_bf = len(feedback) < log_n

    def one(src_rank: int) -> int:
        return bellman_ford(src_rank) if use_bf else dijkstra(src_rank)

    if source is not None:
        return one(source)
    best = INF
    for r in layout:
        best = min(best, one(int(r)))
    return best


def linear_sgd_order(
    g: GraphTensors,
    bandwidth: int = 1000,
    sampling_rate: float = 20.0,
    t_max: int = 30,
    eps: float = 0.01,
    seed: int = 9399220,
) -> np.ndarray:
    """Non-path 1D SGD over BFS-band terms
    (reference: linear_sgd.{hpp:26-45,cpp:26-160,161-230}): terms (i, j,
    d, w=1/d^2) sampled with probability rate/d from BFS within
    `bandwidth` bp of each node; positions seeded by cumulative length;
    SGD with the standard eta schedule; returns the node order by X."""
    adj = g.adjacency
    N = g.num_nodes
    rng = np.random.default_rng(seed)
    ti, tj, td = [], [], []
    seen_pairs = set()
    lens = g.node_len.astype(np.int64)
    for r in range(N):
        # BFS in bp from both sides of r
        dist = {r: 0}
        frontier = [r]
        while frontier:
            nxt = []
            for u in frontier:
                du = dist[u]
                for h in ((u << 1), (u << 1) | 1):
                    for t in adj.neighbors(h):
                        v = int(t) >> 1
                        if v not in dist:
                            dv = du + int(lens[u])
                            if dv > bandwidth:
                                continue
                            dist[v] = dv
                            nxt.append(v)
            frontier = nxt
        for v, d in dist.items():
            if v == r or d == 0:
                continue
            key = (min(r, v), max(r, v))
            if key in seen_pairs:
                continue
            if rng.random() < sampling_rate / d:
                seen_pairs.add(key)
                ti.append(r)
                tj.append(v)
                td.append(d)
    if not ti:
        return np.arange(N, dtype=np.int64)
    ti = np.asarray(ti)
    tj = np.asarray(tj)
    td = np.asarray(td, dtype=np.float64)
    w = 1.0 / (td * td)
    w_min, w_max = float(w.min()), float(w.max())
    eta_max = 1.0 / w_min
    eta_min = eps / w_max
    lam = np.log(eta_max / eta_min) / max(t_max - 1, 1)
    X = np.cumsum(lens).astype(np.float64) - lens
    for it in range(t_max):
        eta = eta_max * np.exp(-lam * it)
        order = rng.permutation(len(ti))
        for k in order:
            i, j = int(ti[k]), int(tj[k])
            mu = min(eta * w[k], 1.0)
            dx = X[i] - X[j]
            if dx == 0:
                dx = 1e-9
            mag = abs(dx)
            delta = mu * (mag - td[k]) / 2.0
            r_x = delta * (dx / mag)
            X[i] -= r_x
            X[j] += r_x
    return np.argsort(X, kind="stable").astype(np.int64)


def _forward_scc(succ: List[List[int]], n: int) -> List[List[int]]:
    """Tarjan SCCs of the forward digraph (iterative)."""
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: List[int] = []
    comps: List[List[int]] = []
    counter = 0
    for root in range(n):
        if index[root] >= 0:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            for k in range(pi, len(succ[v])):
                w = succ[v][k]
                if index[w] < 0:
                    work[-1] = (v, k + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                comps.append(comp)
    return comps


def dagify(
    g: GraphTensors, min_preserved_path_length: int = 1
) -> Tuple[GraphTensors, Dict[int, int]]:
    """Unroll cycles into a DAG by duplicating strongly connected
    components until every path of `min_preserved_path_length` bp is
    preserved (reference: src/algorithms/dagify.cpp:12-260).  Requires a
    single-stranded graph (apply split_strands first, as dagify_sort
    does); returns (dag, {new_id: old_id})."""
    n = g.num_nodes
    adj = g.adjacency
    succ: List[List[int]] = [[] for _ in range(n)]
    for r in range(n):
        for t in adj.neighbors(r << 1):
            if int(t) & 1:
                raise ValueError(
                    "dagify requires a single-stranded graph; run "
                    "split_strands first (reference: dagify.cpp:21-23)"
                )
            succ[r].append(int(t) >> 1)

    comps = _forward_scc(succ, n)
    comp_of = {}
    for ci, comp in enumerate(comps):
        for r in comp:
            comp_of[r] = ci

    b = GraphBuilder()
    translator: Dict[int, int] = {}
    next_id = 1
    copies: Dict[int, List[int]] = {r: [] for r in range(n)}  # rank -> new ids
    INF = float("inf")

    for comp in comps:
        layout = sorted(comp)
        order_in = {r: i for i, r in enumerate(layout)}
        fwd_edges: List[List[int]] = [[] for _ in layout]
        bwd_edges: List[Tuple[int, int]] = []
        for r in comp:
            i = order_in[r]
            for w in succ[r]:
                if comp_of.get(w) != comp_of[r]:
                    continue
                j = order_in[w]
                if i < j:
                    fwd_edges[i].append(j)
                else:
                    bwd_edges.append((i, j))
        lens = [int(g.node_len[r]) for r in layout]
        dist = [INF] * len(layout)
        for i, _ in bwd_edges:
            dist[i] = -lens[i]
        min_relaxed = -1
        copy_num = 0
        while min_relaxed < min_preserved_path_length:
            if copy_num == len(copies[layout[0]]):
                for r in layout:
                    nid = next_id
                    next_id += 1
                    b.add_node(nid, g.node_seq(r))
                    translator[nid] = int(g.node_id[r])
                    copies[r].append(nid)
                for i, js in enumerate(fwd_edges):
                    for j in js:
                        b.add_edge(
                            copies[layout[i]][-1], False,
                            copies[layout[j]][-1], False,
                        )
                if copy_num > 0:
                    for i, j in bwd_edges:
                        b.add_edge(
                            copies[layout[i]][-2], False,
                            copies[layout[j]][-1], False,
                        )
            next_dist = [INF] * len(layout)
            for i in range(len(layout)):
                if dist[i] == INF:
                    continue
                thru = dist[i] + lens[i]
                for j in fwd_edges[i]:
                    dist[j] = min(dist[j], thru)
            min_relaxed = INF
            for i, j in bwd_edges:
                if dist[i] == INF:
                    continue
                thru = dist[i] + lens[i]
                if thru < next_dist[j]:
                    next_dist[j] = thru
                    min_relaxed = min(min_relaxed, thru)
            dist = next_dist
            copy_num += 1
            if not bwd_edges:
                break  # acyclic component: one copy suffices

    # cross-component edges attach the last copy of the source to the
    # first copy of the target (reference: dagify.cpp:262-300)
    for r in range(n):
        for w in succ[r]:
            if comp_of[w] != comp_of[r]:
                b.add_edge(copies[r][-1], False, copies[w][0], False)
    return b.build(), translator


def dagify_sort_order_exact(g: GraphTensors) -> np.ndarray:
    """The reference's dagify sort (reference: dagify_sort.cpp:6-40):
    split strands, dagify, topologically sort the DAG, then order original
    nodes by their mean position over forward copies."""
    from .topological import topological_order

    split, split_tr = split_strands(g)
    dag, dag_tr = dagify(split, 1)
    order = topological_order(dag, use_heads=True)
    pos_sum: Dict[int, int] = {}
    pos_cnt: Dict[int, int] = {}
    for i, r in enumerate(order):
        split_id = dag_tr[int(dag.node_id[int(r)])]
        orig_id, was_rev = split_tr[split_id]
        if was_rev:
            continue
        pos_sum[orig_id] = pos_sum.get(orig_id, 0) + i
        pos_cnt[orig_id] = pos_cnt.get(orig_id, 0) + 1
    avg = sorted(
        ((pos_sum[i] / pos_cnt[i], i) for i in pos_sum),
    )
    id_to_rank = g.id_to_rank
    return np.array([id_to_rank[i] for _, i in avg], dtype=np.int64)
