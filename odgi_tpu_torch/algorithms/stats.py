"""Graph summary and sorting-goodness metrics (`odgi stats`).

The counterpart of ``odgi_tpu/algorithms/stats.py``.  The metrics over
consecutive step pairs run as tensors on `device`: gathers over the pairs
of every path and per-path sums (f64 where ``odgi_tpu`` sums in f64,
int64 where it counts).  ``sum_of_path_node_distances`` without
coordinates is the 1D sort metric (nt-distance, node distance); with
(X, Y) it is the 2D layout stress.  The graph walks
(``nondeterministic_edges``, ``component_is_acyclic``) stay on the host in
numpy, as in ``odgi_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.graph import GraphTensors, handle_rank
from ..device import resolve_device


def _consecutive_pairs(g: GraphTensors) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first_step_idx, second_step_idx, path_of_pair) for every consecutive
    step pair in every path.  Pairs never cross path boundaries."""
    S = g.num_steps
    if S == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e, e.astype(np.int32)
    is_last = np.zeros(S, dtype=bool)
    is_last[g.path_offset[1:] - 1] = True  # last step of each nonempty path
    a = np.nonzero(~is_last)[0]
    return a, a + 1, g.step_path[a]


class _Pairs:
    """The consecutive step pairs of every path as int64 tensors on `dev`:
    ranks `ra`/`rb`, orientation bits `reva`/`revb` and path `pp`."""

    def __init__(self, g: GraphTensors, dev: torch.device):
        self.dev = dev
        self.P = g.num_paths
        ai, bi, pair_path = _consecutive_pairs(g)
        ha, hb = self.t(g.step_handle[ai]), self.t(g.step_handle[bi])
        self.ra, self.rb = ha >> 1, hb >> 1
        self.reva, self.revb = ha & 1, hb & 1
        self.pp = self.t(pair_path.astype(np.int64))

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.dev)

    def per_path(self, w) -> np.ndarray:
        """f64 per-path sums of the pair weights `w`."""
        return torch.bincount(self.pp, weights=w.to(torch.float64),
                              minlength=self.P).cpu().numpy()

    def count(self, mask) -> np.ndarray:
        """i64 per-path counts of the pairs in `mask`."""
        return torch.bincount(self.pp[mask], minlength=self.P).cpu().numpy().astype(np.int64)

    def gap_links(self, g: GraphTensors) -> torch.Tensor:
        """bool per pair: the second node is the successor of the first in
        its path's ascending set of distinct node ranks.  One sorted set of
        (path, rank) keys serves every path: both ranks of a pair lie in
        its path's run of keys, so their positions differ by one exactly
        when they do within the path's own set."""
        n = max(g.num_nodes, 1)
        keys = torch.unique(self.t(g.step_path.astype(np.int64)) * n
                            + self.t(handle_rank(g.step_handle)))
        ia = torch.searchsorted(keys, self.pp * n + self.ra)
        ib = torch.searchsorted(keys, self.pp * n + self.rb)
        return ib == ia + 1


def summary(g: GraphTensors) -> Dict[str, int]:
    """#length nodes edges paths steps."""
    return {
        "length": g.total_length,
        "nodes": g.num_nodes,
        "edges": g.num_edges,
        "paths": g.num_paths,
        "steps": g.num_steps,
    }


def base_content(g: GraphTensors, device=None) -> Dict[str, int]:
    """Counts of each base character, upper and lower case together."""
    dev = resolve_device(device)
    counts = torch.bincount(torch.as_tensor(g.seq, device=dev).to(torch.int64),
                            minlength=256).cpu().numpy()
    out = {}
    for ch in b"ACGTN":
        c = int(counts[ch]) + int(counts[ch + 32])
        if c:
            out[chr(ch)] = c
    return out


@dataclass
class MeanLinksLength:
    per_path_node_space: np.ndarray
    per_path_nt_space: np.ndarray
    per_path_2d: Optional[np.ndarray]
    per_path_num_links: np.ndarray
    per_path_num_gap_links: np.ndarray
    all_node_space: float
    all_nt_space: float
    all_2d: Optional[float]
    all_num_links: int
    all_num_gap_links: int


def mean_links_length(
    g: GraphTensors,
    xy=None,
    penalize_gap_links: bool = True,
    device=None,
) -> MeanLinksLength:
    """Mean links length in 1D (node and nt space) or, given `xy` = (X, Y)
    endpoint coordinates, in 2D.  In 1D a link leaves the end (the start
    if reverse) of its first node and enters the start (the end if
    reverse) of its second; its length is the distance between those rank
    boundaries.  Without `penalize_gap_links` the gap links (see
    `_Pairs.gap_links`) count as length 0."""
    dev = resolve_device(device)
    pr = _Pairs(g, dev)
    P = g.num_paths
    num_links = pr.count(torch.ones_like(pr.pp, dtype=torch.bool))
    gap = (pr.gap_links(g) if not penalize_gap_links
           else torch.zeros_like(pr.pp, dtype=torch.bool))
    use = ~gap
    num_gap_links = pr.count(gap)
    all_links = int(num_links.sum())

    if xy is not None:
        X, Y = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in xy)
        ia = 2 * pr.ra + pr.reva
        ib = 2 * pr.rb + pr.revb
        d = torch.where(use, torch.hypot(X[ia] - X[ib], Y[ia] - Y[ib]), 0.0)
        sum_2d = pr.per_path(d)
        with np.errstate(invalid="ignore", divide="ignore"):
            per_2d = np.where(num_links > 0, sum_2d / num_links, 0.0)
        return MeanLinksLength(
            per_path_node_space=np.zeros(P),
            per_path_nt_space=np.zeros(P),
            per_path_2d=per_2d,
            per_path_num_links=num_links,
            per_path_num_gap_links=num_gap_links,
            all_node_space=0.0,
            all_nt_space=0.0,
            all_2d=float(sum_2d.sum() / all_links) if all_links else 0.0,
            all_num_links=all_links,
            all_num_gap_links=int(num_gap_links.sum()),
        )

    pos_map = pr.t(g.seq_offset)
    info_a = pr.ra + (1 - pr.reva)
    info_b = pr.rb + pr.revb
    lo_i = torch.minimum(info_a, info_b)
    hi_i = torch.maximum(info_a, info_b)
    sum_node = pr.per_path(torch.where(use, hi_i - lo_i, 0))
    sum_nt = pr.per_path(torch.where(use, pos_map[hi_i] - pos_map[lo_i], 0))
    with np.errstate(invalid="ignore", divide="ignore"):
        per_node = np.where(num_links > 0, sum_node / num_links, 0.0)
        per_nt = np.where(num_links > 0, sum_nt / num_links, 0.0)
    return MeanLinksLength(
        per_path_node_space=per_node,
        per_path_nt_space=per_nt,
        per_path_2d=None,
        per_path_num_links=num_links,
        per_path_num_gap_links=num_gap_links,
        all_node_space=float(sum_node.sum() / all_links) if all_links else 0.0,
        all_nt_space=float(sum_nt.sum() / all_links) if all_links else 0.0,
        all_2d=None,
        all_num_links=all_links,
        all_num_gap_links=int(num_gap_links.sum()),
    )


@dataclass
class SumPathNodeDistances:
    per_path_node_space: np.ndarray
    per_path_nt_space: np.ndarray
    per_path_2d: Optional[np.ndarray]
    per_path_nodes: np.ndarray
    per_path_nucleotides: np.ndarray
    per_path_num_penalties: np.ndarray
    per_path_num_penalties_diff_orientation: np.ndarray
    all_node_space: float
    all_nt_space: float
    all_2d_by_nodes: Optional[float]
    all_2d_by_nucleotides: Optional[float]
    all_num_penalties: int
    all_num_penalties_diff_orientation: int


def sum_of_path_node_distances(
    g: GraphTensors,
    xy=None,
    penalize_diff_orientation: bool = False,
    device=None,
) -> SumPathNodeDistances:
    """Per consecutive step pair: node-space and nt-space distance between
    the two node starts, weighted 3x when the pair goes backward in rank
    order (optionally +2x on orientation flips), plus the end-of-path
    sentinel; normalized by path length in nodes and nucleotides.  With
    `xy` = (X, Y) endpoint coordinates: the Euclidean link lengths."""
    dev = resolve_device(device)
    P = g.num_paths
    pr = _Pairs(g, dev)
    ra, rb, per_path, count = pr.ra, pr.rb, pr.per_path, pr.count

    len_nodes = g.path_step_count.astype(np.int64)
    len_nt = g.path_length.astype(np.int64)
    diff_orient = pr.reva != pr.revb

    if xy is not None:
        X, Y = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in xy)
        ia = 2 * ra + pr.reva
        ib = 2 * rb + pr.revb
        d = torch.hypot(X[ia] - X[ib], Y[ia] - Y[ib])
        if penalize_diff_orientation:
            d = d + torch.where(diff_orient, 2.0 * d, 0.0)
        sum_2d = per_path(d)
        with np.errstate(invalid="ignore", divide="ignore"):
            per_2d = np.where(len_nodes > 0, sum_2d / len_nodes, 0.0)
        pen_d = count(diff_orient)
        tot_nodes, tot_nt = int(len_nodes.sum()), int(len_nt.sum())
        return SumPathNodeDistances(
            per_path_node_space=np.zeros(P),
            per_path_nt_space=np.zeros(P),
            per_path_2d=per_2d,
            per_path_nodes=len_nodes,
            per_path_nucleotides=len_nt,
            per_path_num_penalties=np.zeros(P, dtype=np.int64),
            per_path_num_penalties_diff_orientation=(
                pen_d if penalize_diff_orientation else np.zeros(P, dtype=np.int64)
            ),
            all_node_space=0.0,
            all_nt_space=0.0,
            all_2d_by_nodes=float(sum_2d.sum() / tot_nodes) if tot_nodes else 0.0,
            all_2d_by_nucleotides=float(sum_2d.sum() / tot_nt) if tot_nt else 0.0,
            all_num_penalties=0,
            all_num_penalties_diff_orientation=(
                int(pen_d.sum()) if penalize_diff_orientation else 0
            ),
        )

    pos_map = pr.t(g.seq_offset)
    backward = rb < ra
    lo_r = torch.minimum(ra, rb)
    hi_r = torch.maximum(ra, rb)
    w = torch.where(backward, 3, 1)
    node_span = hi_r - lo_r
    nt_span = pos_map[hi_r] - pos_map[lo_r]
    node_d = w * node_span
    nt_d = w * nt_span
    if penalize_diff_orientation:
        node_d = node_d + torch.where(diff_orient, 2 * node_span, 0)
        nt_d = nt_d + torch.where(diff_orient, 2 * nt_span, 0)
    sum_node = per_path(node_d)
    sum_nt = per_path(nt_d)
    # end-of-path sentinel: +1 node, +len(last node) nucleotides
    nonempty = len_nodes > 0
    sum_node = sum_node + nonempty
    last_len = np.zeros(P, dtype=np.int64)
    if g.num_steps:
        last_steps = g.path_offset[1:][nonempty] - 1
        last_len[nonempty] = g.node_len[handle_rank(g.step_handle[last_steps])]
    sum_nt = sum_nt + last_len

    pen = count(backward)
    pen_d = count(diff_orient)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_node = np.where(len_nodes > 0, sum_node / len_nodes, 0.0)
        per_nt = np.where(len_nt > 0, sum_nt / len_nt, 0.0)
    tot_nodes, tot_nt = int(len_nodes.sum()), int(len_nt.sum())
    return SumPathNodeDistances(
        per_path_node_space=per_node,
        per_path_nt_space=per_nt,
        per_path_2d=None,
        per_path_nodes=len_nodes,
        per_path_nucleotides=len_nt,
        per_path_num_penalties=pen,
        per_path_num_penalties_diff_orientation=(
            pen_d if penalize_diff_orientation else np.zeros(P, dtype=np.int64)
        ),
        all_node_space=float(sum_node.sum() / tot_nodes) if tot_nodes else 0.0,
        all_nt_space=float(sum_nt.sum() / tot_nt) if tot_nt else 0.0,
        all_2d_by_nodes=None,
        all_2d_by_nucleotides=None,
        all_num_penalties=int(pen.sum()),
        all_num_penalties_diff_orientation=(
            int(pen_d.sum()) if penalize_diff_orientation else 0
        ),
    )


def weighted_feedback_arcs(g: GraphTensors, device=None) -> Tuple[np.ndarray, int]:
    """Per-path and total weighted feedback arcs: path links whose steps
    are both forward with rank_a >= rank_b, or both reverse with
    rank_a <= rank_b."""
    pr = _Pairs(g, resolve_device(device))
    fwd = (pr.reva == 0) & (pr.revb == 0) & (pr.ra >= pr.rb)
    rev = (pr.reva == 1) & (pr.revb == 1) & (pr.ra <= pr.rb)
    per = pr.count(fwd | rev)
    return per, int(per.sum())


def weighted_reversing_joins(g: GraphTensors, device=None) -> Tuple[np.ndarray, int]:
    """Per-path and total strand-flipping links."""
    pr = _Pairs(g, resolve_device(device))
    per = pr.count(pr.reva != pr.revb)
    return per, int(per.sum())


def links_length_per_nuc(g: GraphTensors, device=None) -> Tuple[int, int]:
    """(total links length, total nucleotides of the steps): per link, the
    pangenomic gap between its out-side and in-side in four orientation
    cases; a gap link adds nothing in the forward/forward ascending case."""
    pr = _Pairs(g, resolve_device(device))
    pos, ln = pr.t(g.node_offset), pr.t(g.node_len)
    pa, pb = pos[pr.ra], pos[pr.rb]
    la, lb = ln[pr.ra], ln[pr.rb]
    asc = pr.ra <= pr.rb
    gap = pr.gap_links(g)
    fa, fb = pr.reva == 0, pr.revb == 0
    ra_, rb_ = ~fa, ~fb
    d = torch.zeros_like(pa)
    for mask, val in (
        (fa & fb & asc & ~gap, pb - (pa + la)),
        (fa & fb & ~asc, pa - pb + la),
        (fa & rb_ & asc, pb + lb - (pa + la)),
        (fa & rb_ & ~asc, pa - pb - lb + la),
        (ra_ & fb & asc, pb - pa),
        (ra_ & fb & ~asc, pa - pb + la + lb),
        (ra_ & rb_ & asc, pb - pa + la + lb),
        (ra_ & rb_ & ~asc, pa - (pb + lb)),
    ):
        d = torch.where(mask, val, d)
    total_nuc = int(ln[pr.t(handle_rank(g.step_handle))].sum())
    return int(d.sum()), total_nuc


def nondeterministic_edges(g: GraphTensors):
    """Rows (from, to) as '<id><+/->' strings: the edges out of one node
    side whose target nodes start with the same base."""
    adj = g.adjacency
    out = []
    for rank in range(g.num_nodes):
        nid = g.node_id[rank]
        for rev in (False, True):
            h = (rank << 1) | int(rev)
            by_base = {}
            for t in adj.neighbors(h):
                tr = int(t) >> 1
                trev = bool(int(t) & 1)
                base = g.node_seq_str(tr, trev)[0] if g.node_len[tr] else ""
                by_base.setdefault(base, []).append((int(g.node_id[tr]), trev))
            for tos in by_base.values():
                if len(tos) > 1:
                    for tid, trev in tos:
                        out.append((f"{nid}{'-' if rev else '+'}",
                                    f"{tid}{'-' if trev else '+'}"))
    return out


def pangenome_class_counts(g: GraphTensors, delim: str, sample_pos: int, device=None):
    """Per-sample core / private / shell nucleotides: the sample of a path
    is its name split by `delim` at `sample_pos` (the last part past the
    end); a node is private when one sample visits it, core when all do,
    shell otherwise, and adds its length to each visiting sample's class.
    Returns {sample: (core, private, shell)} in first-appearance order."""
    dev = resolve_device(device)
    samples = []
    sample_ids = {}
    path_sample = np.zeros(g.num_paths, dtype=np.int64)
    for p, name in enumerate(g.path_names):
        parts = name.split(delim)
        smp = parts[sample_pos] if sample_pos < len(parts) else parts[-1]
        if smp not in sample_ids:
            sample_ids[smp] = len(samples)
            samples.append(smp)
        path_sample[p] = sample_ids[smp]
    n_samples = len(samples)
    if n_samples == 0:
        return {}
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    # the distinct (node, sample) visits, as one key each
    visits = torch.unique(t(handle_rank(g.step_handle)) * n_samples
                          + t(path_sample)[t(g.step_path.astype(np.int64))])
    node, smp = visits // n_samples, visits % n_samples
    counts = torch.bincount(node, minlength=g.num_nodes)
    node_cls = torch.where(counts == 1, 0, torch.where(counts >= n_samples, 1, 2))
    cls = node_cls[node]
    w = t(g.node_len)[node].to(torch.float64)

    def acc(c):
        m = cls == c
        return torch.bincount(smp[m], weights=w[m], minlength=n_samples) \
            .cpu().numpy().astype(np.int64)

    priv, core, shell = acc(0), acc(1), acc(2)
    return {s: (int(core[i]), int(priv[i]), int(shell[i])) for i, s in enumerate(samples)}


def component_is_acyclic(g: GraphTensors, component: np.ndarray) -> bool:
    """Kahn sweep with orientation consistency (the reference's
    is_nice_and_acyclic): start from forward handles with no left edge;
    successors must always be reached in one orientation, and every node
    of the component must be consumed."""
    adj = g.adjacency

    def left_degree(handle: int) -> int:
        # going left from h = following right from flip(h)
        return len(adj.neighbors(handle ^ 1))

    comp = set(int(r) for r in component)
    indeg = {}
    orient = {}
    stack = []
    found = 0
    for r in comp:
        d = left_degree(r << 1)
        indeg[r] = d
        if d == 0:
            orient[r] = False
            stack.append(r << 1)
            found += 1
    while stack:
        h = stack.pop()
        for t in adj.neighbors(h):
            tr = int(t) >> 1
            trev = bool(int(t) & 1)
            if tr not in comp:
                continue
            if tr not in orient:
                orient[tr] = trev
                indeg[tr] = left_degree((tr << 1) | int(trev))
            elif orient[tr] != trev:
                return False
            indeg[tr] -= 1
            if indeg[tr] == 0:
                stack.append((tr << 1) | int(trev))
                found += 1
    return found == len(comp)


def unique_self_loop_nodes(g: GraphTensors, device=None) -> int:
    """Number of distinct nodes with a self loop."""
    dev = resolve_device(device)
    a = torch.as_tensor(handle_rank(g.edge_from), device=dev)
    b = torch.as_tensor(handle_rank(g.edge_to), device=dev)
    return int(torch.unique(a[a == b]).numel())
