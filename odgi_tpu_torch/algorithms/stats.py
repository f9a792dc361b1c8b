"""Sum of path node distances: the sort and layout quality metrics.

The counterpart of ``odgi_tpu/algorithms/stats.py``'s
``sum_of_path_node_distances``, computed with tensors on `device`:
gathers over the consecutive step pairs of every path and f64 per-path
sums.  Without coordinates it is the 1D sort metric (nt-distance, node
distance); with (X, Y) it is the 2D layout stress.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    ai, bi, pair_path = _consecutive_pairs(g)
    ha, hb = t(g.step_handle[ai]), t(g.step_handle[bi])
    ra, rb = ha >> 1, hb >> 1
    reva, revb = ha & 1, hb & 1
    pp = t(pair_path.astype(np.int64))

    len_nodes = g.path_step_count.astype(np.int64)
    len_nt = g.path_length.astype(np.int64)
    diff_orient = reva != revb

    def per_path(w):
        return torch.bincount(pp, weights=w.to(torch.float64), minlength=P)

    def count(mask):
        return torch.bincount(pp[mask], minlength=P).cpu().numpy().astype(np.int64)

    if xy is not None:
        X, Y = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in xy)
        ia = 2 * ra + reva
        ib = 2 * rb + revb
        d = torch.hypot(X[ia] - X[ib], Y[ia] - Y[ib])
        if penalize_diff_orientation:
            d = d + torch.where(diff_orient, 2.0 * d, 0.0)
        sum_2d = per_path(d).cpu().numpy()
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

    pos_map = t(g.seq_offset)
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
    sum_node = per_path(node_d).cpu().numpy()
    sum_nt = per_path(nt_d).cpu().numpy()
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
