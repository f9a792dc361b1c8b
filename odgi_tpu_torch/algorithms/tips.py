"""Path tip -> reference breakpoint mapping (reference:
src/algorithms/tips.{hpp,cpp} + tips_bed_writer_thread.hpp, `odgi tips`).

For each query path, walk inward from its front (and back) until a node
visited by the target path is reached, then rank the target's steps on
that node by Jaccard context similarity and report BED records.

Host code (Python and numpy): a copy of ``odgi_tpu/algorithms/tips.py``
with the same results.  It imports nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set, TextIO, Tuple

import numpy as np

from ..core.graph import GraphTensors
from .path_jaccard import jaccard_indices_from_steps


def walk_tips(
    g: GraphTensors,
    out: TextIO,
    query_paths: Optional[List[int]] = None,
    target_paths: Optional[List[int]] = None,
    n_best: int = 1,
    walking_dist: int = 10000,
    report_additional_jaccards: bool = False,
    not_visited_out: Optional[TextIO] = None,
) -> None:
    """Emit BED records `target chromStart chromEnd query query_pos jaccard
    walking_dir [extra_jaccards|.]` (tips_bed_writer_thread.hpp:48-75;
    jaccard printed with fixed 3 decimals)."""
    all_paths = list(range(g.num_paths))
    if query_paths is None:
        query_paths = all_paths
    if target_paths is None:
        target_paths = all_paths

    # steps sorted by node rank, for for_each_step_on_handle
    order = np.argsort(g.step_handle >> 1, kind="stable")
    sorted_nodes = (g.step_handle[order] >> 1).astype(np.int64)
    node_off = np.searchsorted(sorted_nodes, np.arange(g.num_nodes + 1))

    def steps_on_node(r: int) -> np.ndarray:
        return order[node_off[r] : node_off[r + 1]]

    for target in target_paths:
        t_lo, t_hi = int(g.path_offset[target]), int(g.path_offset[target + 1])
        on_target = np.zeros(g.num_nodes, dtype=bool)
        on_target[(g.step_handle[t_lo:t_hi] >> 1)] = True
        target_name = g.path_names[target]
        not_visited: Set[str] = set()
        for from_front in (True, False):
            for q in query_paths:
                if q == target:
                    continue
                qname = g.path_names[q]
                if not from_front and qname in not_visited:
                    continue
                q_lo, q_hi = int(g.path_offset[q]), int(g.path_offset[q + 1])
                if q_hi == q_lo:
                    not_visited.add(qname)
                    continue
                rng = (
                    range(q_lo, q_hi) if from_front else range(q_hi - 1, q_lo - 1, -1)
                )
                hit = None
                for s in rng:
                    r = int(g.step_handle[s]) >> 1
                    if on_target[r]:
                        hit = s
                        break
                if hit is None:
                    not_visited.add(qname)
                    continue
                r = int(g.step_handle[hit]) >> 1
                tsteps = [
                    int(s)
                    for s in steps_on_node(r)
                    if int(g.step_path[s]) == target
                ]
                ranked = jaccard_indices_from_steps(g, walking_dist, hit, tsteps)
                extras = (
                    [j for _, j in ranked[n_best:]]
                    if report_additional_jaccards
                    else []
                )
                for s, jac in ranked[:n_best]:
                    t_min = int(g.step_pos[s])
                    t_max = t_min + int(g.node_len[int(g.step_handle[s]) >> 1])
                    q_pos = int(g.step_pos[hit])
                    extra_col = (
                        ",".join(f"{e:.3f}" for e in extras) if extras else "."
                    )
                    out.write(
                        f"{target_name}\t{t_min}\t{t_max}\t{qname}\t{q_pos}\t"
                        f"{jac:.3f}\t{int(from_front)}\t{extra_col}\n"
                    )
        if not_visited_out is not None:
            for nv in sorted(not_visited):
                not_visited_out.write(f"{target_name}\t{nv}\n")
