"""Further analytics: kmers, tension, adjacency matrix, heaps, pav.

Reference commands covered: `odgi kmers` (src/algorithms/kmer.{hpp,cpp}),
`odgi tension` (src/subcommand/tension_main.cpp:25-34 — per node, the sum
over visiting step pairs of layout-distance / nucleotide-distance),
`odgi matrix` (src/algorithms/matrix_writer.{hpp,cpp}), `odgi heaps`
(src/algorithms/heaps.{hpp,cpp} — pangenome growth curves over random
permutations of path groups), `odgi pav` (src/subcommand/pav_main.cpp —
presence/absence over BED windows).

Host code (Python and numpy): a copy of
``odgi_tpu/algorithms/analytics.py`` with the same results.  It imports
nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_is_reverse, handle_rank
from .paths_cmd import path_sequence


def path_kmers(g: GraphTensors, k: int) -> Dict[bytes, int]:
    """Count all k-mers over every embedded path's sequence."""
    counts: Dict[bytes, int] = {}
    for p in range(g.num_paths):
        seq = path_sequence(g, p)
        for i in range(len(seq) - k + 1):
            km = seq[i : i + k]
            counts[km] = counts.get(km, 0) + 1
    return counts


def write_kmers(g: GraphTensors, k: int, out: TextIO) -> None:
    for km, c in sorted(path_kmers(g, k).items()):
        out.write(f"{km.decode()}\t{c}\n")


def node_tension(g: GraphTensors, coords: np.ndarray) -> np.ndarray:
    """f64[N]: per node, sum over adjacent step pairs touching it of
    (layout distance / nucleotide distance) (reference:
    tension_main.cpp:25-34)."""
    from .stats import _consecutive_pairs

    ai, bi, _ = _consecutive_pairs(g)
    ha, hb = g.step_handle[ai], g.step_handle[bi]
    ra, rb = handle_rank(ha), handle_rank(hb)
    ia = 2 * ra + handle_is_reverse(ha)
    ib = 2 * rb + handle_is_reverse(hb)
    lay_d = np.hypot(
        coords[ia, 0] - coords[ib, 0], coords[ia, 1] - coords[ib, 1]
    )
    nt_d = np.abs(g.step_pos[ai] - g.step_pos[bi]).astype(np.float64)
    ratio = lay_d / np.maximum(nt_d, 1.0)
    out = np.zeros(g.num_nodes, dtype=np.float64)
    np.add.at(out, ra, ratio)
    np.add.at(out, rb, ratio)
    return out


def write_matrix(g: GraphTensors, out: TextIO, weight_by_paths: bool = False) -> None:
    """Sparse adjacency triples `from_id to_id weight`
    (reference: matrix_writer.cpp)."""
    if weight_by_paths:
        from .stats import _consecutive_pairs

        ai, bi, _ = _consecutive_pairs(g)
        ra = handle_rank(g.step_handle[ai])
        rb = handle_rank(g.step_handle[bi])
        pairs, counts = np.unique(
            np.stack([ra, rb], axis=1), axis=0, return_counts=True
        )
        for (a, b), c in zip(pairs, counts):
            out.write(f"{int(g.node_id[a])}\t{int(g.node_id[b])}\t{int(c)}\n")
    else:
        for a, b in zip(g.edge_from, g.edge_to):
            out.write(
                f"{int(g.node_id[int(a) >> 1])}\t{int(g.node_id[int(b) >> 1])}\t1\n"
            )




def _masked_len_view(g: GraphTensors, keep: np.ndarray) -> GraphTensors:
    """A shallow variant of g whose node_len is zeroed outside `keep`,
    so growth curves count only the kept nodes' bp."""
    import dataclasses

    nl = np.where(keep, g.node_len, 0)
    return dataclasses.replace(g, node_len=nl.astype(g.node_len.dtype))

def heaps_permutations(
    g: GraphTensors,
    n_permutations: int = 100,
    group_delim: Optional[str] = None,
    seed: int = 9399220,
    path_groups: Optional[Sequence[str]] = None,
    mask_ranks: Optional[np.ndarray] = None,
    min_depth: int = 0,
) -> np.ndarray:
    """Pangenome growth curves (reference: heaps.cpp:7-60): for each random
    permutation of path groups, the cumulative bp of newly covered nodes as
    each group is added.  `path_groups` = explicit group label per path
    (-p/-S/-H); `mask_ranks` restricts the counted nodes (-b BED
    targets); `min_depth` counts only nodes with at least that path
    depth (-d).  Returns i64[n_permutations, n_groups]."""
    if min_depth or mask_ranks is not None:
        keep = np.ones(g.num_nodes, dtype=bool)
        if mask_ranks is not None:
            keep[:] = False
            keep[np.asarray(mask_ranks, np.int64)] = True
        if min_depth:
            depth = np.bincount(
                handle_rank(g.step_handle), minlength=g.num_nodes
            )
            keep &= depth >= min_depth
        g = _masked_len_view(g, keep)
    if path_groups is not None:
        names = list(path_groups)
        uniq = sorted(set(names))
        idx = {n: i for i, n in enumerate(uniq)}
        group_of_path = np.array([idx[n] for n in names])
        groups = list(range(len(uniq)))
    elif group_delim is None:
        groups = list(range(g.num_paths))
        group_of_path = np.arange(g.num_paths)
    else:
        names = [n.split(group_delim)[0] for n in g.path_names]
        uniq = sorted(set(names))
        idx = {n: i for i, n in enumerate(uniq)}
        group_of_path = np.array([idx[n] for n in names])
        groups = list(range(len(uniq)))
    ng = len(groups)
    N = g.num_nodes
    # per group: bool coverage vector
    ranks = handle_rank(g.step_handle)
    cov = np.zeros((ng, N), dtype=bool)
    cov[group_of_path[g.step_path], ranks] = True
    w = g.node_len.astype(np.int64)
    rng = np.random.default_rng(seed)
    out = np.zeros((n_permutations, ng), dtype=np.int64)
    for t in range(n_permutations):
        perm = rng.permutation(ng)
        seen = np.zeros(N, dtype=bool)
        for k, gi in enumerate(perm):
            new = cov[gi] & ~seen
            seen |= cov[gi]
            out[t, k] = (out[t, k - 1] if k else 0) + int(w[new].sum())
    return out


def pav_table(
    g: GraphTensors,
    ref_path: int,
    intervals: Sequence[Tuple[int, int]],
    group_delim: Optional[str] = None,
    path_groups: Optional[Sequence[str]] = None,
) -> Tuple[List[str], np.ndarray]:
    """Presence/absence over BED intervals of a reference path
    (reference: pav_main.cpp): for each interval, for each path (or group),
    the fraction of the interval's node-bp that the path covers.

    `path_groups` gives an explicit group label per path (reference
    -p/-S/-H groupings); `group_delim` is the first-field shorthand.
    Returns (column names, f64[n_intervals, n_columns])."""
    lo, hi = int(g.path_offset[ref_path]), int(g.path_offset[ref_path + 1])
    ranks = handle_rank(g.step_handle[lo:hi])
    starts = g.step_pos[lo:hi]
    lens = g.node_len[ranks].astype(np.int64)

    if path_groups is not None:
        names = list(path_groups)
        cols = sorted(set(names))
        idx = {n: i for i, n in enumerate(cols)}
        col_of_path = np.array([idx[n] for n in names])
    elif group_delim is None:
        cols = list(g.path_names)
        col_of_path = np.arange(g.num_paths)
    else:
        names = [n.split(group_delim)[0] for n in g.path_names]
        cols = sorted(set(names))
        idx = {n: i for i, n in enumerate(cols)}
        col_of_path = np.array([idx[n] for n in names])
    C, N = len(cols), g.num_nodes
    cov = np.zeros((C, N), dtype=bool)
    cov[col_of_path[g.step_path], handle_rank(g.step_handle)] = True

    out = np.zeros((len(intervals), C), dtype=np.float64)
    for i, (a, b) in enumerate(intervals):
        sel = (starts + lens > a) & (starts < b)
        if not sel.any():
            continue
        r = ranks[sel]
        overlap = (
            np.minimum(starts[sel] + lens[sel], b) - np.maximum(starts[sel], a)
        ).astype(np.float64)
        denom = overlap.sum()
        if denom <= 0:
            continue
        out[i] = (cov[:, r] * overlap[None, :]).sum(axis=1) / denom
    return cols, out


def for_each_graph_kmer(g: GraphTensors, k: int, max_furcations: int = 0):
    """Yield (seq, node_id, is_rev, offset) for every graph kmer: from
    every position of every handle in both orientations, extending across
    edges, stopping branches beyond `max_furcations` forks
    (reference: src/algorithms/kmer.cpp:8-103 for_each_kmer; line format
    of kmers_main -c is seq TAB id:[-]offset TAB)."""
    adj = g.adjacency
    for r in range(g.num_nodes):
        for rev in (False, True):
            h = (r << 1) | int(rev)
            seq = g.node_seq(r, rev)
            L = len(seq)
            for i in range(L):
                # (acc_seq, current_handle, forks); extend until k bases
                frontier = [(seq[i : min(L, i + k)], h, 0)]
                while frontier:
                    acc, cur, forks = frontier.pop()
                    if len(acc) >= k:
                        yield (
                            acc[:k],
                            int(g.node_id[r]),
                            rev,
                            i,
                        )
                        continue
                    nexts = adj.neighbors(cur)
                    if len(nexts) > 1:
                        if max_furcations and forks >= max_furcations:
                            continue
                        forks_next = forks + 1
                    else:
                        forks_next = forks
                    for t in nexts:
                        tr, trev = int(t) >> 1, bool(int(t) & 1)
                        ts = g.node_seq(tr, trev)
                        frontier.append(
                            (acc + ts[: k - len(acc)], int(t), forks_next)
                        )


def write_graph_kmers(
    g: GraphTensors, k: int, out: TextIO, max_furcations: int = 0
) -> None:
    for seq, nid, rev, off in for_each_graph_kmer(g, k, max_furcations):
        out.write(f"{seq.decode()}\t{nid}:{'-' if rev else ''}{off}\t\n")
