"""The ``paths`` subcommand's exports: FASTA, the haplotype matrix, the
non-reference nodes and ranges, the coverage and fraction sequence classes
and the pairwise overlaps; ``flatten``; and the path x path Jaccard matrix
of ``similarity``.

Host code (Python and numpy), a copy of ``odgi_tpu/algorithms/paths_cmd.py``
with the same output.
"""

from __future__ import annotations

from typing import Optional, TextIO, Tuple

import numpy as np

from ..core.graph import GraphTensors, handle_is_reverse, handle_rank


def path_sequence(g: GraphTensors, p: int) -> bytes:
    lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
    return b"".join(
        g.node_seq(int(h) >> 1, bool(h & 1)) for h in g.step_handle[lo:hi]
    )


def write_fasta(g: GraphTensors, out: TextIO, line_width: int = 0) -> None:
    """FASTA export (reference: paths_main.cpp:191-223): one line per
    sequence by default; wrap at `line_width` when nonzero."""
    for p in range(g.num_paths):
        out.write(f">{g.path_names[p]}\n")
        seq = path_sequence(g, p).decode()
        if line_width <= 0:
            out.write(seq + "\n")
        else:
            for i in range(0, len(seq), line_width):
                out.write(seq[i : i + line_width] + "\n")
            if not seq:
                out.write("\n")


def haplotype_matrix(
    g: GraphTensors,
    scale_by_length: bool = False,
    group_delim: Optional[str] = None,
) -> Tuple[list, np.ndarray, np.ndarray, np.ndarray]:
    """(row_names, path_length, path_steps, coverage[P', N]) — the -H
    matrix (reference: paths_main.cpp:57-79): per path (or per group when
    `group_delim` given) coverage count of every node in rank order,
    optionally multiplied by node length."""
    ranks = handle_rank(g.step_handle)
    P, N = g.num_paths, g.num_nodes
    if group_delim is None:
        row_of_path = np.arange(P)
        row_names = list(g.path_names)
    else:
        names = [n.split(group_delim)[0] for n in g.path_names]
        row_names = sorted(set(names))
        idx = {n: i for i, n in enumerate(row_names)}
        row_of_path = np.array([idx[n] for n in names])
    R = len(row_names)
    flat = row_of_path[g.step_path] * N + ranks
    cov = np.bincount(flat, minlength=R * N).reshape(R, N).astype(np.int64)
    if scale_by_length:
        cov = cov * g.node_len[None, :]
    lengths = np.zeros(R, dtype=np.int64)
    steps = np.zeros(R, dtype=np.int64)
    np.add.at(lengths, row_of_path, g.path_length)
    np.add.at(steps, row_of_path, g.path_step_count)
    return row_names, lengths, steps, cov


def write_haplotype_matrix(g: GraphTensors, out: TextIO, **kwargs) -> None:
    names, lengths, steps, cov = haplotype_matrix(g, **kwargs)
    header = ["path.name", "path.length", "path.step.count"] + [
        f"node.{int(i)}" for i in g.node_id
    ]
    out.write("\t".join(header) + "\n")
    for r, name in enumerate(names):
        row = [name, str(int(lengths[r])), str(int(steps[r]))]
        row += [str(int(v)) for v in cov[r]]
        out.write("\t".join(row) + "\n")


def flatten(
    g: GraphTensors, fasta_out: TextIO, bed_out: TextIO, name: str = "flattened"
) -> None:
    """`odgi flatten`: the FASTA of the node sequences concatenated in rank
    order, and one BED row a path step placing it there."""
    fasta_out.write(f">{name}\n")
    seq = g.seq.tobytes().decode()
    for i in range(0, len(seq), 80):
        fasta_out.write(seq[i : i + 80] + "\n")
    bed_out.write("#name\tstart\tend\tpath\tstrand\tstep.rank\n")
    ranks = handle_rank(g.step_handle)
    revs = handle_is_reverse(g.step_handle)
    starts = g.node_offset[ranks]
    ends = starts + g.node_len[ranks]
    sp = g.step_path
    sr = g.step_rank
    for k in range(g.num_steps):
        bed_out.write(
            f"{name}\t{int(starts[k])}\t{int(ends[k])}\t"
            f"{g.path_names[sp[k]]}\t{'-' if revs[k] else '+'}\t{int(sr[k])}\n"
        )


def path_jaccard_matrix(g: GraphTensors) -> np.ndarray:
    """f64[P, P] pairwise path similarity over covered node bp
    (reference: src/subcommand/similarity_main.cpp — sparse path x path
    jaccard/overlap over shared nodes, weighted by node length)."""
    P, N = g.num_paths, g.num_nodes
    ranks = handle_rank(g.step_handle)
    flat = g.step_path.astype(np.int64) * N + ranks
    touched = np.zeros(P * N, dtype=bool)
    touched[flat] = True
    touched = touched.reshape(P, N)
    w = g.node_len.astype(np.float64)
    tw = touched * w  # (P, N) bp touched
    inter = tw @ touched.T  # shared bp
    sizes = tw.sum(axis=1)
    union = sizes[:, None] + sizes[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        jac = np.where(union > 0, inter / union, 0.0)
    return jac


def group_identified_pos(path_name: str, delim: str, delim_pos: int):
    """(occurrence_count, char_pos) of the delim_pos-th delimiter
    (reference: paths_main.cpp:226-241); falls back to the last occurrence
    when there are too few."""
    pos = -1
    cnt = -1
    while cnt != delim_pos:
        pos += 1
        cur = path_name.find(delim, pos)
        if cur == -1:
            return cnt, pos - 1
        pos = cur
        cnt += 1
    return cnt, pos


def sample_of_path(name: str, delim, delim_pos: int) -> str:
    if not delim:
        return name
    cnt, pos = group_identified_pos(name, delim, delim_pos)
    if cnt < 0:
        raise SystemExit(
            f"[odgi::paths] error: path name '{name}' has not occurrences "
            f"of '{delim}'."
        )
    return name[:pos]


def non_reference_nodes_rows(g, ref_paths, min_size: int = 0):
    """Rows (node.id, node.len, num.uncalled.bases, paths_csv) for nodes
    untouched by the reference paths (reference: paths_main.cpp:461-505)."""
    ref = np.zeros(g.num_nodes, dtype=bool)
    if min_size:
        keep = g.node_len >= min_size
    else:
        keep = np.ones(g.num_nodes, dtype=bool)
    for p in ref_paths:
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        ref[handle_rank(g.step_handle[lo:hi])] = True
    ranks = handle_rank(g.step_handle)
    rows = []
    for r in np.nonzero(keep & ~ref)[0]:
        paths_here = sorted(set(int(t) for t in g.step_path[ranks == r]))
        seq = g.node_seq(int(r))
        n_count = seq.count(b"N") + seq.count(b"n")
        rows.append(
            (
                int(g.node_id[r]),
                int(g.node_len[r]),
                n_count,
                ",".join(g.path_names[t] for t in paths_here),
            )
        )
    return rows


def non_reference_ranges_rows(
    g, ref_paths, min_size: int = 0, show_steps: bool = False
):
    """BED rows of path ranges not covered by reference-path nodes
    (reference: paths_main.cpp:507-596)."""
    ref_nodes = np.zeros(g.num_nodes, dtype=bool)
    for p in ref_paths:
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        ref_nodes[handle_rank(g.step_handle[lo:hi])] = True
    refset = set(ref_paths)
    rows = []
    for p in range(g.num_paths):
        if p in refset:
            continue
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        start = end = 0
        steps = []
        for s in range(lo, hi):
            h = int(g.step_handle[s])
            r = h >> 1
            ln = int(g.node_len[r])
            if ref_nodes[r]:
                if end > start and (end - start) >= min_size:
                    rows.append(_nr_row(g, p, start, end, steps, show_steps))
                end += ln
                start = end
                steps = []
            else:
                end += ln
            if show_steps:
                steps.append(h)
        if end > start and (end - start) >= min_size:
            rows.append(_nr_row(g, p, start, end, steps, show_steps))
    return rows


def _nr_row(g, p, start, end, steps, show_steps):
    row = [g.path_names[p], start, end]
    if show_steps:
        row.append(
            ",".join(
                f"{int(g.node_id[h >> 1])}{'-' if h & 1 else '+'}"
                for h in steps
            )
        )
    return tuple(row)


def _fmt_level(v: float) -> str:
    """to_string_custom: trim trailing zeros (reference: utils.cpp)."""
    s = f"{v:.6f}".rstrip("0").rstrip(".")
    return s if s else "0"


def _class_label(i: int, levels, symbol: str) -> str:
    if i == 0:
        return f"{symbol}<{_fmt_level(levels[0])}"
    if i == len(levels) - 1:
        return f"{symbol}>={_fmt_level(levels[i])}"
    return f"{_fmt_level(levels[i])}<={symbol}<{_fmt_level(levels[i + 1])}"


def sequence_class_tables(
    g,
    levels,
    fraction: bool,
    delim=None,
    delim_pos: int = 0,
    min_size: int = 0,
    path_ranges: bool = False,
    show_steps: bool = False,
):
    """Coverage/fraction sequence classes (reference: paths_main.cpp:
    598-788): classify nodes by the number (or fraction) of distinct
    samples visiting them against sorted thresholds (first threshold
    duplicated for the below-minimum class), then emit either the node
    table or per-path class ranges."""
    sorted_levels = sorted(levels)
    sorted_levels.insert(0, sorted_levels[0])
    symbol = "f" if fraction else "c"
    samples = [
        sample_of_path(g.path_names[p], delim, delim_pos)
        for p in range(g.num_paths)
    ]
    sample_ids = {s: i for i, s in enumerate(dict.fromkeys(samples))}
    path_sample = np.array([sample_ids[s] for s in samples], dtype=np.int64)
    n_samples = len(sample_ids)
    ranks = handle_rank(g.step_handle)
    pairs = np.unique(
        np.stack([ranks, path_sample[g.step_path]], axis=1), axis=0
    )
    counts = np.bincount(pairs[:, 0], minlength=g.num_nodes).astype(np.float64)
    value = counts / n_samples if fraction else counts
    # highest matching threshold wins; class 0 = below the minimum level
    node_class = np.zeros(g.num_nodes, dtype=np.int64)
    for i in range(1, len(sorted_levels)):
        node_class[value >= sorted_levels[i]] = i

    if not path_ranges:
        rows = []
        for r in range(g.num_nodes):
            if int(g.node_len[r]) >= min_size:
                rows.append(
                    (
                        int(g.node_id[r]),
                        int(g.node_len[r]),
                        _class_label(int(node_class[r]), sorted_levels, symbol),
                    )
                )
        return ("#node.id\tnode.len\tclass", rows)

    hdr = "#path.name\tstart\tend\tclass"
    if show_steps:
        hdr += "\tsteps"
    rows = []
    for p in range(g.num_paths):
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        start = end = 0
        last_class = -1
        steps = []
        for s in range(lo, hi):
            h = int(g.step_handle[s])
            r = h >> 1
            cur = int(node_class[r])
            if last_class != -1 and last_class != cur:
                if end > start and (end - start) >= min_size:
                    row = [
                        g.path_names[p], start, end,
                        _class_label(last_class, sorted_levels, symbol),
                    ]
                    if show_steps:
                        row.append(
                            ",".join(
                                f"{int(g.node_id[x >> 1])}{'-' if x & 1 else '+'}"
                                for x in steps
                            )
                        )
                    rows.append(tuple(row))
                start = end
                end += int(g.node_len[r])
                steps = []
            else:
                end += int(g.node_len[r])
            if show_steps:
                steps.append(h)
            last_class = cur
        if end > start and (end - start) >= min_size and last_class >= 0:
            row = [
                g.path_names[p], start, end,
                _class_label(last_class, sorted_levels, symbol),
            ]
            if show_steps:
                row.append(
                    ",".join(
                        f"{int(g.node_id[x >> 1])}{'-' if x & 1 else '+'}"
                        for x in steps
                    )
                )
            rows.append(tuple(row))
    return (hdr, rows)


def overlaps_table(g, grouping_rows):
    """Pairwise base-level overlap within path groups (reference:
    paths_main.cpp:300-380 -O/--overlaps): per group, for each path pair,
    the number of shared (node, offset, strand) positions and that count
    over the mean path length."""
    def decomposition(p):
        lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
        out = set()
        for s in range(lo, hi):
            h = int(g.step_handle[s])
            r = h >> 1
            for i in range(int(g.node_len[r])):
                out.add((int(g.node_id[r]), i, h & 1))
        return out

    rows = []
    for group_name, names in grouping_rows:
        ps = [g.path_names.index(n) for n in names]
        decos = {p: decomposition(p) for p in ps}
        for i in range(len(ps)):
            for j in range(i + 1, len(ps)):
                v1, v2 = decos[ps[i]], decos[ps[j]]
                inter = len(v1 & v2)
                rows.append(
                    (
                        group_name, names[i], names[j], inter,
                        inter / ((len(v1) + len(v2)) / 2.0),
                    )
                )
    return rows
