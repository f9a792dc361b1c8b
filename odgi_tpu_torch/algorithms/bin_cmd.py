"""Pangenome binning (reference: src/algorithms/bin_path_info.{hpp,cpp},
command src/subcommand/bin_main.cpp).

Chops the pangenome sequence (nodes in sort order) into fixed-width bins
and aggregates, per path and per bin: mean depth, mean inversion rate,
mean normalized path position, and the covered nucleotide ranges.  This
is the data model behind `odgi viz` and `odgi bin`.

The reference walks every base of every path in a scalar loop
(bin_path_info.cpp:85-135).  Here each path expands to flat per-base
arrays (bin id, orientation, path position) and the aggregation is
bincount/segment work; range records are run-break detection.

Host code (Python and numpy): a copy of ``odgi_tpu/algorithms/bin_cmd.py``
with the same results.  It imports nothing of ``odgi_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..core.graph import GraphTensors, _ranges_gather_index


@dataclass
class PathBinInfo:
    mean_depth: float
    mean_inv: float
    mean_pos: float
    ranges: List[Tuple[int, int]]


def _fmt(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    s = f"{x:.6g}"
    return s


def path_bins(
    g: GraphTensors,
    path_idx: int,
    bin_width: int,
    position_map: np.ndarray,
) -> Tuple[Dict[int, PathBinInfo], List[Tuple[int, int]]]:
    """Per-bin aggregation + bin-crossing links for one path
    (bin_path_info.cpp:70-140)."""
    lo, hi = int(g.path_offset[path_idx]), int(g.path_offset[path_idx + 1])
    handles = g.step_handle[lo:hi]
    ranks = (handles >> 1).astype(np.int64)
    revs = (handles & 1).astype(bool)
    lens = g.node_len[ranks]
    L = int(lens.sum())
    if L == 0:
        return {}, [(0, 0)]

    # per-base arrays in path order
    starts = position_map[ranks]
    base_pan = _ranges_gather_index(starts, lens)  # pangenome offset per base
    base_rev = np.repeat(revs, lens)
    base_bin = base_pan // bin_width + 1  # 1-based bin ids
    path_pos = np.arange(L, dtype=np.int64)  # 0-based path position per base
    nuc = path_pos + 1  # reference's 1-based nucleotide_count

    # links: crossings where |bin - last_bin| > 1, plus the initial
    # (0, first) and final (last, 0) records
    links: List[Tuple[int, int]] = [(0, int(base_bin[0]))]
    if L > 1:
        d = base_bin[1:] - base_bin[:-1]
        jumps = np.nonzero(np.abs(d) > 1)[0]
        for j in jumps.tolist():
            links.append((int(base_bin[j]), int(base_bin[j + 1])))
    links.append((int(base_bin[-1]), 0))

    # per-bin aggregates
    uniq_bins, inv = np.unique(base_bin, return_inverse=True)
    count = np.bincount(inv)
    inv_count = np.bincount(inv, weights=base_rev.astype(np.float64))
    pos_sum = np.bincount(inv, weights=path_pos.astype(np.float64))

    # ranges: a new range starts on a bin change, a nucleotide gap > 1
    # within the bin, or an orientation flip (bin_path_info.cpp:104-131).
    # Since nuc increments by 1 along the path, within one bin a range is
    # a maximal run of consecutive bases with constant orientation.
    new_range = np.ones(L, dtype=bool)
    if L > 1:
        same = (base_bin[1:] == base_bin[:-1]) & (base_rev[1:] == base_rev[:-1])
        new_range[1:] = ~same
    # but also: revisiting a bin after leaving breaks the run anyway since
    # base_bin changes; runs are over consecutive base positions.
    run_starts = np.nonzero(new_range)[0]
    run_ends = np.append(run_starts[1:], L) - 1  # inclusive

    bins: Dict[int, PathBinInfo] = {}
    for b_i, b in enumerate(uniq_bins.tolist()):
        cnt = float(count[b_i])
        mean_inv = float(inv_count[b_i]) / (cnt if cnt else 1.0)
        mean_depth = cnt / bin_width
        mean_pos = (
            float(pos_sum[b_i]) / (bin_width * L * mean_depth) if cnt else 0.0
        )
        bins[int(b)] = PathBinInfo(mean_depth, mean_inv, mean_pos, [])

    for s, e in zip(run_starts.tolist(), run_ends.tolist()):
        b = int(base_bin[s])
        first_nuc, last_nuc = int(nuc[s]), int(nuc[e])
        if base_rev[s]:
            # reverse runs record (end, start); single-base runs (nuc, 0)
            pair = (last_nuc, first_nuc) if e > s else (first_nuc, 0)
        else:
            pair = (first_nuc, last_nuc) if e > s else (0, first_nuc)
        bins[b].ranges.append(pair)
    return bins, links


def drop_gap_links(
    bins: Dict[int, PathBinInfo], links: List[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """Remove start/end links and forward links that skip no occupied bin
    (bin_path_info.cpp:146-176)."""
    bin_ids = np.asarray(sorted(bins.keys()), dtype=np.int64)
    kept = []
    for a, b in links:
        if a == 0 or b == 0:
            continue
        if a > b:
            kept.append((a, b))
            continue
        left = np.searchsorted(bin_ids, a + 1, side="left")
        right = np.searchsorted(bin_ids, b, side="left")
        if right > left:
            kept.append((a, b))
    return kept


def bin_path_info_cmd(
    g: GraphTensors,
    out: TextIO,
    num_bins: int = 0,
    bin_width: int = 0,
    path_delim: str = "",
    aggregate_delim: bool = False,
    json_out: bool = False,
    no_seqs: bool = False,
    no_gap_links: bool = False,
) -> None:
    """Drive binning with the reference's TSV/JSON output formats
    (bin_main.cpp:144-275).  ODGI pseudo-JSON version 12."""
    # pangenome sequence order = node rank order
    position_map = g.node_offset if g.num_nodes else np.zeros(0, np.int64)
    length = int(g.total_length)
    if not num_bins:
        num_bins = length // bin_width + (1 if length % bin_width else 0)
    elif not bin_width:
        bin_width = length // num_bins
        num_bins = length // bin_width + (1 if length % bin_width else 0)

    def prefix(name: str) -> str:
        if aggregate_delim or not path_delim:
            return "NA"
        return name.split(path_delim)[0]

    def suffix(name: str) -> str:
        if aggregate_delim or not path_delim:
            return "NA"
        i = name.find(path_delim)
        return name[i + 1 :]

    if json_out:
        out.write(
            '{"odgi_version": 12,"bin_width": %d,"pangenome_length": %d}\n'
            % (bin_width, length)
        )
        full_seq = g.seq.tobytes().decode("ascii")
        for i in range(num_bins):
            s = full_seq[i * bin_width : (i + 1) * bin_width]
            if no_seqs:
                out.write('{"bin_id":%d}\n' % (i + 1))
            else:
                out.write('{"bin_id":%d,"sequence":"%s"}\n' % (i + 1, s))
    else:
        out.write(
            "path.name\tpath.prefix\tpath.suffix\tbin\tmean.cov\tmean.inv\t"
            "mean.pos\tfirst.nucl\tlast.nucl\n"
        )

    for p in range(g.num_paths):
        name = g.path_names[p]
        bins, links = path_bins(g, p, bin_width, position_map)
        if no_gap_links:
            links = drop_gap_links(bins, links)
        if json_out:
            parts = ['{"path_name":"%s",' % name]
            if path_delim:
                parts.append(
                    '"path_name_prefix":"%s","path_name_suffix":"%s",'
                    % (prefix(name), suffix(name))
                )
            parts.append('"bins":[')
            items = []
            for b in sorted(bins):
                info = bins[b]
                rng = ",".join("[%d,%d]" % r for r in info.ranges)
                items.append(
                    "[%d,%s,%s,%s,[%s]]"
                    % (b, _fmt(info.mean_depth), _fmt(info.mean_inv), _fmt(info.mean_pos), rng)
                )
            parts.append(",".join(items))
            parts.append('],"links":[')
            parts.append(",".join("[%d,%d]" % l for l in links))
            parts.append("]}\n")
            out.write("".join(parts))
        else:
            for b in sorted(bins):
                info = bins[b]
                if info.mean_depth > 0:
                    last = info.ranges[-1][1] if info.ranges[-1][1] != 0 else info.ranges[-1][0]
                    out.write(
                        "%s\t%s\t%s\t%d\t%s\t%s\t%s\t%d\t%d\n"
                        % (
                            name,
                            prefix(name),
                            suffix(name),
                            b,
                            _fmt(info.mean_depth),
                            _fmt(info.mean_inv),
                            _fmt(info.mean_pos),
                            info.ranges[0][0],
                            last,
                        )
                    )
