"""Position, range and path-subset arguments of ``depth`` and ``degree``
(the counterpart of ``odgi_tpu/cli/region.py``): graph positions
``id[,offset[,strand]]``, path positions ``path,offset[,strand]``, BED
ranges, ``-s`` path files, ``LEN:MIN:MAX:TIPS`` windows, and
`fmt_double`, the 6-significant-digit printing of a double.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.graph import GraphTensors


def fmt_double(v: float) -> str:
    """Format like C++ `std::ostream << double` (6 significant digits)."""
    s = f"{v:.6g}"
    # C++ prints e.g. 1e+06 like Python's %g ('1e+06'); both match.
    return s


@dataclass
class GraphPos:
    node_id: int
    offset: int
    is_rev: bool


@dataclass
class PathPos:
    path: int  # path index
    offset: int
    is_rev: bool


@dataclass
class PathRange:
    path: int
    start: int
    end: int
    is_rev: bool = False
    name: str = "."
    data: str = ""


def path_index_by_name(g: GraphTensors, name: str) -> Optional[int]:
    try:
        return g.path_names.index(name)
    except ValueError:
        return None


def parse_graph_pos(g: GraphTensors, buffer: str, tag: str) -> GraphPos:
    vals = buffer.split(",")
    node_id = int(vals[0])
    rank = g.id_to_rank.get(node_id)
    if rank is None:
        print(f"[odgi::{tag}] error: no node {node_id} in graph", file=sys.stderr)
        sys.exit(1)
    offset = 0
    if len(vals) >= 2:
        offset = int(vals[1])
        if int(g.node_len[rank]) < offset:
            print(
                f"[odgi::{tag}] error: offset of {offset} lies beyond the end "
                f"of node {node_id}",
                file=sys.stderr,
            )
            sys.exit(1)
    is_rev = len(vals) == 3 and vals[2] == "-"
    return GraphPos(node_id, offset, is_rev)


def parse_path_pos(g: GraphTensors, buffer: str, tag: str) -> Optional[PathPos]:
    if not buffer:
        return None
    vals = buffer.split(",")
    p = path_index_by_name(g, vals[0])
    if p is None:
        print(f"[odgi::{tag}] error: path {vals[0]} not found in graph", file=sys.stderr)
        sys.exit(1)
    offset = int(vals[1]) if len(vals) > 1 else 0
    is_rev = len(vals) == 3 and vals[2] == "-"
    return PathPos(p, offset, is_rev)


def add_bed_range(
    ranges: List[PathRange], g: GraphTensors, buffer: str
) -> None:
    """Parse one BED line (or a bare path name) into a PathRange
    (reference: region.cpp:73-117)."""
    if not buffer or buffer[0] == "#":
        return
    vals = buffer.split("\t")
    path_name = vals[0]
    p = path_index_by_name(g, path_name)
    if p is None:
        print(
            f"[odgi::add_bed_range] error: path {path_name} not found in graph",
            file=sys.stderr,
        )
        sys.exit(1)
    start = int(vals[1]) if len(vals) > 1 else 0
    if len(vals) > 2:
        end = int(vals[2])
    else:
        end = int(g.path_length[p])
    if start >= end:
        print(
            f"[odgi::add_bed_range] error: wrong input coordinates in row: {buffer}",
            file=sys.stderr,
        )
        sys.exit(1)
    ranges.append(
        PathRange(
            p,
            start,
            end,
            len(vals) > 5 and vals[5] == "-",
            vals[3] if len(vals) > 3 else ".",
            buffer,
        )
    )


def load_subset_paths(g: GraphTensors, path_file: str, tag: str) -> np.ndarray:
    """bool[P] mask of paths named in `path_file` (one per line)."""
    mask = np.zeros(g.num_paths, dtype=bool)
    with open(path_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            p = path_index_by_name(g, line)
            if p is None:
                print(f"[odgi::{tag}] error: path {line} not found in graph", file=sys.stderr)
                sys.exit(1)
            mask[p] = True
    return mask


def parse_windows_spec(spec: str, tag: str, flag: str):
    """LEN:MIN:MAX:TIPS -> (len, min, max, only_tips) or exit (reference:
    src/algorithms/subgraph/extract.cpp:470-497
    check_and_get_windows_in_out_parameter; exactly 4 numeric fields).
    A 3-field LEN:MIN:MAX form is accepted with TIPS defaulting to 0."""
    parts = spec.split(":")
    if len(parts) == 3:
        parts.append("0")
    ok = len(parts) == 4 and all(p.isdigit() for p in parts)
    if ok and int(parts[1]) > int(parts[2]):
        ok = False
    if not ok:
        print(
            f"[odgi::{tag}] error: please specify a valid string "
            f"(LEN:MIN:MAX:TIPS) for the {flag} option.",
            file=sys.stderr,
        )
        sys.exit(1)
    return int(parts[0]), int(parts[1]), int(parts[2]), int(parts[3]) == 1


def get_graph_pos_of_path_pos(g: GraphTensors, pp: PathPos, tag: str) -> GraphPos:
    """Walk the path to the node covering `offset` (reference:
    degree_main.cpp get_graph_pos)."""
    lo, hi = int(g.path_offset[pp.path]), int(g.path_offset[pp.path + 1])
    offs = g.step_pos[lo:hi]
    k = int(np.searchsorted(offs, pp.offset, side="right")) - 1
    if k >= 0:
        h = int(g.step_handle[lo + k])
        rank = h >> 1
        if pp.offset < int(offs[k]) + int(g.node_len[rank]):
            return GraphPos(int(g.node_id[rank]), pp.offset - int(offs[k]), bool(h & 1))
    print(
        f"[odgi::{tag}] warning: position {g.path_names[pp.path]}:{pp.offset} "
        f"outside of path",
        file=sys.stderr,
    )
    return GraphPos(0, 0, False)
