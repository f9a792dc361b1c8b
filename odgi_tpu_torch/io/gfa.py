"""GFA v1 reader/writer for the port's GraphTensors.

The counterpart of ``odgi_tpu/io/gfa.py``.  A file path goes to the native
C++ parser (``native/``, built at first use) first, as in ``odgi_tpu``;
bytes, file objects, and paths when the parser cannot be built, take the
pure-Python path: one pass over the lines into the host-side builder, then
one vectorized freeze.  Both give the same graph: non-integer segment names
get dense ids above the largest integer name; integer names are kept.
``LAST_PARSER["name"]`` says which parser the last call used.
"""

from __future__ import annotations

from typing import Dict, List, TextIO, Tuple, Union

from ..core.graph import GraphBuilder, GraphTensors
from ..device import resolve_device
from ..native import parse_gfa_native

LAST_PARSER: dict = {"name": None}


def parse_gfa(source: Union[str, TextIO, bytes], device=None) -> GraphTensors:
    """Parse a GFAv1 file path, bytes or file object into GraphTensors.

    S lines become nodes in id order, L lines edges, P/W lines paths.  The
    parse is host work; ``device`` is checked like every entry point's, so
    a pipeline meant for the card fails here when there is none.
    """
    resolve_device(device)
    if isinstance(source, bytes):
        data = source
    elif isinstance(source, str):
        g = parse_gfa_native(source)
        if g is not None:
            LAST_PARSER["name"] = "native"
            return g
        with open(source, "rb") as f:
            data = f.read()
    else:
        data = source.read()
        if isinstance(data, str):
            data = data.encode()
    lines = data.splitlines()

    seg_names: List[bytes] = []
    seg_seqs: List[bytes] = []
    name_map: Dict[bytes, int] = {}
    edges: List[Tuple[bytes, bool, bytes, bool]] = []
    paths: List[Tuple[bytes, List[Tuple[bytes, bool]]]] = []

    def seg_id(name: bytes) -> int:
        sid = name_map.get(name)
        if sid is None:
            try:
                sid = int(name)
            except ValueError:
                sid = -1  # resolved after the scan
            name_map[name] = sid
        return sid

    for ln in lines:
        if not ln:
            continue
        t = ln[0:1]
        if t == b"S":
            parts = ln.split(b"\t")
            seg_id(parts[1])
            seg_names.append(parts[1])
            seg_seqs.append(parts[2])
        elif t == b"L":
            parts = ln.split(b"\t")
            edges.append((parts[1], parts[2] == b"-", parts[3], parts[4] == b"-"))
        elif t == b"P":
            parts = ln.split(b"\t")
            steps = [(tok[:-1], tok.endswith(b"-")) for tok in parts[2].split(b",") if tok]
            paths.append((parts[1], steps))
        elif t == b"W":
            # W <sample> <hap> <seq> <start> <end> <walk>
            parts = ln.split(b"\t")
            pname = b"#".join([parts[1], parts[2], parts[3]])
            if parts[4] != b"*" and parts[4] != b"0":
                pname += b":" + parts[4] + b"-" + parts[5]
            steps = []
            cur_rev = False
            cur = bytearray()
            for ch in parts[6]:
                if ch in (0x3E, 0x3C):  # '>' '<'
                    if cur:
                        steps.append((bytes(cur), cur_rev))
                        cur = bytearray()
                    cur_rev = ch == 0x3C
                else:
                    cur.append(ch)
            if cur:
                steps.append((bytes(cur), cur_rev))
            paths.append((pname, steps))

    int_ids = [v for v in name_map.values() if v >= 0]
    next_id = (max(int_ids) + 1) if int_ids else 1
    for name in name_map:
        if name_map[name] < 0:
            name_map[name] = next_id
            next_id += 1

    named = sorted(zip(seg_names, seg_seqs), key=lambda kv: name_map[kv[0]])
    b = GraphBuilder()
    for name, seq in named:
        b.add_node(name_map[name], bytes(seq))
    for na, ra, nb, rb in edges:
        b.add_edge(name_map[na], ra, name_map[nb], rb)
    for pname, steps in paths:
        pi = b.add_path(pname.decode("utf-8"))
        for sname, srev in steps:
            b.append_step(pi, name_map[sname], srev)
    LAST_PARSER["name"] = "python"
    return b.build()


def write_gfa(g: GraphTensors, out: Union[str, TextIO]) -> None:
    """Write GraphTensors as GFAv1: H, S (rank order), L (stored order), P."""
    close = False
    if isinstance(out, str):
        out = open(out, "w")
        close = True
    try:
        out.write("H\tVN:Z:1.0\n")
        ids = g.node_id
        for r in range(g.num_nodes):
            out.write(f"S\t{int(ids[r])}\t{g.node_seq_str(r)}\n")
        ef, et = g.edge_from, g.edge_to
        for k in range(g.num_edges):
            a, bb = int(ef[k]), int(et[k])
            out.write(
                "L\t%d\t%s\t%d\t%s\t0M\n"
                % (
                    int(ids[a >> 1]),
                    "-" if a & 1 else "+",
                    int(ids[bb >> 1]),
                    "-" if bb & 1 else "+",
                )
            )
        for p in range(g.num_paths):
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            toks = [
                f"{int(ids[h >> 1])}{'-' if h & 1 else '+'}"
                for h in g.step_handle[lo:hi].tolist()
            ]
            out.write(f"P\t{g.path_names[p]}\t{','.join(toks)}\t*\n")
    finally:
        if close:
            out.close()
