"""The port's positions, subgraphs and path indexes against odgi_tpu's, on
the CPU: untangle, panpos, position, extract, overlap, pathindex,
stepindex and server.

Each command runs through `odgi_tpu.cli.main(argv)` and the port's
`main(argv, device="cpu")` on the same in-repo graphs (a loop graph; a
hand-written graph of a target path and query paths that share, skip,
repeat and invert its segments, with a GFF and a BED over it; a graph of
multi-base nodes with an inversion; a DRB1-scale synthetic graph, and a
chopped copy of the hand-written graph as `position -x`'s source) and
must print the same stdout and stderr, exit with the same code (or raise
the same error) and write the same bytes: .xpt, .stpidx, the extracted
.og/.otg/GFA (the split outputs of `extract -s` too) and untangle's
cut-point files.  `server` runs in a subprocess and answers as odgi_tpu's
does."""

import os
import socket
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from odgi_tpu.algorithms import liftover as j_lift
from odgi_tpu.algorithms import path_jaccard as j_pj
from odgi_tpu.algorithms import position as j_pos
from odgi_tpu.cli import main as j_cli
from odgi_tpu.core import index as j_index
from odgi_tpu.io.gfa import write_gfa as j_write_gfa
from test_torch_render import REPO, argv_of, inv_graph, run, run_both, synth_graph

from odgi_tpu_torch.algorithms import liftover, path_jaccard, position
from odgi_tpu_torch.cli import main as t_cli
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.core import index

# query paths revisit node 2 (a loop)
GFA_LOOP = (
    "S\t1\tAA\nS\t2\tCC\nS\t3\tGG\nS\t4\tTT\n"
    "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\nL\t3\t+\t2\t+\t0M\nL\t2\t+\t4\t+\t0M\n"
    "P\tq\t1+,2+,3+,2+,4+\t*\nP\tt\t1+,2+,4+\t*\n"
)
# a target path and queries that skip (query1), invert (query2), cover a
# part of (query3) and repeat (query4) its segments; node 11 is off it
SEGS = [("1", "ACGTACGT"), ("2", "TTG"), ("3", "CCCCA"), ("4", "GATTACA"), ("5", "AC"),
        ("6", "GGGTTT"), ("7", "ATATATAT"), ("8", "C"), ("9", "TGCATGCA"), ("10", "AAAT"),
        ("11", "GGC")]
WALKS = [("target", "1+,2+,3+,4+,5+,6+,7+,8+,9+,10+"),
         ("query1", "1+,2+,4+,5+,6+,7+,9+,10+"),
         ("query2", "1+,2+,6-,5-,4-,7+,8+,9+,11+,10+"),
         ("query3", "3+,4+,5+,6+,7+"),
         ("query4", "1+,2+,3+,4+,2+,3+,4+,5+,9+,10+")]


def gfa_ov():
    edges = []
    for _, walk in WALKS:
        st_ = walk.split(",")
        for a, b in zip(st_, st_[1:]):
            e = (a[:-1], a[-1], b[:-1], b[-1])
            if e not in edges:
                edges.append(e)
    lines = ["H\tVN:Z:1.0"] + [f"S\t{n}\t{s}" for n, s in SEGS]
    lines += [f"L\t{a}\t{ao}\t{b}\t{bo}\t0M" for a, ao, b, bo in edges]
    lines += [f"P\t{n}\t{w}\t*" for n, w in WALKS]
    return "\n".join(lines) + "\n"


GFF = """##gff-version 3
target\tsrc\tgene\t3\t20\t.\t+\t.\tID=geneA
target\tsrc\tgene\t18\t40\t.\t-\t.\tID=geneB
target\tsrc\texon\t30\t45\t.\t+\t.\tID=exonC
"""


def side_files(names):
    """The side files the flags name, over a graph's path names."""
    a, b = names[0], names[-1]
    return dict(
        BED=[f"{a}\t3\t20\tgeneA", f"{b}\t0\t9\tgeneB", f"{a}\t25\t40\tgeneC"],
        PPOS=[f"{a},3", f"{b},7,-", f"{names[1]},2"],
        GPOS=["2", "3,1", "5,0,-"],
        REFS=[a, names[1]],
        NAMES=[b, names[1]],
        NODES=["2", "5", "999"],
    )


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> the paths of a graph's .otg, .og and .gfa (written by
    odgi_tpu), with the side files the flags name."""
    d = str(tmp_path_factory.mktemp("position"))
    gfas = {}
    for name, text in (("loop", GFA_LOOP), ("ov", gfa_ov())):
        gfas[name] = os.path.join(d, f"{name}.gfa")
        with open(gfas[name], "w") as f:
            f.write(text)
    for name, gj in (("inv", inv_graph()), ("drb1", synth_graph())):
        gfas[name] = os.path.join(d, f"{name}.gfa")
        j_write_gfa(gj, gfas[name])
    out = {}
    for name, gfa in gfas.items():
        p = dict(dir=d, gfa=gfa)
        for ext in ("og", "otg"):
            p[ext] = os.path.join(d, f"{name}.{ext}")
            assert run(j_cli.main, ["build", "-g", gfa, "-o", p[ext]])[0] == 0
        for key, lines in side_files(j_cli.load_any(p["otg"]).path_names).items():
            p[key] = os.path.join(d, f"{name}.{key.lower()}")
            with open(p[key], "w") as f:
                f.writelines(line + "\n" for line in lines)
        out[name] = p
    ov = out["ov"]
    ov["GFF"] = os.path.join(d, "ov.gff")
    with open(ov["GFF"], "w") as f:
        f.write(GFF)
    ov["LIFTS"] = os.path.join(d, "ov.lifts")
    with open(ov["LIFTS"], "w") as f:
        f.write("target\nquery1\n")
    # position -x's source: the graph chopped to 2 bp by each package
    ov["SRC"] = os.path.join(d, "ov_chop.otg")
    assert run(j_cli.main, ["chop", "-i", ov["otg"], "-c", "2", "-o", ov["SRC"]])[0] == 0
    t_src = os.path.join(d, "ov_chop_t.otg")
    assert run(t_cli.main, ["chop", "-i", ov["otg"], "-c", "2", "-o", t_src],
               device="cpu")[0] == 0
    with open(ov["SRC"], "rb") as a, open(t_src, "rb") as b:
        assert a.read() == b.read()
    return out


def words_id(words):
    return "_".join(words).replace("-", "").replace("{o}", "o").replace(".", "") or "none"


POSITION_FLAGS = [
    ["-g", "6"], ["-g", "6,2"], ["-g", "4,1,-", "-r", "target"], ["-g", "11"],
    ["-G", "GPOS"], ["-G", "GPOS", "-r", "target"],
    ["-p", "query1,5"], ["-p", "query3,2", "-r", "target"],
    ["-p", "query2,12", "-r", "target", "-w", "2"], ["-p", "query4,20,-", "-r", "target"],
    ["-F", "PPOS"], ["-F", "PPOS", "-R", "REFS"],
    ["-b", "BED"], ["-b", "BED", "-r", "target"], ["-b", "BED", "--all-ref-positions"],
    ["-b", "BED", "-R", "REFS", "--all-ref-positions"], ["-b", "BED", "-v"],
    ["-E", "GFF"], ["-E", "GFF", "-r", "target"],
    ["-v", "-p", "query1,5"], ["-v", "-g", "6"], ["-I", "-g", "6"], ["-I", "-g", "11", "-R", "REFS"],
    ["-R", "REFS", "-g", "11"], ["--all-positions", "-r", "target"], ["--all-positions", "-R", "REFS"],
    ["-d", "0", "-g", "11", "-r", "target"], ["-d", "3", "-w", "4", "-g", "11", "-r", "query1"],
    ["-x", "SRC", "-p", "query1,5", "-r", "target"], ["-x", "SRC", "-l", "query1", "-g", "6"],
    ["-x", "SRC", "-L", "LIFTS", "-b", "BED"], ["-x", "SRC", "-g", "7,1", "-v"],
    ["-x", "SRC", "-F", "PPOS", "-r", "target"],
    # the error exits
    ["-r", "absent", "-g", "6"], ["-R", "NAMES", "-l", "query1", "-g", "6"], ["-g", "99"],
    ["-g", "6,40"], ["-p", "absent,3"], ["-E", "absent.gff"], ["-x", "SRC", "-l", "absent", "-g", "6"],
]


@pytest.mark.parametrize("flags", POSITION_FLAGS, ids=words_id)
def test_position(inputs, flags):
    p = inputs["ov"]
    rc = run_both(p["dir"], ["position", "-i", p["otg"]] + argv_of(p, flags))
    if "absent" in " ".join(flags) or flags[-1] in ("99", "6,40") or "NAMES" in flags:
        assert rc[0] not in (0, None)
    else:
        assert rc[0] == 0


@pytest.mark.parametrize("flags", [["-b", "BED"], ["-p", "HG0#1#chr6,1000", "-r", "HG1#2#chr6"],
                                   ["-g", "300", "-R", "REFS"], ["-F", "PPOS", "-I"]], ids=words_id)
def test_position_drb1(inputs, flags):
    p = inputs["drb1"]
    assert run_both(p["dir"], ["position", "-i", p["otg"]] + argv_of(p, flags))[0] == 0


EXTRACT_FLAGS = [
    (["-r", "target:5-30", "-o", "{o}.og"], ["{o}.og"]),
    (["-r", "query2:8-20", "-c", "1", "-o", "{o}.og"], ["{o}.og"]),
    (["-r", "target:5-30", "-L", "5", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["-b", "BED", "-o", "{o}.og"], ["{o}.og"]),
    (["-b", "BED", "-E", "-o", "{o}.otg"], ["{o}.otg"]),
    (["-n", "4", "-o", "{o}.og"], ["{o}.og"]),
    (["-n", "4", "-c", "2", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["-l", "NODES", "-o", "{o}.og"], ["{o}.og"]),
    (["-q", "10-30", "-o", "{o}.og"], ["{o}.og"]),
    (["-p", "REFS", "-r", "target:0-20", "-o", "{o}.og"], ["{o}.og"]),
    (["-I", "-n", "4", "-o", "{o}.og"], ["{o}.og"]),
    (["-I", "-r", "target:0-30", "--drop-pathless", "-o", "{o}.og"], ["{o}.og"]),
    (["-n", "11", "-L", "3", "--drop-pathless", "-o", "{o}.og"], ["{o}.og"]),
    (["-d", "10", "-e", "2", "-b", "BED", "-o", "{o}.og"], ["{o}.og"]),
    (["-d", "30", "-l", "NODES", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["-K", "-r", "query3:0-20", "-o", "{o}.og"], ["{o}.og"]),
    (["-K", "-b", "BED", "-O", "-o", "{o}.og"], ["{o}.og"]),
    (["-O", "-q", "5-40", "-o", "{o}.otg"], ["{o}.otg"]),
    (["-s", "-b", "BED", "-r", "query1:3-9", "-o", "{o}.og"],
     ["{o}.target:3-20.og", "{o}.query4:0-9.og", "{o}.target:25-40.og", "{o}.query1:3-9.og"]),
    (["-s", "-b", "BED", "-d", "20", "-K", "-O", "-c", "1", "-o", "{o}"],
     ["{o}.target:3-20.og", "{o}.query4:0-9.og"]),
    # the error exits
    (["-o", "{o}.og"], []), (["-n", "99", "-o", "{o}.og"], []), (["-s", "-o", "{o}.og"], []),
    (["-r", "absent:0-5", "-o", "{o}.og"], []), (["-I", "-q", "0-100", "-o", "{o}.og"], []),
]


@pytest.mark.parametrize("flags,outputs", EXTRACT_FLAGS, ids=lambda v: words_id(v) if v and v[0].startswith("-") else None)
def test_extract(inputs, flags, outputs):
    p = inputs["ov"]
    tag = words_id(flags)[:40]
    flags = [a.replace("{o}", f"{tag}_{{o}}") for a in flags]
    outputs = [f"{tag}_{o}" for o in outputs]
    rc = run_both(p["dir"], ["extract", "-i", p["otg"]] + argv_of(p, flags), outputs=outputs)
    assert rc[0] == (0 if outputs else rc[0]) and (outputs or rc[0] != 0)


@pytest.mark.parametrize("flags", [["-b", "BED", "-c", "3"], ["-r", "HG2#1#chr6:100-900", "-E", "-L", "20"]],
                         ids=words_id)
def test_extract_drb1(inputs, flags):
    p = inputs["drb1"]
    tag = words_id(flags)
    rc = run_both(p["dir"], ["extract", "-i", p["otg"], "-o", f"{tag}_{{o}}.otg"] + argv_of(p, flags),
                  outputs=[f"{tag}_{{o}}.otg"])
    assert rc[0] == 0


UNTANGLE_FLAGS = [
    [], ["-r", "target"], ["-r", "target", "-p"], ["-r", "target", "-G"], ["-r", "target", "-g"],
    ["-r", "target", "-X"], ["-r", "target", "-m", "5"], ["-r", "target", "-s", "1.5"],
    ["-r", "target", "-r", "query1", "-n", "2"], ["-r", "target", "-j", "0.5"],
    ["-r", "target", "-e", "10"], ["-r", "target", "-e", "7", "-p"],
    ["-q", "query2", "-q", "query4", "-r", "target"], ["-Q", "NAMES", "-R", "REFS"],
    ["-q", "query4", "-S"], ["-S"],
    ["-r", "target", "-d", "{o}.cuts"], ["-r", "target", "-c", "CUTS"],
    ["-r", "target", "-c", "CUTS", "-m", "3", "-d", "{o}.cuts2"],
    # the error exits
    ["-r", "absent"], ["-q", "absent"],
]


@pytest.fixture(scope="module")
def cut_points(inputs):
    p = inputs["ov"]
    path = os.path.join(p["dir"], "ov.cutsin")
    assert run(j_cli.main, ["untangle", "-i", p["otg"], "-r", "target", "-e", "6",
                            "-d", path])[0] == 0
    return path


@pytest.mark.parametrize("flags", UNTANGLE_FLAGS, ids=words_id)
def test_untangle(inputs, cut_points, flags):
    p = dict(inputs["ov"], CUTS=cut_points)
    outputs = [a.replace("{o}", "unt_{o}") for a in flags if "{o}" in a]
    flags = [a.replace("{o}", "unt_{o}") for a in flags]
    rc = run_both(p["dir"], ["untangle", "-i", p["otg"]] + argv_of(p, flags), outputs=outputs)
    assert rc[0] == ("raise" if "absent" in flags else 0)


@pytest.mark.parametrize("name,flags", [("loop", []), ("loop", ["-q", "q", "-r", "t", "-p"]),
                                        ("loop", ["-S"]), ("inv", ["-r", "HG1#1#chr1"]),
                                        ("inv", ["-r", "ref#1#chr1", "-g", "-m", "4"]),
                                        ("drb1", ["-q", "HG1#1#chr6", "-r", "HG0#1#chr6"])],
                         ids=lambda v: v if isinstance(v, str) else words_id(v))
def test_untangle_graphs(inputs, name, flags):
    p = inputs[name]
    assert run_both(p["dir"], ["untangle", "-i", p["otg"]] + flags)[0] == 0


OVERLAP_FLAGS = [["-b", "BED"], ["-r", "query3"], ["-R", "REFS"], ["-s", "NAMES", "-b", "BED"],
                 ["-r", "target", "-R", "NAMES", "-s", "REFS"], [], ["-r", "absent"]]


@pytest.mark.parametrize("name", ["ov", "inv"])
@pytest.mark.parametrize("flags", OVERLAP_FLAGS, ids=words_id)
def test_overlap(inputs, name, flags):
    p = inputs[name]
    if name == "inv":
        flags = [{"query3": "ref#1#chr1", "target": "HG2#1#chr1"}.get(f, f) for f in flags]
    rc = run_both(p["dir"], ["overlap", "-i", p["otg"]] + argv_of(p, flags))
    assert rc[0] == ("raise" if "absent" in flags else 1 if not flags else 0)


@pytest.mark.parametrize("name", ["loop", "ov", "inv", "drb1"])
def test_pathindex_and_panpos(inputs, name):
    """pathindex writes the same .xpt; panpos answers the same from it and
    from the graph, at the first, a middle and the last position.  An .xpt
    holds no pangenome offset for the graph's last node (odgi_tpu's
    `PathIndex.build` cuts `node_offset`, already N long, by one more), so
    a query there raises IndexError in both."""
    p = inputs[name]
    assert run_both(p["dir"], ["pathindex", "-i", p["otg"], "-o", f"{name}_{{o}}.xpt"],
                    outputs=[f"{name}_{{o}}.xpt"])[0] == 0
    g = j_cli.load_any(p["otg"])
    for k in (0, g.num_paths - 1):
        n = int(g.path_length[k])
        for pos in sorted({0, n // 2, n - 1}):
            on_last = j_pos.path_pos_to_graph(g, k, pos)[0] == g.num_nodes - 1
            # a .og read takes seconds at DRB1 scale; the small graphs test it
            for src in (os.path.join(p["dir"], f"{name}_j.xpt"), p["otg" if name == "drb1" else "og"]):
                res = run_both(p["dir"], ["panpos", "-i", src, "-p", g.path_names[k],
                                          "-v", str(pos)])
                if on_last and src.endswith(".xpt"):
                    assert res[:2] == ("raise", "IndexError")
                else:
                    assert res[0] == 0 and res[1].strip().isdigit()


@pytest.mark.parametrize("rate", [None, "0", "2", "4", "16", "3"])
@pytest.mark.parametrize("name", ["ov", "drb1"])
def test_stepindex(inputs, name, rate):
    """stepindex writes the same .stpidx; an odd sample rate is an error."""
    p = inputs[name]
    tag = f"{name}_{rate}"
    argv = ["stepindex", "-i", p["otg"], "-o", f"{tag}_{{o}}.stpidx"] + (["-a", rate] if rate else [])
    rc = run_both(p["dir"], argv, outputs=[] if rate == "3" else [f"{tag}_{{o}}.stpidx"])
    assert rc[0] == (1 if rate == "3" else 0)


def test_pathindex_inputs(inputs):
    """The reference's .og and GFA as the input, and the stepindex and
    panpos flags' long forms."""
    p = inputs["ov"]
    for src in ("og", "gfa"):
        run_both(p["dir"], ["pathindex", "--idx", p[src], "-o", f"{src}_{{o}}.xpt", "-t", "2"],
                 outputs=[f"{src}_{{o}}.xpt"])
        run_both(p["dir"], ["stepindex", "--input", p[src], "--out", f"{src}_{{o}}.stpidx",
                            "--step-index-sample-rate", "2"], outputs=[f"{src}_{{o}}.stpidx"])
    assert run_both(p["dir"], ["panpos", "--input", p["gfa"], "--path", "query2", "--pos", "9"])[0] == 0


# ---------------------------------------------------------------------------
# The modules against odgi_tpu's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs(inputs):
    """name -> (odgi_tpu's graph, the port's graph) of the same arrays."""
    out = {}
    for name in ("ov", "inv", "drb1"):
        gj = j_cli.load_any(inputs[name]["otg"])
        out[name] = (gj, graph_from_arrays(graph_to_arrays(gj)))
    return out


@pytest.mark.parametrize("name", ["ov", "inv", "drb1"])
def test_indexes_equal_odgi_tpu(graphs, name, tmp_path):
    """PathIndex, StepIndex and LinearIndex: the same arrays, the same
    bytes, and the same answers after a round trip through the file."""
    gj, gt = graphs[name]
    for jcls, tcls, kw in ((j_index.PathIndex, index.PathIndex, {}),
                           (j_index.StepIndex, index.StepIndex, {"sample_rate": 4})):
        ji, ti = jcls.build(gj, **kw), tcls.build(gt, **kw)
        ji.save(str(tmp_path / "j.idx"))
        ti.save(str(tmp_path / "t.idx"))
        assert (tmp_path / "j.idx").read_bytes() == (tmp_path / "t.idx").read_bytes()
        back = tcls.load(str(tmp_path / "t.idx"))
        for f in ("path_offset", "node_len"):
            assert np.array_equal(getattr(back, f), getattr(ji, f))
    si_j, si_t = j_index.StepIndex.build(gj, 4), index.StepIndex.build(gt, 4)
    steps = np.linspace(0, gj.num_steps - 1, 50).astype(int)
    assert [si_t.get_position(int(s)) for s in steps] == [si_j.get_position(int(s)) for s in steps]
    li_j, li_t = j_index.LinearIndex.build(gj), index.LinearIndex.build(gt)
    assert li_t.graph_seq == li_j.graph_seq
    assert [li_t.position_of_handle(h) for h in range(0, 2 * gj.num_nodes, 7)] == \
        [li_j.position_of_handle(h) for h in range(0, 2 * gj.num_nodes, 7)]
    with pytest.raises(ValueError):
        index.PathIndex.load(str(tmp_path / "t.idx"))


@settings(derandomize=True, deadline=None, max_examples=40)
@given(st.data())
def test_position_queries_equal_odgi_tpu(graphs, data):
    """panpos, path_pos_to_graph, graph_pos_to_paths, lift_position and the
    liftover context's graph positions at drawn path positions."""
    name = data.draw(st.sampled_from(["ov", "inv", "drb1"]))
    gj, gt = graphs[name]
    p = data.draw(st.integers(0, gj.num_paths - 1))
    pos = data.draw(st.integers(0, int(gj.path_length[p]) - 1))
    nm = gj.path_names[p]
    assert position.panpos(gt, nm, pos) == j_pos.panpos(gj, nm, pos)
    rank, off, rev = j_pos.path_pos_to_graph(gj, p, pos)
    assert position.path_pos_to_graph(gt, p, pos) == (rank, off, rev)
    assert position.graph_pos_to_paths(gt, rank, off) == j_pos.graph_pos_to_paths(gj, rank, off)
    dst = data.draw(st.lists(st.integers(0, gj.num_paths - 1), min_size=1, max_size=3))
    assert position.lift_position(gt, p, pos, dst) == j_pos.lift_position(gj, p, pos, dst)
    assert liftover.get_graph_pos(liftover.PositionContext(gt), p, pos) == \
        j_lift.get_graph_pos(j_lift.PositionContext(gj), p, pos)


@pytest.mark.parametrize("name", ["ov", "inv", "drb1"])
def test_path_jaccard_equal_odgi_tpu(graphs, name):
    """Both Jaccard codes (path_jaccard.py's and liftover.py's): the
    walking-distance node sets, and the ranked Jaccard indices of a query
    step against every step on its node."""
    gj, gt = graphs[name]
    cj, ct = j_lift.PositionContext(gj), liftover.PositionContext(gt)
    for s in np.linspace(0, gj.num_steps - 1, 12).astype(int).tolist():
        for prev, nxt in ((0, 0), (5, 2), (40, 40)):
            assert path_jaccard.collect_nodes_in_walking_dist(gt, prev, nxt, s) == \
                j_pj.collect_nodes_in_walking_dist(gj, prev, nxt, s)
            assert liftover.collect_nodes_in_walking_dist(ct, prev, nxt, s) == \
                j_lift.collect_nodes_in_walking_dist(cj, prev, nxt, s)
        targets = [int(t) for t in j_pos.steps_on_node(gj, int(gj.step_handle[s]) >> 1)]
        for dist in (3, 20):
            assert path_jaccard.jaccard_indices_from_steps(gt, dist, s, targets) == \
                j_pj.jaccard_indices_from_steps(gj, dist, s, targets)
            assert liftover.jaccard_indices_from_steps(ct, dist, s, targets) == \
                j_lift.jaccard_indices_from_steps(cj, dist, s, targets)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


SERVE = {
    "j": "from odgi_tpu.cli.main import main; main({argv!r})",
    "t": "from odgi_tpu_torch.cli.main import main; main({argv!r}, device='cpu')",
}


def start_server(tag, src):
    """Start one package's server from `src` on a free port."""
    port = free_port()
    argv = ["server", "-i", src, "-p", str(port), "-a", "127.0.0.1"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", SERVE[tag].format(argv=argv)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    return proc, port


def ask(proc, port, queries):
    """Send `queries` (the last is /stop) once the server answers /hi, and
    return the replies, the exit code and the stdout (the port number
    replaced by "PORT")."""
    for _ in range(120):
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/hi", timeout=2).read()
            break
        except OSError:
            time.sleep(0.25)
    else:
        raise AssertionError("server did not come up")
    replies = []
    for q in queries:
        try:
            replies.append(urllib.request.urlopen(f"http://127.0.0.1:{port}{q}",
                                                  timeout=5).read().decode())
        except OSError:  # the handler raised: the connection closes
            replies.append("dropped")
    out, _ = proc.communicate(timeout=30)
    return replies, proc.returncode, out.replace(str(port), "PORT")


@pytest.mark.parametrize("src", ["xpt", "otg"])
def test_server_equals_odgi_tpu(inputs, src):
    """From a .xpt and from a graph: /hi, percent-encoded path names,
    1-based positions (0 past the end and for an unknown path) and /stop.
    The last base of path 0 lies on the graph's last node, for which the
    index holds no offset (see test_pathindex_and_panpos): both handlers
    raise there and drop the connection."""
    p = inputs["inv"]
    path = os.path.join(p["dir"], "srv.xpt")
    if src == "xpt":
        assert run(j_cli.main, ["pathindex", "-i", p["otg"], "-o", path])[0] == 0
    else:
        path = p["otg"]
    g = j_cli.load_any(p["otg"])
    names = [urllib.parse.quote(n) for n in g.path_names[:2]]
    n0 = int(g.path_length[0])
    queries = ["/hi", f"/{names[0]}/1", f"/{names[0]}/{n0}", f"/{names[0]}/{n0 + 1}",
               f"/{names[1]}/7", "/nope/1", f"/{names[1]}/x", "/stop"]
    servers = {tag: start_server(tag, path) for tag in ("j", "t")}  # both start at once
    try:
        j_res, t_res = (ask(*servers[tag], queries) for tag in ("j", "t"))
    finally:
        for proc, _ in servers.values():
            proc.kill()
            proc.wait()
    assert t_res == j_res
    replies = t_res[0]
    assert replies[0] == "Hello World!" and replies[-1] == "bye" and t_res[1] == 0
    assert int(replies[1]) >= 1 and replies[3] == "0" and replies[5] == "0"
    assert replies[2] == "dropped" and int(replies[4]) >= 1
