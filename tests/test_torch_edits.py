"""The port's graph edits against odgi_tpu's, on the CPU: chop, unchop,
normalize, flip, prune, explode, squeeze, flatten, groom, crush, break,
unitig, inject, cover, priv and procbed.

Each command runs through `odgi_tpu.cli.main(argv)` and the port's
`main(argv, device="cpu")` on the same in-repo graphs (multi-base nodes
with runs of N, bubbles and an inversion; a DRB1-scale synthetic graph; a
graph of two components) and must print the same stdout and stderr, exit
with the same code and write the same bytes (.og, .otg, GFA, FASTA,
BED).  `unitig` and `priv` draw from numpy's default_rng, so one seed
gives the same bytes in both."""

import os

import numpy as np
import pytest

from odgi_tpu.algorithms import topological as j_topo
from odgi_tpu.cli import main as j_cli
from odgi_tpu.io.gfa import write_gfa as j_write_gfa
from test_torch_render import inv_graph, run, run_both, synth_graph

from odgi_tpu_torch.algorithms import topological
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays

# Two components, non-integer segment names, a self-inverse edge, a tip.
GFA_TWO = """H\tVN:Z:1.0
S\tutig_a\tACGTTGNNNA
S\t7\tCC
S\tutig_b\tNNATNNNN
S\tz\tg
S\tlone\tACGTACGTAC
S\tlone2\tT
S\ttip\tGATTACA
L\tutig_a\t+\t7\t-\t0M
L\t7\t-\tutig_b\t+\t0M
L\tutig_b\t+\tutig_b\t-\t0M
L\tutig_b\t-\tz\t+\t0M
L\tlone\t+\tlone2\t+\t0M
L\tlone2\t+\ttip\t+\t0M
P\tsample#1#chr2\tutig_a+,7-,utig_b+,utig_b-,z+\t*
P\tsample#2#chr2\tz-,utig_b+,utig_b-,7+,utig_a-\t*
P\tother#1#chr3\tlone+,lone2+\t*
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> the paths of a graph's .otg, .og and .gfa (written by
    odgi_tpu), with the side files the flags name."""
    d = str(tmp_path_factory.mktemp("edits"))
    gfas = {}
    for name, gj in (("inv", inv_graph()), ("drb1", synth_graph())):
        gfas[name] = os.path.join(d, f"{name}.gfa")
        j_write_gfa(gj, gfas[name])
    gfas["two"] = os.path.join(d, "two.gfa")
    with open(gfas["two"], "w") as f:
        f.write(GFA_TWO)
    out = {}
    for name, gfa in gfas.items():
        p = dict(dir=d, gfa=gfa)
        for ext in ("og", "otg"):
            p[ext] = os.path.join(d, f"{name}.{ext}")
            assert run(j_cli.main, ["build", "-g", gfa, "-o", p[ext]])[0] == 0
        names = j_cli.load_any(p["otg"]).path_names
        side = dict(
            TARGETS=[names[-1]],
            BED=[f"{names[0]}\t1\t9\tgeneA", f"{names[-1]}\t0\t4\tgeneB",
                 "absent\t0\t3\tgeneC"],
            PROCBED=[f"{names[0]}\t2\t12\tfeat1", f"{names[0]}\t30\t35\tfeat2",
                     f"{names[-1]}\t0\t5\tfeat3", "absent\t1\t2\tfeat4"],
        )
        for key, lines in side.items():
            p[key] = os.path.join(d, f"{name}.{key.lower()}")
            with open(p[key], "w") as f:
                f.writelines(line + "\n" for line in lines)
        out[name] = p
    # fragments named name:start-end for procbed: prune's output
    frag = os.path.join(d, "frag.otg")
    assert run(j_cli.main, ["prune", "-i", out["inv"]["otg"], "-o", frag, "-d", "2"])[0] == 0
    out["frag"] = dict(out["inv"], otg=frag)
    return out


def argv_of(p, words):
    return [p.get(w, w) if w.isupper() else w for w in words]


GRAPHS = ["inv", "drb1", "two"]
# (subcommand and flags, output files); "{o}" is "j" or "t"
EDITS = [
    (["chop", "-c", "1", "-o", "{o}.og"], ["{o}.og"]),
    (["chop", "-c", "3", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["unchop", "-o", "{o}.og"], ["{o}.og"]),
    (["unchop", "-o", "{o}.otg"], ["{o}.otg"]),
    (["normalize", "-o", "{o}.og"], ["{o}.og"]),
    (["normalize", "-I", "1", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["flip", "-o", "{o}.og"], ["{o}.og"]),
    (["prune", "-d", "3", "-o", "{o}.og"], ["{o}.og"]),
    (["prune", "-c", "2", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["prune", "-T", "-o", "{o}.og"], ["{o}.og"]),
    (["prune", "-d", "4", "-c", "3", "-T", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["explode", "-p", "{o}_part."], ["{o}_part.0.otg"]),
    (["flatten", "-f", "{o}.fa", "-b", "{o}.bed"], ["{o}.fa", "{o}.bed"]),
    (["flatten", "-f", "{o}.fa", "-n", "chrZ"], ["{o}.fa"]),
    (["flatten", "-b", "{o}.bed"], ["{o}.bed"]),
    (["flatten"], []),
    (["groom", "-o", "{o}.og"], ["{o}.og"]),
    (["groom", "-R", "TARGETS", "-d", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["crush", "-o", "{o}.og"], ["{o}.og"]),
    (["break", "-d"], []),
    (["break", "-d", "-c", "12", "-s", "40"], []),
    (["break", "-c", "20", "-s", "200", "-o", "{o}.og"], ["{o}.og"]),
    (["break", "-u", "2", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["unitig"], []),
    (["unitig", "-f", "-l", "2"], []),
    (["unitig", "-t", "60", "--seed", "3"], []),
    (["unitig", "-p", "5", "--seed", "9"], []),
    (["inject", "-b", "BED", "-o", "{o}.og"], ["{o}.og"]),
    (["cover", "-o", "{o}.og"], ["{o}.og"]),
    (["cover", "-n", "2", "-k", "3", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["cover", "-n", "0", "-c", "2", "-I", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["priv", "-e", "0.5", "-b", "20", "--seed", "1", "-W", "-o", "{o}.og"], ["{o}.og"]),
    (["priv", "-d", "0.5", "-c", "1", "-b", "8", "--seed", "7", "-o", "{o}.gfa"], ["{o}.gfa"]),
    (["procbed", "-b", "PROCBED"], []),
]
# a Python BFS from each handle, a window loop a step, a random walk a
# unitig: seconds to a minute at DRB1 scale
SLOW_ON_DRB1 = ("break", "cover", "unitig -t", "unitig -p")
CASES = [(name, e) for name in GRAPHS for e in EDITS
         if not (name == "drb1" and " ".join(e[0]).startswith(SLOW_ON_DRB1))]


def case_id(case):
    name, (argv, _) = case
    return name + "-" + ("_".join(argv).replace("-", "").replace("{o}", "").replace(".", ""))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_edit(inputs, case):
    name, (argv, outputs) = case
    p = inputs[name]
    if name == "drb1":  # a .og write takes a second there; the others test it
        argv, outputs = ([a.replace(".og", ".otg") for a in v] for v in (argv, outputs))
    argv = [a.replace("{o}", f"{name}_{{o}}") for a in argv]
    outs = [f"{name}_{o}" for o in outputs]
    rc, _, _ = run_both(p["dir"], [argv[0], "-i", p["otg"]] + argv_of(p, argv[1:]), outputs=outs)
    assert rc == (1 if argv == ["flatten"] else 0)
    if argv[0] == "explode":
        parts = sorted(f for f in os.listdir(p["dir"]) if f.startswith(f"{name}_j_part."))
        assert len(parts) == (2 if name == "two" else 1)
        for f in parts:
            with open(os.path.join(p["dir"], f), "rb") as a, \
                    open(os.path.join(p["dir"], f.replace("_j_", "_t_")), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("src", ["og", "gfa"])
def test_edit_inputs(inputs, src):
    """The reference's .og and GFA as the input."""
    p = inputs["inv"]
    run_both(p["dir"], ["unchop", "-i", p[src], "-o", f"{src}_{{o}}.og"], outputs=[f"{src}_{{o}}.og"])


def test_procbed_on_fragments(inputs):
    """procbed clips and shifts BED records into prune's name:start-end
    fragments."""
    p = inputs["frag"]
    rc, out, _ = run_both(p["dir"], ["procbed", "-i", p["otg"], "-b", p["PROCBED"]])
    assert rc == 0 and out


def test_squeeze(inputs):
    p = inputs["inv"]
    argv = ["squeeze", "-f", inputs["two"]["otg"], p["otg"], inputs["drb1"]["gfa"], "-o", "sq_{o}.og"]
    run_both(p["dir"], argv, outputs=["sq_{o}.og"])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_chop_then_unchop(inputs, k):
    """chop -c k, then unchop and normalize of the chopped graph."""
    p = inputs["inv"]
    run_both(p["dir"], ["chop", "-i", p["otg"], "-c", str(k), "-o", f"c{k}_{{o}}.otg"],
             outputs=[f"c{k}_{{o}}.otg"])
    for cmd in ("unchop", "normalize"):
        run_both(p["dir"], [cmd, "-i", os.path.join(p["dir"], f"c{k}_j.otg"),
                            "-o", f"c{k}{cmd}_{{o}}.og"], outputs=[f"c{k}{cmd}_{{o}}.og"])


@pytest.mark.parametrize("name", GRAPHS)
def test_topological_order_from_tails(inputs, name):
    gj = j_cli.load_any(inputs[name]["otg"])
    gt = graph_from_arrays(graph_to_arrays(gj))
    assert np.array_equal(topological.tail_nodes(gt), j_topo.tail_nodes(gj))
    for heads, tails in ((False, True), (True, True), (False, False)):
        assert np.array_equal(topological.topological_order(gt, heads, tails),
                              j_topo.topological_order(gj, heads, tails))
