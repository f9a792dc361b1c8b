"""The port's pangenome analytics against odgi_tpu's, on the CPU: kmers,
matrix, similarity, tension, heaps, pav, tips and bin.

Each command runs through `odgi_tpu.cli.main(argv)` and the port's
`main(argv, device="cpu")` on the same in-repo graphs (the hand-written
target/query graph and the loop graph of `test_torch_position.py`, a graph
of multi-base nodes with an inversion and PanSN path names, a DRB1-scale
synthetic graph) and must print the same stdout and stderr, exit with the
same code (or raise the same error) and write the same bytes (`tips -v`'s
TSV).  `heaps` draws its permutations from numpy's default_rng with
odgi_tpu's seed, so the same calls give the same curves."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from odgi_tpu.algorithms import analytics as j_an
from odgi_tpu.algorithms import bin_cmd as j_bin
from odgi_tpu.algorithms import paths_cmd as j_pc
from odgi_tpu.cli import main as j_cli
from odgi_tpu.io.gfa import write_gfa as j_write_gfa
from odgi_tpu.io.lay import save_lay as j_save_lay
from test_torch_position import GFA_LOOP, gfa_ov, words_id
from test_torch_render import argv_of, inv_graph, run, run_both, synth_graph

from odgi_tpu_torch.algorithms import analytics, bin_cmd, paths_cmd
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> the paths of a graph's .otg, .og and .gfa (written by
    odgi_tpu), a .lay of seeded coordinates, and the side files the flags
    name."""
    d = str(tmp_path_factory.mktemp("analytics"))
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
        g = j_cli.load_any(p["otg"])
        names = g.path_names
        p["LAY"] = os.path.join(d, f"{name}.lay")
        rng = np.random.default_rng(7)
        j_save_lay(rng.normal(size=(2 * g.num_nodes, 2)) * 50.0, p["LAY"])
        side = dict(
            BED=[f"{names[0]}\t2\t20\tgeneA", f"{names[-1]}\t0\t9\tgeneB",
                 f"{names[1]}\t5\t30\tgeneC", "# a comment line", f"{names[0]}\t0\t8"],
            GROUPS=[f"{names[0]}\tgroupA", f"{names[1]}\tgroupB", f"{names[-1]}\tgroupA"],
            Q=[names[1], names[-1]],
            T=[names[0]],
        )
        for key, lines in side.items():
            p[key] = os.path.join(d, f"{name}.{key.lower()}")
            with open(p[key], "w") as f:
                f.writelines(line + "\n" for line in lines)
        out[name] = p
    return out


def check(inputs, name, argv, outputs=(), rc=0):
    p = inputs[name]
    tag = f"{name}_{words_id(argv)[:40]}"
    outs = [a.replace("{o}", f"{tag}_{{o}}") for a in outputs]
    argv = [a.replace("{o}", f"{tag}_{{o}}") for a in argv]
    res = run_both(p["dir"], [argv[0], "-i", p["otg"]] + argv_of(p, argv[1:]), outputs=outs)
    assert res[0] == rc, res
    return res


# (subcommand and flags, graphs); every output stays under about 1 MB
CASES = [
    (["kmers", "-k", "5", "-c"], ["loop", "ov", "inv"]),
    (["kmers", "-k", "4"], ["loop", "ov", "inv"]),
    (["kmers", "-k", "8", "-c", "-e", "2"], ["ov", "inv"]),
    (["kmers", "-k", "7", "-e", "1", "-D", "3"], ["ov", "inv"]),
    (["kmers", "-k", "12", "-c", "-D", "2"], ["inv"]),
    (["matrix"], ["loop", "ov", "inv"]),
    (["matrix", "-w"], ["loop", "ov", "inv"]),
    (["similarity"], ["loop", "ov", "inv", "drb1"]),
    (["tension", "-c", "LAY"], ["loop", "ov", "inv"]),
    (["heaps"], ["ov", "inv"]),
    (["heaps", "-n", "3"], ["loop", "ov", "inv", "drb1"]),
    (["heaps", "-n", "2", "-D", "#"], ["inv", "drb1"]),
    (["heaps", "-n", "2", "-p", "GROUPS"], ["ov", "inv"]),
    (["heaps", "-n", "2", "-S"], ["inv", "drb1"]),
    (["heaps", "-n", "4", "-H"], ["inv"]),
    (["heaps", "-n", "2", "-b", "BED"], ["ov", "inv"]),
    (["heaps", "-n", "2", "-d", "2"], ["ov", "inv"]),
    (["pav", "-b", "BED"], ["ov", "inv", "drb1"]),
    (["pav", "-b", "BED", "-D", "#"], ["inv"]),
    (["pav", "-b", "BED", "-p", "GROUPS"], ["ov", "inv"]),
    (["pav", "-b", "BED", "-S", "-M"], ["inv", "drb1"]),
    (["pav", "-b", "BED", "-H", "-B", "0.5"], ["inv"]),
    (["pav", "-b", "BED", "-M", "-B", "0.3"], ["ov", "inv"]),
    (["tips"], ["loop", "ov", "inv"]),
    (["tips", "-r", "PATH0"], ["ov", "inv", "drb1"]),
    (["tips", "-q", "PATH1", "-r", "PATH0", "-n", "2", "-j"], ["ov", "inv"]),
    (["tips", "-Q", "Q", "-R", "T", "-w", "5"], ["ov", "inv"]),
    (["tips", "-r", "PATH0", "-w", "3", "-n", "3", "-j", "-v", "{o}.tsv"], ["ov", "inv"]),
    (["tips", "-v", "{o}.tsv"], ["loop", "ov"]),
    (["bin", "-w", "5"], ["loop", "ov", "inv"]),
    (["bin", "-n", "10"], ["ov", "inv", "drb1"]),
    (["bin", "-w", "7", "-j"], ["ov", "inv"]),
    (["bin", "-w", "4", "-j", "-s", "-g"], ["ov", "inv"]),
    (["bin", "-n", "6", "-D", "#"], ["inv", "drb1"]),
    (["bin", "-w", "9", "-D", "#", "-a"], ["inv"]),
    (["bin", "-w", "9", "-D", "#", "-a", "-j"], ["inv"]),
    (["bin", "-w", "300", "-j", "-s"], ["drb1"]),
]


def flat(cases):
    return [(name, argv) for argv, names in cases for name in names]


@pytest.mark.parametrize("name,argv", flat(CASES),
                         ids=lambda v: v if isinstance(v, str) else words_id(v))
def test_analytics(inputs, name, argv):
    g = j_cli.load_any(inputs[name]["otg"])
    argv = [{"PATH0": g.path_names[0], "PATH1": g.path_names[1]}.get(a, a) for a in argv]
    outputs = [a for a in argv if "{o}" in a]
    res = check(inputs, name, argv, outputs)
    assert res[1] or argv[0] == "kmers"


@pytest.mark.parametrize("name,argv,rc", [
    ("ov", ["bin"], 1),                                    # neither -n nor -w
    ("ov", ["pav", "-b", "BED", "-B", "2"], 1),            # a threshold past 1
    ("ov", ["tips", "-r", "absent"], "raise"),             # unknown path names
    ("ov", ["tips", "-q", "absent"], "raise"),
    ("inv", ["heaps", "-n", "1", "-b", "ABSENT_BED"], "raise"),
    ("inv", ["pav", "-b", "ABSENT_BED"], "raise"),
], ids=lambda v: v if isinstance(v, str) else words_id(v) if isinstance(v, list) else str(v))
def test_analytics_errors(inputs, name, argv, rc):
    p = inputs[name]
    if "ABSENT_BED" in argv:
        p["ABSENT_BED"] = os.path.join(p["dir"], "absent.bed")
        with open(p["ABSENT_BED"], "w") as f:
            f.write("absent#1#chr1\t0\t5\tx\n")
    check(inputs, name, argv, rc=rc)


@pytest.mark.parametrize("src", ["og", "gfa"])
def test_analytics_inputs(inputs, src):
    """The reference's .og and GFA as the input, and the long flags."""
    p = inputs["ov"]
    for argv in (["similarity"], ["heaps", "--idx", p[src], "--permutations", "2"],
                 ["pav", "--idx", p[src], "--bed-file", p["BED"], "--matrix-output"],
                 ["bin", "--num-bins", "4", "--json"]):
        if "--idx" not in argv:
            argv = [argv[0], "-i", p[src]] + argv[1:]
        assert run_both(p["dir"], argv)[0] == 0


# ---------------------------------------------------------------------------
# The modules against odgi_tpu's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs(inputs):
    out = {}
    for name in ("loop", "ov", "inv", "drb1"):
        gj = j_cli.load_any(inputs[name]["otg"])
        out[name] = (gj, graph_from_arrays(graph_to_arrays(gj)))
    return out


@pytest.mark.parametrize("name", ["loop", "ov", "inv", "drb1"])
def test_arrays_equal_odgi_tpu(graphs, name):
    """The Jaccard matrix, the tension of seeded coordinates, the path
    k-mers, the heaps curves and the bins, array for array."""
    gj, gt = graphs[name]
    assert np.array_equal(paths_cmd.path_jaccard_matrix(gt), j_pc.path_jaccard_matrix(gj))
    coords = np.random.default_rng(3).normal(size=(2 * gj.num_nodes, 2))
    assert np.array_equal(analytics.node_tension(gt, coords), j_an.node_tension(gj, coords))
    assert analytics.path_kmers(gt, 6) == j_an.path_kmers(gj, 6)
    for kw in (dict(n_permutations=3), dict(n_permutations=2, min_depth=2, seed=5)):
        assert np.array_equal(analytics.heaps_permutations(gt, **kw),
                              j_an.heaps_permutations(gj, **kw))
    for p in range(gj.num_paths):
        (bt, lt), (bj, lj) = (bin_cmd.path_bins(gt, p, 7, gt.node_offset),
                              j_bin.path_bins(gj, p, 7, gj.node_offset))
        assert lt == lj and sorted(bt) == sorted(bj)
        assert [vars(bt[k]) for k in sorted(bt)] == [vars(bj[k]) for k in sorted(bj)]


@settings(derandomize=True, deadline=None, max_examples=30)
@given(st.data())
def test_pav_table_equal_odgi_tpu(graphs, data):
    """pav_table over drawn ranges and groupings."""
    name = data.draw(st.sampled_from(["ov", "inv", "drb1"]))
    gj, gt = graphs[name]
    p = data.draw(st.integers(0, gj.num_paths - 1))
    n = int(gj.path_length[p])
    a = data.draw(st.integers(0, n - 1))
    b = data.draw(st.integers(a + 1, n))
    delim = data.draw(st.sampled_from([None, "#"]))
    tj = j_an.pav_table(gj, p, [(a, b)], group_delim=delim)
    tt = analytics.pav_table(gt, p, [(a, b)], group_delim=delim)
    assert tt[0] == tj[0] and np.array_equal(tt[1], tj[1])
