"""The port's command line (`python -m odgi_tpu_torch.cli`) against
odgi_tpu's, both run in-process through `main(argv)` on the CPU.

The host commands (build, view, validate, stats, sort by s / gs / -s /
-L -M -A -R) must print the same stdout and stderr, exit with the same
code and write the same bytes.  The PG-SGD commands (sort Y, layout) take
odgi_tpu's own route there, so they are held against the port's Python
API bit for bit and against the JAX twin pipeline by node order and
LAYOUT_TOL."""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from odgi_tpu.algorithms import groom as j_groom
from odgi_tpu.algorithms import layout as j_layout
from odgi_tpu.algorithms import topological as j_topo
from odgi_tpu.algorithms.path_sgd_sort import order_from_x as j_order_from_x
from odgi_tpu.cli import main as j_cli
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.core.graph import GraphTensors as JGraph
from odgi_tpu.io.gfa import write_gfa as j_write_gfa
from odgi_tpu.ops import pallas_sgd as ps

import odgi_tpu_torch as ot
from odgi_tpu_torch.algorithms.layout import layout_to_tsv
from odgi_tpu_torch.cli import main as t_cli
from odgi_tpu_torch.convert import graph_to_arrays
from odgi_tpu_torch.io.og_compat import load_og, save_og
from odgi_tpu_torch.ops import sgd as t_sgd
from odgi_tpu_torch.ops.sgd import derive_config_2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT_TOL = 1e-4  # tests/test_torch_pipeline.py's bar against the twin layout

# Integer names out of order, a reversing join, a self-loop and W lines.
GFA_INT = """H\tVN:Z:1.0
S\t3\tTTAC
S\t1\tACGT
S\t2\tGG
S\t10\tA
S\t11\tCCA
L\t1\t+\t2\t+\t0M
L\t2\t+\t3\t-\t0M
L\t3\t-\t10\t+\t0M
L\t1\t+\t3\t-\t0M
L\t10\t+\t10\t+\t0M
L\t10\t+\t11\t+\t0M
P\tHG1#1#chr1\t1+,2+,3-,10+,10+,11+\t*
P\tHG2#1#chr1\t1+,3-,10+\t*
W\tHG3\t0\tchr1\t0\t7\t>1<3>10>11
W\tHG1\t2\tchr1\t*\t*\t>1>2
"""

# Non-integer segment names, a self-inverse edge, two components.
GFA_NAMES = """H\tVN:Z:1.0
S\tutig_a\tACGTTG
S\t7\tCC
S\tutig_b\tNNAT
S\tz\tg
S\tlone\tAC
S\tlone2\tT
L\tutig_a\t+\t7\t-\t0M
L\t7\t-\tutig_b\t+\t0M
L\tutig_b\t+\tutig_b\t-\t0M
L\tutig_b\t-\tz\t+\t0M
L\tlone\t+\tlone2\t+\t0M
P\tsample#1#chr2\tutig_a+,7-,utig_b+,utig_b-,z+\t*
P\tsample#2#chr2\tz-,utig_b+,utig_b-,7+,utig_a-\t*
P\tother#1#chr3\tlone+,lone2+\t*
"""

# A path over a missing edge: validate reports it.
GFA_BROKEN = """H\tVN:Z:1.0
S\t1\tA
S\t2\tC
S\t3\tG
L\t1\t+\t2\t+\t0M
P\tp\t1+,2+,3+,1-\t*
"""


def walk_graph(seed=5, nodes=60, paths=5, steps=150):
    """Random walks with reversing joins, a self-loop and a circular path,
    node ids shuffled so that the sorts have work to do."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, nodes + 1):
        b.add_node(i, bytes(rng.choice(list(b"ACGTN"), size=int(rng.integers(1, 5)))))
    for pi in range(paths):
        p = b.add_path(f"HG{pi % 3}#{pi}#chr{pi % 2}", circular=pi == 2)
        n, prev = int(rng.integers(1, nodes + 1)), None
        for _ in range(steps):
            rev = bool(rng.integers(0, 4) == 0)
            if prev is not None:
                b.add_edge(prev[0], prev[1], n, rev)
            b.append_step(p, n, rev)
            prev = (n, rev)
            n = int(np.clip(n + rng.integers(-2, 4), 1, nodes))
    b.add_edge(4, False, 4, False)
    return b.build().apply_ordering(rng.permutation(nodes), compact_ids=False)


def shuffled_graph():
    """tests/test_torch_pipeline.py's graph: 120 nodes, 3 x 1600 steps,
    node ids shuffled."""
    rng = np.random.default_rng(7)
    b = GraphBuilder()
    for i in range(1, 121):
        b.add_node(i, b"ACGT" * int(rng.integers(1, 5)))
    for i in range(1, 120):
        b.add_edge(i, False, i + 1, False)
    for pi in range(3):
        p = b.add_path(f"p{pi}")
        n = 1
        for _ in range(1600):
            b.append_step(p, n, bool(rng.integers(0, 2)))
            n = int(np.clip(n + rng.integers(-2, 3), 1, 120))
    return b.build().apply_ordering(np.random.default_rng(5).permutation(120))


def run(main, argv, **kw):
    """(exit code, stdout, stderr) of one in-process command."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def run_both(d, argv, outputs=()):
    """Run `argv` through both CLIs in `d`; "{o}" in an argument becomes
    "j" / "t".  Asserts equal exit codes, stdout, stderr and the bytes of
    each file in `outputs` (names with "{o}"); returns the port's result."""
    res = {}
    for tag, main, kw in (("j", j_cli.main, {}), ("t", t_cli.main, {"device": "cpu"})):
        res[tag] = run(main, [os.path.join(d, a.format(o=tag)) if "{o}" in a else a
                              for a in argv], **kw)
    assert res["t"] == res["j"]
    for name in outputs:
        with open(os.path.join(d, name.format(o="j")), "rb") as f:
            want = f.read()
        with open(os.path.join(d, name.format(o="t")), "rb") as f:
            assert f.read() == want, name
    return res["t"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> the paths of one graph as .gfa, .og and .otg (written by
    odgi_tpu), a .lay of random coordinates, and an id order file."""
    d = tmp_path_factory.mktemp("cli")
    texts = {"int": GFA_INT, "names": GFA_NAMES, "broken": GFA_BROKEN}
    buf = io.StringIO()
    j_write_gfa(walk_graph(), buf)
    texts["walk"] = buf.getvalue()
    out = {}
    for name, text in texts.items():
        gfa = str(d / f"{name}.gfa")
        with open(gfa, "w") as f:
            f.write(text)
        paths = dict(dir=str(d), gfa=gfa, og=str(d / f"{name}.og"), otg=str(d / f"{name}.otg"),
                     lay=str(d / f"{name}.lay"), order=str(d / f"{name}.order"))
        for ext in ("og", "otg"):
            assert run(j_cli.main, ["build", "-g", gfa, "-o", paths[ext]])[0] == 0
        g = ot.parse_gfa(gfa, device="cpu")
        rng = np.random.default_rng(len(name))
        ot.save_layout(rng.normal(0, 100, (2 * g.num_nodes, 2)), paths["lay"], device="cpu")
        with open(paths["order"], "w") as f:
            f.writelines(f"{i}\n" for i in rng.permutation(g.node_id))
        out[name] = paths
    return out


GRAPHS = ["int", "names", "walk"]

# ---------------------------------------------------------------------------
# The host commands: the same bytes as odgi_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["-O"], ["-s"]], ids=["plain", "O", "s"])
@pytest.mark.parametrize("ext", ["og", "otg", "gfa"])
@pytest.mark.parametrize("name", GRAPHS)
def test_build(inputs, name, ext, flags):
    p = inputs[name]
    run_both(p["dir"], ["build", "-g", p["gfa"], "-o", f"{{o}}_{name}.{ext}", *flags],
             outputs=[f"{{o}}_{name}.{ext}"])


@pytest.mark.parametrize("src", ["og", "otg", "gfa"])
@pytest.mark.parametrize("flag", ["-g", "-a", "-P"])
@pytest.mark.parametrize("name", GRAPHS)
def test_view(inputs, name, flag, src):
    rc, out, _ = run_both(inputs[name]["dir"], ["view", "-i", inputs[name][src], flag])
    assert rc == 0 and (out.startswith("H\tVN:Z:1.0\n") or flag == "-P")


@pytest.mark.parametrize("name", GRAPHS + ["broken"])
def test_validate(inputs, name):
    rc, _, err = run_both(inputs[name]["dir"], ["validate", "-i", inputs[name]["og"]])
    assert (rc, bool(err)) == ((1, True) if name == "broken" else (0, False))


STATS_FLAGS = [
    [], ["-S"], ["-W"], ["-L"], ["-b"], ["-l"], ["-l", "-g"], ["-s"], ["-s", "-d"],
    ["-w"], ["-j"], ["-p", "-l", "-s", "-w", "-j"], ["-p", "-l", "-g", "-s", "-d"], ["-N"],
    ["-q"], ["-a", "#,0"], ["-a", "#,1", "-D", "#"], ["-a", "_,9"], ["-a", "malformed"],
    ["-D", "#"], ["-f"], ["-s", "-c", "LAY"], ["-l", "-c", "LAY"], ["-p", "-s", "-d", "-c", "LAY"],
    ["-p", "-l", "-g", "-c", "LAY"], ["-y"], ["-y", "-W", "-L", "-b", "-l", "-g", "-s", "-d",
                                              "-w", "-j", "-q", "-a", "#,0", "-N", "-p"],
    ["-y", "-s", "-l", "-c", "LAY"], ["-m"], ["-m", "-c", "LAY"],
    ["--is-acyclic"], ["--count-walks"], ["--shortest-cycle"],
    ["-S", "--is-acyclic", "--count-walks", "--shortest-cycle"], ["-y", "--is-acyclic", "-W"],
]


@pytest.mark.parametrize("flags", STATS_FLAGS, ids=lambda f: "_".join(f).replace("-", "") or "none")
@pytest.mark.parametrize("name", GRAPHS)
def test_stats(inputs, name, flags):
    p = inputs[name]
    argv = ["stats", "-i", p["og"]] + [p["lay"] if f == "LAY" else f for f in flags]
    rc, out, _ = run_both(p["dir"], argv)
    assert rc == (1 if "malformed" in flags else 0)


SORT_FLAGS = [
    ["-p", "s"], ["-p", "gs"], ["-p", "g"], [], ["-O"], ["-s", "ORDER"], ["-L"], ["-M"], ["-A"],
    ["-R"], ["-L", "-D", "#"], ["-M", "-D", "#"], ["-A", "-D", "#"], ["-R", "-D", "#"],
    ["-p", "gs", "-A", "-D", "#"], ["-p", "s", "-e", "{o}_1d.lay"], ["-p", "gs", "-t", "4", "-P"],
    ["-b"], ["-z"], ["-r"], ["-n"], ["-w"], ["-c"], ["-d"], ["-b", "-B", "5"], ["-z", "-Z", "3"],
    *[["-p", c] for c in "nfrbzwcdel"], ["-p", "gsbw"], ["-p", "nfrbzwcdel"],
    ["-w", "-b"], ["-d", "-c", "-n"], ["-r", "-O", "-M"], ["-p", "ecl", "-e", "{o}_1d.lay"],
]


@pytest.mark.parametrize("ext", ["og", "gfa"])
@pytest.mark.parametrize("flags", SORT_FLAGS, ids=lambda f: "_".join(f).replace("-", "").replace("{o}_", "") or "s")
@pytest.mark.parametrize("name", GRAPHS)
def test_sort_host_codes(inputs, name, flags, ext):
    p = inputs[name]
    argv = ["sort", "-i", p["og"], "-o", f"{{o}}_sorted.{ext}"] + [
        p["order"] if f == "ORDER" else f for f in flags]
    outputs = [f"{{o}}_sorted.{ext}"] + [f for f in flags if "{o}" in f]
    rc, _, _ = run_both(p["dir"], argv, outputs=outputs)
    assert rc == 0


def test_sort_unknown_path_name(inputs):
    p = inputs["names"]
    names = os.path.join(p["dir"], "paths.txt")
    with open(names, "w") as f:
        f.write("sample#1#chr2\nnot_a_path\n")
    for flag in ("-f", "-H"):
        rc, _, err = run_both(p["dir"], ["sort", "-i", p["og"], "-o", "{o}.og", "-p", "Y",
                                         flag, names])
        assert rc == 1 and "not_a_path not found" in err


def test_sort_snapshots_equal_odgi_tpu(inputs, monkeypatch):
    """sort -u through both command lines, each package's 1D PG-SGD
    replaced by one that feeds the snapshot callback the same positions:
    the same .og bytes an iteration and the same result."""
    from odgi_tpu.algorithms import path_sgd_sort as j_pss
    from odgi_tpu_torch.algorithms import path_sgd_sort as t_pss

    def positions(g):
        rng = np.random.default_rng(3)
        return [g.node_offset + rng.normal(0, 20, g.num_nodes) for _ in range(3)]

    def fake(g, cfg=None, use_paths=None, pin_nodes=None, snapshot_cb=None, **kw):
        xs = positions(g)
        for it, x in enumerate(xs):
            snapshot_cb(it, x)
        return torch.as_tensor(xs[-1]) if "device" in kw else xs[-1]

    monkeypatch.setattr(j_pss, "path_sgd_1d", fake)
    monkeypatch.setattr(t_pss, "path_sgd_1d", fake)
    p = inputs["walk"]
    outputs = ["{o}_u.og"] + [f"{{o}}_snap{i}" for i in (1, 2, 3)]
    assert run_both(p["dir"], ["sort", "-i", p["og"], "-o", "{o}_u.og", "-p", "Ygs", "-u",
                               "{o}_snap"], outputs=outputs)[0] == 0
    assert not os.path.exists(os.path.join(p["dir"], "t_snap4"))


@pytest.fixture(scope="module")
def path_files(inputs):
    """name -> files of path names for `paths`: REFS (the first path),
    REFS2 (the second), GROUPS (an overlap grouping) and BAD (a name not in
    the graph)."""
    out = {}
    for name in GRAPHS:
        p = inputs[name]
        names = ot.parse_gfa(p["gfa"], device="cpu").path_names
        files = {}
        for key, text in (("REFS", f"{names[0]}\n"), ("REFS2", f"\n{names[1]}\n"),
                          ("GROUPS", f"g1\t{names[0]}\ng1\t{names[1]}\ng2\t{names[-1]}\n"
                                     f"g2\t{names[0]}\n{names[1]}\n"),
                          ("BAD", f"{names[0]}\nno_such_path\n")):
            files[key] = os.path.join(p["dir"], f"{name}_{key}.txt")
            with open(files[key], "w") as f:
                f.write(text)
        out[name] = files
    return out


PATHS_FLAGS = [
    ["-L"], ["-L", "-e"], ["-e"], ["-l"], ["-f"], ["-f", "-w", "3"], ["-H"], ["-H", "-D", "#"],
    ["-H", "-N"], ["-H", "-s", "-D", "#", "-p", "2"], ["-L", "-l", "-f", "-H"],
    ["--non-reference-nodes", "REFS"], ["--non-reference-nodes", "REFS", "--min-size", "2"],
    ["--non-reference-ranges", "REFS"],
    ["--non-reference-ranges", "REFS2", "--show-step-ranges", "--min-size", "2"],
    ["--coverage-levels", "1,2"], ["--coverage-levels", "3,1,2", "--min-size", "2"],
    ["--fraction-levels", "0.5,1", "-D", "#", "-p", "2"],
    ["--coverage-levels", "1,2", "--path-range-class", "--show-step-ranges"],
    ["--fraction-levels", "0.3,0.6", "--path-range-class", "-D", "#"],
    ["-O", "GROUPS"], ["-K", "REFS", "-o", "{o}_kept.og"], ["-X", "REFS", "-o", "{o}_drop.gfa"],
    ["-K", "REFS2", "-X", "REFS", "-o", "{o}_both.otg"], ["-K", "REFS"], ["-t", "2", "-P", "-l"],
]


@pytest.mark.parametrize("flags", PATHS_FLAGS,
                         ids=lambda f: "_".join(f).replace("-", "").replace("{o}_", "") or "none")
@pytest.mark.parametrize("name", GRAPHS)
def test_paths(inputs, path_files, name, flags):
    p = inputs[name]
    argv = ["paths", "-i", p["og"]] + [path_files[name].get(f, f) for f in flags]
    rc, _, _ = run_both(p["dir"], argv, outputs=[f for f in flags if "{o}" in f])
    assert rc == 0


@pytest.mark.parametrize("flags", [["--non-reference-nodes", "BAD"], ["-K", "BAD"],
                                   ["-H", "-D", "@"]], ids=["nodes", "keep", "delim"])
def test_paths_errors_equal_odgi_tpu(inputs, path_files, flags):
    """A name not in the graph, or a delimiter a path name lacks: both exit
    through SystemExit with the same code and stderr."""
    p = inputs["walk"]
    argv = ["paths", "-i", p["og"]] + [path_files["walk"].get(f, f) for f in flags]
    if flags[0] == "-H":
        argv = ["paths", "-i", p["og"], "--coverage-levels", "1", "-D", "@"]
    res = {}
    for tag, main, kw in (("j", j_cli.main, {}), ("t", t_cli.main, {"device": "cpu"})):
        with pytest.raises(SystemExit) as exc:
            run(main, argv, **kw)
        res[tag] = exc.value.code
    assert res["t"] == res["j"] and res["t"] not in (0, None)


def test_flag_surface_equals_odgi_tpu():
    """Every subcommand takes odgi_tpu's flags, flag for flag; the port has
    all 46 of odgi_tpu's subcommands: every one odgi_tpu/cli/main.py
    registers itself, and the pictures, edits, positions, indexes,
    analytics, layout0 and test of commands2.py / commands3.py."""

    def surface(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {
            name: [(tuple(a.option_strings), a.dest, a.default, a.type, a.choices,
                    a.required, a.nargs, type(a).__name__) for a in p._actions]
            for name, p in sub.choices.items()
        }

    ours, theirs = surface(t_cli.build_parser()), surface(j_cli.build_parser())
    assert sorted(ours) == sorted([
        "build", "layout", "paths", "sort", "stats", "validate", "version", "view",
        "depth", "degree", "viz", "draw", "chop", "unchop", "normalize", "flip", "prune",
        "explode", "squeeze", "flatten", "groom", "crush", "break", "unitig", "inject", "cover",
        "priv", "procbed", "untangle", "panpos", "position", "extract", "overlap",
        "pathindex", "stepindex", "server", "kmers", "matrix", "similarity", "tension",
        "heaps", "pav", "tips", "bin", "layout0", "test"])
    assert len(ours) == 46 and set(theirs) - set(ours) == set()
    for name in ours:
        assert ours[name] == theirs[name], name


# ---------------------------------------------------------------------------
# The PG-SGD commands: the port's API bit for bit, the JAX twins by order
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shuffled(tmp_path_factory):
    d = tmp_path_factory.mktemp("sgd")
    gj = shuffled_graph()
    gfa = str(d / "sh.gfa")
    j_write_gfa(gj, gfa)
    return str(d), gfa, gj


@pytest.fixture(scope="module")
def cli_sorted(shuffled):
    """build -> sort -p Ygs through the port's CLI."""
    d, gfa, _ = shuffled
    og, srt = os.path.join(d, "sh.og"), os.path.join(d, "sorted.og")
    assert run(t_cli.main, ["build", "-g", gfa, "-o", og], device="cpu") == (0, "", "")
    assert run(t_cli.main, ["sort", "-i", og, "-o", srt, "-p", "Ygs"], device="cpu") == \
        (0, "", "")
    return srt


def test_sort_Ygs_cli_equals_api_and_twins(shuffled, cli_sorted):
    d, gfa, gj = shuffled
    api = ot.sort_pipeline(ot.parse_gfa(gfa, device="cpu"), "Ygs", device="cpu")
    save_og(api, os.path.join(d, "api.og"))
    with open(cli_sorted, "rb") as a, open(os.path.join(d, "api.og"), "rb") as b:
        assert a.read() == b.read()
    # the twin pipeline of tests/test_torch_pipeline.py: the same node order
    gj2 = gj.apply_ordering(j_order_from_x(gj, ps.path_sgd_1d_strata_xla(gj)))
    gj2 = j_groom.apply_groom(gj2)
    gj2 = gj2.apply_ordering(j_topo.topological_order(gj2, use_heads=True))
    assert np.array_equal(load_og(cli_sorted).step_handle, gj2.step_handle)


def test_layout_cli_equals_api_and_twin(shuffled, cli_sorted):
    d, _, _ = shuffled
    lay, tsv = os.path.join(d, "cli.lay"), os.path.join(d, "cli.tsv")
    assert run(t_cli.main, ["layout", "-i", cli_sorted, "-o", lay, "-T", tsv],
               device="cpu") == (0, "", "")
    g = load_og(cli_sorted)
    coords = ot.layout_graph(g, device="cpu")
    ot.save_layout(coords, os.path.join(d, "api.lay"), device="cpu")
    with open(lay, "rb") as a, open(os.path.join(d, "api.lay"), "rb") as b:
        assert a.read() == b.read()
    buf = io.StringIO()
    layout_to_tsv(coords, buf)
    with open(tsv) as f:
        assert f.read() == buf.getvalue()
    # the twin from the same sorted graph and initial coordinates
    gjs = JGraph(**graph_to_arrays(g))
    c0 = j_layout.init_layout(gjs, "d")
    twin = j_layout.pack_components(gjs, np.asarray(ps.path_sgd_2d_strata_xla(gjs, c0)))
    got = ot.load_layout(lay)
    assert np.abs(got - twin).max() / (np.abs(twin).max() + 1) <= LAYOUT_TOL


def test_sort_sgd_flags_map_onto_the_api(shuffled):
    d, gfa, _ = shuffled
    out = os.path.join(d, "flags.og")
    argv = ["sort", "-i", gfa, "-o", out, "-Y", "-x", "7", "-q", "42", "-U", "3", "-v", "50",
            "-g", "0.02", "-K", "0.4", "-F", "2", "-a", "0.9", "-k", "20", "-I", "80", "-l", "40"]
    assert run(t_cli.main, argv, device="cpu")[0] == 0
    g = ot.parse_gfa(gfa, device="cpu")
    api = ot.sort_pipeline(g, "Y", sgd_overrides=dict(
        iter_max=7, seed=42, min_term_updates=3 * g.num_nodes, eta_max=50.0, eps=0.02,
        cooling_start=0.4, iter_with_max_learning_rate=2, theta=0.9, space=20, space_max=80,
        space_quantization_step=40), device="cpu")
    assert np.array_equal(load_og(out).step_handle, api.step_handle)


def test_sort_target_and_use_paths(shuffled):
    d, gfa, _ = shuffled
    names = os.path.join(d, "names.txt")
    with open(names, "w") as f:
        f.write("p0\n\np2\n")
    g = ot.parse_gfa(gfa, device="cpu")
    for flag, kw in (("-H", "target_paths"), ("-f", "use_paths")):
        out = os.path.join(d, f"paths{flag}.og")
        assert run(t_cli.main, ["sort", "-i", gfa, "-o", out, "-p", "Y", "-x", "3", flag, names],
                   device="cpu")[0] == 0
        api = ot.sort_pipeline(g, "Y", sgd_overrides=dict(iter_max=3), device="cpu",
                               **{kw: [0, 2]})
        assert np.array_equal(load_og(out).step_handle, api.step_handle)


@pytest.mark.parametrize("init", ["d", "u", "h"])
def test_layout_flags_map_onto_the_api(shuffled, cli_sorted, init):
    d, _, _ = shuffled
    out = os.path.join(d, f"flags_{init}.lay")
    argv = ["layout", "-i", cli_sorted, "-o", out, "-x", "4", "-q", "3", "-G", "2", "-N", init,
            "-j", "0", "-a", "0.95"]
    assert run(t_cli.main, argv, device="cpu")[0] == 0
    g = load_og(cli_sorted)
    cfg = derive_config_2d(g, iter_max=4, seed=3, min_term_updates=2 * g.num_steps,
                           delta=0.0, theta=0.95)
    want = ot.layout_graph(g, cfg, init_mode=init, device="cpu")
    assert np.abs(ot.load_layout(out) - want).max() <= 1e-9 * (np.abs(want).max() + 1)


def test_layout_snapshots_and_progress(shuffled, cli_sorted):
    d, _, _ = shuffled
    prefix = os.path.join(d, "snap")
    rc, _, err = run(t_cli.main, ["layout", "-i", cli_sorted, "-x", "3", "-u", prefix, "-P"],
                     device="cpu")
    assert rc == 0 and t_sgd.LAST_RUN["route"] == "batched"
    assert sorted(os.listdir(d)).count("snap3") == 1 and not os.path.exists(prefix + "4")
    rc, _, err = run(t_cli.main, ["layout", "-i", cli_sorted, "-x", "3", "-P"], device="cpu")
    assert rc == 0 and "[odgi_tpu_torch::layout] 2D PG-SGD iterations" in err
    assert "100.00%" in err


def test_sort_progress(shuffled):
    d, gfa, _ = shuffled
    rc, _, err = run(t_cli.main, ["sort", "-i", gfa, "-o", os.path.join(d, "p.og"), "-p", "Y",
                                  "-x", "3", "-P"], device="cpu")
    assert rc == 0 and "[odgi_tpu_torch::sort] 1D PG-SGD iterations" in err
    assert "100.00%" in err and t_sgd.LAST_RUN["route"] == "batched"


# ---------------------------------------------------------------------------
# --metrics and --profile
# ---------------------------------------------------------------------------


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert isinstance(r.pop("wall_s"), float)
    return recs


def test_sort_metrics_equal_odgi_tpu(inputs):
    p = inputs["walk"]
    run_both(p["dir"], ["sort", "-i", p["og"], "-o", "{o}_m.og", "-p", "gs", "--metrics",
                        "{o}_sort.jsonl"], outputs=["{o}_m.og"])
    recs = _records(os.path.join(p["dir"], "t_sort.jsonl"))
    assert recs == _records(os.path.join(p["dir"], "j_sort.jsonl"))
    assert recs == [dict(kind="sort1d_summary", pipeline="gs", nodes=60, steps=750)]


def test_sort_Ygs_metrics(shuffled):
    d, gfa, gj = shuffled
    path = os.path.join(d, "ygs.jsonl")
    assert run(t_cli.main, ["sort", "-i", gfa, "-o", os.path.join(d, "m.og"), "-p", "Ygs",
                            "--metrics", path], device="cpu")[0] == 0
    assert _records(path) == [dict(kind="sort1d_summary", pipeline="Ygs",
                                   nodes=gj.num_nodes, steps=gj.num_steps)]


def test_layout_metrics_records_and_keys_equal_odgi_tpu(shuffled):
    d, gfa, _ = shuffled
    recs = {}
    for tag, main, kw in (("j", j_cli.main, {}), ("t", t_cli.main, {"device": "cpu"})):
        path = os.path.join(d, f"{tag}_layout.jsonl")
        assert run(main, ["layout", "-i", gfa, "-x", "4", "--metrics", path], **kw)[0] == 0
        recs[tag] = _records(path)
    assert t_sgd.LAST_RUN["route"] == "batched"
    assert [sorted(r) for r in recs["t"]] == [sorted(r) for r in recs["j"]]
    assert [(r["kind"], r.get("iter")) for r in recs["t"]] == \
        [(r["kind"], r.get("iter")) for r in recs["j"]]
    assert recs["t"][-1] == recs["j"][-1]  # iter_max and min_term_updates
    assert [r["kind"] for r in recs["t"]] == ["layout2d"] * 4 + ["layout2d_summary"]
    assert all(r["delta_max"] > 0 for r in recs["t"][1:4])


@pytest.mark.parametrize("cmd", ["sort", "layout"])
def test_profile_writes_a_trace(shuffled, cli_sorted, cmd):
    d, gfa, _ = shuffled
    trace_dir = os.path.join(d, f"trace_{cmd}")
    argv = (["sort", "-i", gfa, "-o", os.path.join(d, "prof.og"), "-p", "Y", "-x", "2"]
            if cmd == "sort" else ["layout", "-i", cli_sorted, "-x", "2"])
    assert run(t_cli.main, argv + ["--profile", trace_dir], device="cpu")[0] == 0
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("cat") == "cpu_op" for e in events)


# ---------------------------------------------------------------------------
# The version and the device
# ---------------------------------------------------------------------------


def test_version():
    for flags, want in (([], "v0.1.0-systolic pangenome"), (["-v"], "v0.1.0-torch"),
                        (["-r"], "v0.1.0"), (["-c"], "systolic pangenome")):
        assert run(t_cli.main, ["version", *flags], device="cpu") == (0, want + "\n", "")


def test_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["version"])
    res = subprocess.run([sys.executable, "-m", "odgi_tpu_torch.cli", "version"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr and res.stdout == ""


# ---------------------------------------------------------------------------
# test: the port's own tests, in a subprocess
# ---------------------------------------------------------------------------


def port_test(extra, block=()):
    """`main(["test", "--", *extra], device="cpu")` in a subprocess from the
    repo root, with the modules in `block` made unimportable."""
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in block)
            + "from odgi_tpu_torch.cli.main import main\n"
            + f"sys.exit(main(['test', '--', *{list(extra)!r}], device='cpu'))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))


PORT_TEST_FILES = sorted(os.path.basename(f) for f in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))


def test_port_test_runs_a_narrow_selection():
    """Every port test file collected (jax is installed here), one test run."""
    res = port_test(["-k", "test_no_jax_or_odgi_tpu_import and chip_smoke"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "1 passed" in res.stdout and "leaving out" not in res.stderr


def test_port_test_named_files_replace_the_default():
    """A named file runs alone (once); without jax, a named file that
    imports odgi_tpu is left out, and nothing left exits 5."""
    res = port_test(["tests/test_torch_import.py", "-k", "chip_smoke"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "1 passed, " in res.stdout and " 1 deselected" not in res.stdout
    res = port_test(["tests/test_torch_layout0.py::test_components_are_laid_out_apart"],
                    block=("jax",))
    assert res.returncode == 5 and "test_torch_layout0.py" in res.stderr, res.stdout + res.stderr


def test_port_test_without_jax_leaves_out_odgi_tpu_files():
    """Where jax cannot be imported, the files that import odgi_tpu or jax
    (read, not imported) are left out and named on stderr; the rest run."""
    res = port_test(["-k", "test_no_jax_or_odgi_tpu_import and chip_smoke"], block=("jax",))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "1 passed" in res.stdout
    left = res.stderr.split("that import it: ")[1].split()
    assert {"test_torch_compat.py", "test_torch_cli.py", "test_torch_layout0.py"} <= set(left)
    assert sorted(set(PORT_TEST_FILES) - set(left)) == [
        "test_torch_bcast.py", "test_torch_chrom_sort.py", "test_torch_cuda.py",
        "test_torch_import.py", "test_torch_spans.py"]


def test_port_test_empty_selection_exits_5():
    res = port_test(["-k", "no_test_has_this_name"], block=("jax",))
    assert res.returncode == 5, res.stdout + res.stderr


def test_port_test_without_pytest_runs_inline_checks():
    res = port_test([], block=("pytest",))
    assert (res.returncode, res.stdout) == (0, "All tests passed\n"), res.stderr
