"""The port's layout0 against odgi_tpu's, on the CPU.

`sgd_layout` must give the same coordinates bit for bit (the same random
stream, chunks and accumulation order), `draw_svg` the same bytes, and
``layout0`` through both command lines the same stdout, stderr, exit code
and written file, on in-repo graphs of one and of several components."""

import contextlib
import io
import os

import numpy as np
import pytest

from odgi_tpu.algorithms import layout0 as j_layout0
from odgi_tpu.cli import main as j_cli
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.io.gfa import write_gfa as j_write_gfa
from odgi_tpu.io.og import save_graph as j_save_graph

from odgi_tpu_torch.algorithms import layout0
from odgi_tpu_torch.cli import main as t_cli
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays

from test_torch_render import inv_graph, synth_graph


def pieces_graph(seed=7, parts=(9, 1, 14, 5)):
    """Several weak components: chains with a bubble and a reversed node,
    one lone node, ids interleaved across the components."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    ids = rng.permutation(sum(parts)) + 1
    at = 0
    for k, n in enumerate(parts):
        part = [int(i) for i in ids[at:at + n]]
        at += n
        for i in part:
            b.add_node(i, bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 5))).astype(np.uint8)))
        p = b.add_path(f"p{k}")
        for j, i in enumerate(part):
            rev = j == 2
            if j:
                b.add_edge(part[j - 1], j - 1 == 2, i, rev)
            b.append_step(p, i, rev)
        if n > 4:
            b.add_edge(part[0], False, part[3], False)   # a bubble over nodes 1-2
    return b.build()


def empty_graph():
    return GraphBuilder().build()


GRAPHS = {"inv": lambda: inv_graph(), "pieces": pieces_graph,
          "drb1_cut": lambda: synth_graph(2_000, 400, 500)}


def both(name):
    gj = GRAPHS[name]()
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.mark.parametrize("seed", [42, 3])
@pytest.mark.parametrize("pivots", [0, 4, 16])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sgd_layout_bit_equal(name, pivots, seed):
    gj, gt = both(name)
    want = j_layout0.sgd_layout(gj, pivots=pivots, seed=seed)
    got = layout0.sgd_layout(gt, pivots=pivots, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.isfinite(got).all()


def test_components_are_laid_out_apart():
    """Each weak component on its own: pieces_graph has four, packed along x."""
    _, gt = both("pieces")
    from odgi_tpu_torch.algorithms.components import weak_components

    comps = weak_components(gt)
    assert len(comps) == 4
    xy = layout0.sgd_layout(gt, t_max=5)
    spans = sorted((xy[c, 0].min(), xy[c, 0].max()) for c in comps)
    assert all(a[1] < b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("scale", [5.0, 0.37])
@pytest.mark.parametrize("name", sorted(GRAPHS) + ["empty"])
def test_draw_svg_bytes(name, scale):
    if name == "empty":
        gj = empty_graph()
        gt = graph_from_arrays(graph_to_arrays(gj))
    else:
        gj, gt = both(name)
    xy = j_layout0.sgd_layout(gj, t_max=7)
    want, got = io.StringIO(), io.StringIO()
    j_layout0.draw_svg(want, xy, gj, scale)
    layout0.draw_svg(got, layout0.sgd_layout(gt, t_max=7), gt, scale)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith('<svg xmlns="http://www.w3.org/2000/svg"')


def run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv, **kw)
        except SystemExit as exc:
            rc = ("exit", exc.code)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("layout0")
    out = {"dir": str(d)}
    for name in ("inv", "pieces"):
        gj = GRAPHS[name]()
        j_write_gfa(gj, str(d / f"{name}.gfa"))
        j_save_graph(gj, str(d / f"{name}.otg"))
        out[name] = str(d / f"{name}.otg")
        out[name + "_gfa"] = str(d / f"{name}.gfa")
    return out


LAYOUT0_FLAGS = [
    [], ["-p", "4"], ["-p", "16", "-m", "12"], ["-e", "0.1", "-x", "3.5"], ["-R", "2"],
    ["-m", "1", "-p", "2", "-R", "0.5", "-x", "0"],
]


@pytest.mark.parametrize("flags", LAYOUT0_FLAGS, ids=lambda f: "_".join(f).replace("-", "") or "none")
@pytest.mark.parametrize("src", ["inv", "pieces", "pieces_gfa"])
def test_layout0_cli_file(files, src, flags):
    d = files["dir"]
    res = {}
    for tag, main, kw in (("j", j_cli.main, {}), ("t", t_cli.main, {"device": "cpu"})):
        out = os.path.join(d, f"{src}_{tag}.svg")
        res[tag] = run(main, ["layout0", "-i", files[src], "-o", out] + flags, **kw)
        with open(out, "rb") as f:
            res[tag] += (f.read(),)
    assert res["t"] == res["j"]
    assert res["t"][0] == 0 and res["t"][3].endswith(b"</svg>\n")


@pytest.mark.parametrize("src", ["inv", "pieces_gfa"])
def test_layout0_cli_stdout(files, src):
    """-o - writes the SVG to stdout."""
    res = [run(main, ["layout0", "-i", files[src], "-o", "-", "-p", "3"], **kw)
           for main, kw in ((j_cli.main, {}), (t_cli.main, {"device": "cpu"}))]
    assert res[0] == res[1] and res[1][0] == 0 and "<line " in res[1][1]


@pytest.mark.parametrize("argv", [["layout0", "-i", "MISSING", "-o", "-"],
                                  ["layout0", "-o", "-"],
                                  ["layout0", "-i", "GRAPH", "-o", "-", "-p", "x"]],
                         ids=["missing_file", "no_input", "bad_pivots"])
def test_layout0_cli_errors(files, argv):
    """A missing input file raises in both; bad flags exit 2 in both with
    the same error line (the program's name aside)."""
    argv = [files["inv"] if a == "GRAPH" else os.path.join(files["dir"], "nope.otg")
            if a == "MISSING" else a for a in argv]
    res = []
    for main, kw in ((j_cli.main, {}), (t_cli.main, {"device": "cpu"})):
        try:
            rc, out, err = run(main, argv, **kw)
            last = err.splitlines()[-1].replace("odgi_tpu_torch ", "odgi_tpu ")
            res.append((rc, out, last))
        except FileNotFoundError as exc:
            res.append(("raise", str(exc)))
    assert res[0] == res[1]
