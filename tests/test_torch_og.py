"""The port's graph IO against odgi_tpu's: the GFA parsers (native and
Python), the reference-compatible .og and the native .otg, byte for byte,
and the GraphTensors API the command line uses."""

import numpy as np
import pytest

from odgi_tpu.core.graph import GraphBuilder as JBuilder
from odgi_tpu.io import gfa as j_gfa
from odgi_tpu.io import og as j_og
from odgi_tpu.io import og_compat as j_ogc
from odgi_tpu.native import parse_gfa_native as j_native

from odgi_tpu_torch import native as t_native
from odgi_tpu_torch.convert import FIELDS, graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.core.graph import GraphBuilder as TBuilder
from odgi_tpu_torch.io import gfa as t_gfa
from odgi_tpu_torch.io import og as t_og
from odgi_tpu_torch.io import og_compat as t_ogc

# Integer names out of order, a reversing join, a self-loop, a W line with
# coordinates and one without.
GFA_INT = b"""H\tVN:Z:1.0
S\t3\tTTAC
S\t1\tACGT
S\t2\tGG
S\t10\tA
L\t1\t+\t2\t+\t0M
L\t2\t+\t3\t-\t0M
L\t3\t-\t10\t+\t0M
L\t1\t+\t3\t-\t0M
L\t10\t+\t10\t+\t0M
L\t2\t+\t3\t-\t0M
P\tx\t1+,2+,3-,10+,10+\t*
P\ty\t1+,3-,10+\t*
W\ts1\t0\tchr1\t0\t7\t>1<3>10
W\ts2\t1\tchr1\t*\t*\t>1>2
"""

# Non-integer segment names (ids above the largest integer name), a path
# over a reverse step and a self-inverse edge.
GFA_NAMES = b"""H\tVN:Z:1.0
S\tutig_a\tACGTTG
S\t7\tCC
S\tutig_b\tNNAT
S\tz\tg
L\tutig_a\t+\t7\t-\t0M
L\t7\t-\tutig_b\t+\t0M
L\tutig_b\t+\tutig_b\t-\t0M
L\tutig_b\t-\tz\t+\t0M
P\tsample#1#chr2\tutig_a+,7-,utig_b+,utig_b-,z+\t*
P\tsample#2#chr2\tz-,utig_b+,7+,utig_a-\t*
"""

GFAS = {"int_names": GFA_INT, "names": GFA_NAMES}


def random_graph(cls, seed=3, nodes=40, paths=5, steps=60):
    """A random walk graph: sparse ids, reversing joins, a self-loop, a
    circular path and an empty path."""
    rng = np.random.default_rng(seed)
    b = cls()
    ids = [int(i) for i in np.sort(rng.choice(np.arange(1, 4 * nodes), nodes, replace=False))]
    for i in ids:
        b.add_node(i, bytes(rng.choice(list(b"ACGTNacgt"), size=int(rng.integers(1, 6)))))
    for pi in range(paths):
        p = b.add_path(f"s{pi % 3}#{pi}#chr", circular=pi == 1)
        k, prev = int(rng.integers(0, nodes)), None
        for _ in range(steps):
            rev = bool(rng.integers(0, 2))
            if prev is not None:
                b.add_edge(prev[0], prev[1], ids[k], rev)
            b.append_step(p, ids[k], rev)
            prev = (ids[k], rev)
            k = int(np.clip(k + rng.integers(-3, 4), 0, nodes - 1))
    b.add_edge(ids[4], False, ids[4], True)
    b.add_path("empty")
    return b.build()


@pytest.fixture(scope="module")
def graphs():
    """name -> (odgi_tpu graph, port graph) over the same arrays."""
    out = {}
    for name, text in GFAS.items():
        gj = j_gfa.parse_gfa(text)
        out[name] = (gj, graph_from_arrays(graph_to_arrays(gj)))
    gj = random_graph(JBuilder)
    out["random"] = (gj, graph_from_arrays(graph_to_arrays(gj)))
    gj = random_graph(JBuilder, seed=9, nodes=300, paths=6, steps=700)
    out["walk"] = (gj, graph_from_arrays(graph_to_arrays(gj)))
    return out


def assert_same_graph(a, b):
    for k in FIELDS:
        if k == "path_names":
            assert tuple(a.path_names) == tuple(b.path_names)
        else:
            x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
            assert x.dtype == y.dtype and np.array_equal(x, y), k


# ---------------------------------------------------------------------------
# GFA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GFAS))
def test_native_parse_equals_python_and_odgi_tpu(name, tmp_path):
    path = tmp_path / f"{name}.gfa"
    path.write_bytes(GFAS[name])
    native = t_gfa.parse_gfa(str(path), device="cpu")
    assert t_gfa.LAST_PARSER["name"] == "native"
    python = t_gfa.parse_gfa(GFAS[name], device="cpu")
    assert t_gfa.LAST_PARSER["name"] == "python"
    ref = j_native(str(path))
    assert_same_graph(native, python)
    assert_same_graph(native, ref)
    assert_same_graph(native, j_gfa.parse_gfa(GFAS[name]))


def test_native_parse_of_a_written_graph(graphs, tmp_path):
    gj, gt = graphs["walk"]
    path = tmp_path / "walk.gfa"
    t_gfa.write_gfa(gt, str(path))
    with open(path, "rb") as f:
        python = t_gfa.parse_gfa(f, device="cpu")
    assert_same_graph(t_gfa.parse_gfa(str(path), device="cpu"), python)
    assert_same_graph(python, j_gfa.parse_gfa(str(path)))


def test_native_parse_missing_file_error():
    with pytest.raises(ValueError) as ours:
        t_gfa.parse_gfa("/nonexistent/x.gfa", device="cpu")
    with pytest.raises(ValueError) as theirs:
        j_native("/nonexistent/x.gfa")
    assert str(ours.value) == str(theirs.value) == "cannot open /nonexistent/x.gfa"


def test_native_parse_rejects_unknown_segment(tmp_path):
    path = tmp_path / "bad.gfa"
    path.write_bytes(b"S\t1\tA\nP\tp\t1+,2+\t*\n")
    with pytest.raises(ValueError, match="unknown segment"):
        t_gfa.parse_gfa(str(path), device="cpu")


def test_python_parse_when_native_is_unavailable(tmp_path, monkeypatch):
    path = tmp_path / "names.gfa"
    path.write_bytes(GFA_NAMES)
    monkeypatch.setattr(t_gfa, "parse_gfa_native", lambda p: None)
    g = t_gfa.parse_gfa(str(path), device="cpu")
    assert t_gfa.LAST_PARSER["name"] == "python"
    assert_same_graph(g, j_gfa.parse_gfa(GFA_NAMES))


def test_native_library_is_built_into_the_port(tmp_path):
    so = t_native.build()
    assert so == t_native.library_path()
    assert so.parent.name == "_build" and so.parent.parent.name == "odgi_tpu_torch"
    assert t_native.get_lib() is not None and t_native.build_error() is None


# ---------------------------------------------------------------------------
# .og (reference-compatible) and .otg (native)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int_names", "names", "random", "walk"])
def test_save_og_bytes_equal_odgi_tpu(graphs, name, tmp_path):
    gj, gt = graphs[name]
    j_ogc.save_og(gj, str(tmp_path / "j.og"))
    t_ogc.save_og(gt, str(tmp_path / "t.og"))
    assert (tmp_path / "t.og").read_bytes() == (tmp_path / "j.og").read_bytes()


@pytest.mark.parametrize("name", ["int_names", "names", "random", "walk"])
def test_load_og_of_odgi_tpu_bytes(graphs, name, tmp_path):
    gj, _ = graphs[name]
    j_ogc.save_og(gj, str(tmp_path / "j.og"))
    data = (tmp_path / "j.og").read_bytes()
    ours = t_ogc.load_og(data)
    # circularity is not part of .og, and the edges come back in an order
    # that re-encodes to the same bytes; everything else comes back as it was
    for k in FIELDS:
        if k not in ("path_names", "path_circular", "edge_from", "edge_to"):
            assert np.array_equal(getattr(ours, k), getattr(gj, k)), k
    assert sorted(zip(ours.edge_from.tolist(), ours.edge_to.tolist())) == \
        sorted(zip(gj.edge_from.tolist(), gj.edge_to.tolist()))
    t_ogc.save_og(ours, str(tmp_path / "again.og"))
    assert (tmp_path / "again.og").read_bytes() == data


def test_load_og_equals_odgi_tpu_load(graphs, tmp_path):
    gj, _ = graphs["walk"]
    gj = gj.keep_paths(range(gj.num_paths - 1))  # odgi_tpu cannot load the empty path
    j_ogc.save_og(gj, str(tmp_path / "j.og"))
    data = (tmp_path / "j.og").read_bytes()
    assert_same_graph(t_ogc.load_og(data), j_ogc.load_og(data))


def test_load_og_empty_paths(graphs, tmp_path):
    """odgi_tpu's load_og raises on an empty path (it looks up node id 1,
    which this graph lacks, and indexes past the steps for a last empty
    path); the port's reads the paths as empty, wherever they stand."""
    gj, _ = graphs["random"]
    assert 1 not in gj.id_to_rank and gj.path_step_count[-1] == 0
    j_ogc.save_og(gj, str(tmp_path / "j.og"))
    with pytest.raises(KeyError):
        j_ogc.load_og(str(tmp_path / "j.og"))
    order = [gj.num_paths - 1] + list(range(gj.num_paths - 1))
    for g in (gj, gj.keep_paths(order), gj.keep_paths([gj.num_paths - 1])):
        t_ogc.save_og(graph_from_arrays(graph_to_arrays(g)), str(tmp_path / "t.og"))
        ours = t_ogc.load_og(str(tmp_path / "t.og"))
        assert ours.path_names == g.path_names
        assert np.array_equal(ours.path_offset, g.path_offset)
        assert np.array_equal(ours.step_handle, g.step_handle)
        assert np.array_equal(ours.step_pos, g.step_pos)


def test_load_og_rejects_other_bytes():
    with pytest.raises(ValueError, match="bad magic"):
        t_ogc.load_og(b"OTGR0001" + b"\0" * 64)


@pytest.mark.parametrize("name", ["int_names", "names", "random", "walk"])
def test_otg_bytes_equal_odgi_tpu_and_round_trip(graphs, name, tmp_path):
    gj, gt = graphs[name]
    j_og.save_graph(gj, str(tmp_path / "j.otg"))
    t_og.save_graph(gt, str(tmp_path / "t.otg"))
    data = (tmp_path / "t.otg").read_bytes()
    assert data[:8] == t_og.MAGIC == j_og.MAGIC
    assert data == (tmp_path / "j.otg").read_bytes()
    assert_same_graph(t_og.load_graph(str(tmp_path / "j.otg")), gt)


# ---------------------------------------------------------------------------
# The GraphTensors API of the command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int_names", "names", "random", "walk"])
def test_graph_api_equals_odgi_tpu(graphs, name):
    gj, gt = graphs[name]
    assert gt.id_to_rank == gj.id_to_rank
    assert np.array_equal(gt.step_rank, gj.step_rank)
    assert np.array_equal(gt.step_node_pos, gj.step_node_pos)
    assert gt.is_optimized() == gj.is_optimized()
    assert gt.validate() == gj.validate()
    assert_same_graph(gt.optimize(), gj.optimize())
    assert gt.optimize().is_optimized()


def test_validate_reports_missing_edges():
    for cls in (JBuilder, TBuilder):
        b = cls()
        for i in (1, 2, 3):
            b.add_node(i, b"A")
        b.add_edge(1, False, 2, False)
        p = b.add_path("p")
        for i in (1, 2, 3):
            b.append_step(p, i, False)
        b.append_step_handle(p, (0 << 1) | 1)
        assert b.has_node(3) and not b.has_node(4)
        g = b.build()
        assert g.validate() == [
            "path 'p' step 1->2: missing edge between node ids 2 and 3",
            "path 'p' step 2->3: missing edge between node ids 3 and 1",
        ]
