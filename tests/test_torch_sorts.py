"""The port's host sorts and graph algorithms against odgi_tpu's, on the CPU:
every sort pipeline code, algorithms/sorts_extra.py, algorithms/graph_misc.py
and the per-iteration .og snapshots of sort -u.

All of it is host code copied from odgi_tpu, so the bar is exact: the same
node orders, the same graphs field for field, the same .og bytes.  The
graphs are in-repo: an acyclic bubble chain, a cyclic graph, one with
reversing joins and a reversing cycle, and a random walk graph with
shuffled node ids.
"""

import os

import numpy as np
import pytest

from odgi_tpu.algorithms import graph_misc as j_misc
from odgi_tpu.algorithms import path_sgd_sort as j_pss
from odgi_tpu.algorithms import sorts_extra as j_extra
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.io.og_compat import save_og as j_save_og

from odgi_tpu_torch.algorithms import graph_misc as t_misc
from odgi_tpu_torch.algorithms import path_sgd_sort as t_pss
from odgi_tpu_torch.algorithms import sorts_extra as t_extra
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.io.og_compat import save_og as t_save_og

CODES = "nfrbzwcdel"
INF = (1 << 63) - 1


def _pair(b: GraphBuilder):
    gj = b.build()
    return gj, graph_from_arrays(graph_to_arrays(gj))


def acyclic():
    """A chain of bubbles: 1 -> (2 | 3) -> 4 -> (5 | 6 -> 7) -> 8."""
    b = GraphBuilder()
    for i, s in enumerate([b"A", b"CC", b"G", b"TTT", b"A", b"C", b"GG", b"T"], 1):
        b.add_node(i, s)
    for a, c in [(1, 2), (1, 3), (2, 4), (3, 4), (4, 5), (4, 6), (6, 7), (5, 8), (7, 8)]:
        b.add_edge(a, False, c, False)
    for name, walk in (("x", [1, 2, 4, 5, 8]), ("y", [1, 3, 4, 6, 7, 8])):
        p = b.add_path(name)
        for n in walk:
            b.append_step(p, n, False)
    return _pair(b)


def cyclic():
    """A loop 2 -> 3 -> 4 -> 2 between a source and a sink, and a
    self-loop."""
    b = GraphBuilder()
    for i, s in enumerate([b"AC", b"G", b"TT", b"CAG", b"A", b"GG"], 1):
        b.add_node(i, s)
    for a, c in [(1, 2), (2, 3), (3, 4), (4, 2), (4, 5), (5, 5), (5, 6)]:
        b.add_edge(a, False, c, False)
    p = b.add_path("loop")
    for n in [1, 2, 3, 4, 2, 3, 4, 5, 5, 6]:
        b.append_step(p, n, False)
    return _pair(b)


def reversing():
    """Reversing joins (an inversion) and a reversing cycle."""
    b = GraphBuilder()
    for i, s in enumerate([b"ACG", b"T", b"GA", b"C", b"TTG"], 1):
        b.add_node(i, s)
    b.add_edge(1, False, 2, False)
    b.add_edge(2, False, 3, True)
    b.add_edge(3, True, 4, False)
    b.add_edge(1, False, 3, False)
    b.add_edge(3, False, 4, False)
    b.add_edge(4, False, 5, False)
    b.add_edge(5, False, 4, True)
    p = b.add_path("fwd")
    for n in [1, 3, 4, 5]:
        b.append_step(p, n, False)
    p = b.add_path("inv")
    for n, r in [(1, False), (2, False), (3, True), (4, False), (5, False), (4, True)]:
        b.append_step(p, n, r)
    return _pair(b)


def walk(seed=5, nodes=60, paths=4, steps=150):
    """Random walks with reversing joins and a self-loop, node ids shuffled."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, nodes + 1):
        b.add_node(i, bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 5)))))
    for pi in range(paths):
        p = b.add_path(f"HG{pi}#1#chr1")
        n, prev = int(rng.integers(1, nodes + 1)), None
        for _ in range(steps):
            rev = bool(rng.integers(0, 4) == 0)
            if prev is not None:
                b.add_edge(prev[0], prev[1], n, rev)
            b.append_step(p, n, rev)
            prev = (n, rev)
            n = int(np.clip(n + rng.integers(-2, 4), 1, nodes))
    b.add_edge(4, False, 4, False)
    gj = b.build().apply_ordering(rng.permutation(nodes), compact_ids=False)
    return gj, graph_from_arrays(graph_to_arrays(gj))


GRAPHS = {"acyclic": acyclic, "cyclic": cyclic, "reversing": reversing, "walk": walk}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    return GRAPHS[request.param]()


def same_graph(gj, gt) -> bool:
    a, b = graph_to_arrays(gj), graph_to_arrays(gt)
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def og_bytes(save, g, path) -> bytes:
    save(g, path)
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# The sort pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipeline", list(CODES) + ["gsbw", "nfrbzwcdel", "ecls", "dgs"])
def test_sort_pipeline_codes_equal_reference(pair, pipeline, tmp_path):
    gj, gt = pair
    out_j = j_pss.sort_pipeline(gj, pipeline)
    out_t = t_pss.sort_pipeline(gt, pipeline, device="cpu")
    assert same_graph(out_j, out_t)
    assert og_bytes(t_save_og, out_t, str(tmp_path / "t.og")) == \
        og_bytes(j_save_og, out_j, str(tmp_path / "j.og"))


def test_chunk_arguments_and_unknown_code(pair):
    gj, gt = pair
    for kw in (dict(bfs_chunk=3), dict(dfs_chunk=2)):
        assert same_graph(j_pss.sort_pipeline(gj, "bz", **kw),
                          t_pss.sort_pipeline(gt, "bz", device="cpu", **kw))
    with pytest.raises(ValueError, match="unsupported sort pipeline code 'x'"):
        t_pss.sort_pipeline(gt, "sx", device="cpu")


@pytest.mark.parametrize("name", ["breadth_first_topological_order",
                                  "depth_first_topological_order",
                                  "two_way_topological_order", "cycle_breaking_order",
                                  "dagify_sort_order"])
def test_sorts_extra_equal_reference(pair, name):
    gj, gt = pair
    want = getattr(j_extra, name)(gj)
    got = getattr(t_extra, name)(gt)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(gt.num_nodes))


# ---------------------------------------------------------------------------
# graph_misc.py
# ---------------------------------------------------------------------------


def test_split_strands_and_dagify_equal_reference(pair):
    gj, gt = pair
    sj, trj = j_misc.split_strands(gj)
    st, trt = t_misc.split_strands(gt)
    assert same_graph(sj, st) and trj == trt
    dj, dtrj = j_misc.dagify(sj, 1)
    dt, dtrt = t_misc.dagify(st, 1)
    assert same_graph(dj, dt) and dtrj == dtrt
    assert np.array_equal(t_misc.dagify_sort_order_exact(gt), j_misc.dagify_sort_order_exact(gj))
    # on the graph itself: the same DAG, or the same refusal of a reversing edge
    outcome = {}
    for tag, fn, g in (("j", j_misc.dagify, gj), ("t", t_misc.dagify, gt)):
        try:
            outcome[tag] = fn(g)
        except ValueError as exc:
            outcome[tag] = str(exc)
    if isinstance(outcome["j"], str):
        assert outcome["t"] == outcome["j"] and "single-stranded" in outcome["t"]
    else:
        assert same_graph(outcome["j"][0], outcome["t"][0])
        assert outcome["j"][1] == outcome["t"][1]


def test_acyclicity_and_walks_equal_reference(pair):
    gj, gt = pair
    oj, ot_ = j_misc.single_stranded_orientation(gj), t_misc.single_stranded_orientation(gt)
    assert (oj is None) == (ot_ is None)
    if oj is not None:
        assert np.array_equal(oj, ot_)
    assert t_misc.is_directed_acyclic(gt) == j_misc.is_directed_acyclic(gj)
    assert t_misc.is_acyclic(gt) == j_misc.is_acyclic(gj)
    assert t_misc.count_walks(gt) == j_misc.count_walks(gj)


def test_kinds_of_graph():
    """The three small graphs are what their names say."""
    assert t_misc.is_acyclic(acyclic()[1])
    assert t_misc.shortest_cycle_length(acyclic()[1]) == INF
    assert not t_misc.is_acyclic(cyclic()[1])
    assert t_misc.shortest_cycle_length(cyclic()[1]) < INF
    assert t_misc.single_stranded_orientation(reversing()[1]) is None


def test_orders_and_cycles_equal_reference(pair):
    gj, gt = pair
    assert np.array_equal(t_misc.eades_order(gt), j_misc.eades_order(gj))
    assert t_misc.shortest_cycle_length(gt) == j_misc.shortest_cycle_length(gj)
    for src in (0, gt.num_nodes - 1):
        assert t_misc.shortest_cycle_length(gt, src) == j_misc.shortest_cycle_length(gj, src)
    for kw in ({}, dict(bandwidth=20, sampling_rate=2.0, t_max=5, seed=3)):
        got = t_misc.linear_sgd_order(gt, **kw)
        assert got.dtype == np.int64 and np.array_equal(got, j_misc.linear_sgd_order(gj, **kw))


def test_forward_scc_equals_reference():
    rng = np.random.default_rng(2)
    for n in (1, 7, 40):
        succ = [sorted(set(rng.integers(0, n, int(rng.integers(0, 4))).tolist()))
                for _ in range(n)]
        assert t_misc._forward_scc(succ, n) == j_misc._forward_scc(succ, n)


# ---------------------------------------------------------------------------
# sort -u: a .og an iteration
# ---------------------------------------------------------------------------


def _fake_runs(monkeypatch, iters):
    """Replace both packages' 1D PG-SGD with one that feeds the snapshot
    callback the same positions each iteration (node offsets plus seeded
    noise) and returns the last, so both write from the same X."""

    def positions(g):
        rng = np.random.default_rng(11)
        return [g.node_offset + rng.normal(0, 30, g.num_nodes) for _ in range(iters)]

    def fake_j(g, cfg=None, use_paths=None, pin_nodes=None, snapshot_cb=None):
        xs = positions(g)
        for it, x in enumerate(xs):
            snapshot_cb(it, x)
        return xs[-1]

    def fake_t(g, cfg=None, use_paths=None, pin_nodes=None, snapshot_cb=None, device=None):
        import torch

        xs = positions(g)
        for it, x in enumerate(xs):
            snapshot_cb(it, x)
        return torch.as_tensor(xs[-1])

    monkeypatch.setattr(j_pss, "path_sgd_1d", fake_j)
    monkeypatch.setattr(t_pss, "path_sgd_1d", fake_t)


def test_sort_snapshots_equal_reference_on_the_same_positions(pair, tmp_path, monkeypatch):
    gj, gt = pair
    _fake_runs(monkeypatch, 4)
    out_j = j_pss.sort_pipeline(gj, "Ygs", snapshot_prefix=str(tmp_path / "j_snap"))
    out_t = t_pss.sort_pipeline(gt, "Ygs", snapshot_prefix=str(tmp_path / "t_snap"),
                                device="cpu")
    assert same_graph(out_j, out_t)
    for it in range(1, 5):
        with open(tmp_path / f"j_snap{it}", "rb") as a, open(tmp_path / f"t_snap{it}", "rb") as b:
            assert a.read() == b.read(), it
    assert not os.path.exists(tmp_path / "t_snap5")


def test_sort_snapshots_one_an_iteration(tmp_path):
    """A real batched run: one .og an iteration, the last the result."""
    _, gt = walk()
    prefix = str(tmp_path / "snap")
    out = t_pss.sort_pipeline(gt, "Y", sgd_overrides=dict(iter_max=5), snapshot_prefix=prefix,
                              device="cpu")
    assert sorted(os.listdir(tmp_path)) == [f"snap{i}" for i in range(1, 6)]
    t_save_og(out, str(tmp_path / "result.og"))
    with open(prefix + "5", "rb") as a, open(tmp_path / "result.og", "rb") as b:
        assert a.read() == b.read()
    with open(prefix + "1", "rb") as a, open(prefix + "5", "rb") as b:
        assert a.read() != b.read()
