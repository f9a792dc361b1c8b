"""The port's `odgi stats` functions against odgi_tpu's on the same graphs:
integers exact, floats within 1e-12 relative (the port sums per path in
f64 as odgi_tpu does, with torch on the CPU here)."""

import dataclasses

import numpy as np
import pytest
import torch

from odgi_tpu.algorithms import components as j_comp
from odgi_tpu.algorithms import stats as j_stats
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.io.gfa import parse_gfa as j_parse

from odgi_tpu_torch.algorithms import components as t_comp
from odgi_tpu_torch.algorithms import stats as t_stats
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays

RTOL = 1e-12

GFA = b"""H\tVN:Z:1.0
S\tutig_a\tACGTTG
S\t7\tCC
S\tutig_b\tNNAT
S\tz\tg
S\t2\tA
L\tutig_a\t+\t7\t-\t0M
L\t7\t-\tutig_b\t+\t0M
L\tutig_b\t+\tutig_b\t-\t0M
L\tutig_b\t-\tz\t+\t0M
L\t2\t+\t2\t+\t0M
P\tHG1#1#chr2\tutig_a+,7-,utig_b+,utig_b-,z+\t*
W\tHG2\t2\tchr2\t0\t9\t<z>utig_b>7<utig_a
P\tHG3#1#chr9\t2+,2+\t*
"""


def walk_graph(seed, nodes, paths, steps, shuffle=True):
    """Random walks over `nodes` nodes of 1-4 bp, mixed orientations, an
    edge for every step pair, a self-loop and a reversing self-edge."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, nodes + 1):
        b.add_node(i, bytes(rng.choice(list(b"ACGTacgtN"), size=int(rng.integers(1, 5)))))
    for pi in range(paths):
        p = b.add_path(f"sample{pi % 3}#{pi}#chr{pi % 2}")
        n, prev = int(rng.integers(1, nodes + 1)), None
        for _ in range(steps):
            rev = bool(rng.integers(0, 4) == 0)
            if prev is not None:
                b.add_edge(prev[0], prev[1], n, rev)
            b.append_step(p, n, rev)
            prev = (n, rev)
            n = int(np.clip(n + rng.integers(-2, 4), 1, nodes))
    b.add_edge(3, False, 3, False)
    b.add_edge(5, False, 5, True)
    g = b.build()
    return g.apply_ordering(rng.permutation(nodes), compact_ids=False) if shuffle else g


@pytest.fixture(scope="module", params=["gfa", "walk", "sorted_walk", "two_components"])
def pair(request):
    if request.param == "gfa":
        gj = j_parse(GFA)
    elif request.param == "walk":
        gj = walk_graph(1, 60, 5, 200)
    elif request.param == "sorted_walk":
        gj = walk_graph(2, 80, 4, 300, shuffle=False)
    else:
        a, b = walk_graph(3, 30, 2, 50, shuffle=False), walk_graph(4, 25, 3, 40)
        bb = GraphBuilder()
        for g, base in ((a, 0), (b, 100)):
            for r in range(g.num_nodes):
                bb.add_node(base + int(g.node_id[r]), g.node_seq(r))
            for x, y in zip(g.edge_from.tolist(), g.edge_to.tolist()):
                bb.add_edge(base + int(g.node_id[x >> 1]), bool(x & 1),
                            base + int(g.node_id[y >> 1]), bool(y & 1))
            for p in range(g.num_paths):
                pi = bb.add_path(f"{base}_{g.path_names[p]}")
                for h in g.step_handle[g.path_offset[p]:g.path_offset[p + 1]].tolist():
                    bb.append_step(pi, base + int(g.node_id[h >> 1]), bool(h & 1))
        gj = bb.build()
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.fixture(scope="module")
def xy(pair):
    gj, _ = pair
    rng = np.random.default_rng(11)
    return rng.normal(0, 50, 2 * gj.num_nodes), rng.normal(0, 50, 2 * gj.num_nodes)


def assert_same(a, b):
    """Same value: exact for integers and strings, RTOL for floats."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name))
    elif a is None:
        assert b is None
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray) and a.dtype.kind in "iub":
        assert b.dtype.kind in "iub" and np.array_equal(a, b)
    elif isinstance(a, (np.ndarray, float, np.floating)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_summary(pair):
    gj, gt = pair
    assert_same(j_stats.summary(gj), t_stats.summary(gt))


def test_base_content(pair):
    gj, gt = pair
    assert_same(j_stats.base_content(gj), t_stats.base_content(gt, device="cpu"))


@pytest.mark.parametrize("in_2d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("penalize", [True, False], ids=["penalize", "no_gap_links"])
def test_mean_links_length(pair, xy, in_2d, penalize):
    gj, gt = pair
    c = xy if in_2d else None
    assert_same(j_stats.mean_links_length(gj, xy=c, penalize_gap_links=penalize),
                t_stats.mean_links_length(gt, xy=c, penalize_gap_links=penalize,
                                          device="cpu"))


@pytest.mark.parametrize("in_2d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("orient", [False, True], ids=["plain", "orientation"])
def test_sum_of_path_node_distances(pair, xy, in_2d, orient):
    gj, gt = pair
    c = xy if in_2d else None
    assert_same(
        j_stats.sum_of_path_node_distances(gj, xy=c, penalize_diff_orientation=orient),
        t_stats.sum_of_path_node_distances(gt, xy=c, penalize_diff_orientation=orient,
                                           device="cpu"))


@pytest.mark.parametrize("fn", ["weighted_feedback_arcs", "weighted_reversing_joins",
                                "links_length_per_nuc", "unique_self_loop_nodes"])
def test_counts(pair, fn):
    gj, gt = pair
    assert_same(getattr(j_stats, fn)(gj), getattr(t_stats, fn)(gt, device="cpu"))


def test_nondeterministic_edges(pair):
    gj, gt = pair
    assert_same(j_stats.nondeterministic_edges(gj), t_stats.nondeterministic_edges(gt))


@pytest.mark.parametrize("delim,pos", [("#", 0), ("#", 2), ("_", 5), ("chr", 1)])
def test_pangenome_class_counts(pair, delim, pos):
    gj, gt = pair
    assert_same(j_stats.pangenome_class_counts(gj, delim, pos),
                t_stats.pangenome_class_counts(gt, delim, pos, device="cpu"))


def test_components_and_acyclicity(pair):
    gj, gt = pair
    cj, ct = j_comp.weak_components(gj), t_comp.weak_components(gt)
    assert_same(cj, ct)
    assert j_comp.num_self_loops(gj) == t_comp.num_self_loops(gt)
    assert [j_stats.component_is_acyclic(gj, c) for c in cj] == \
        [t_stats.component_is_acyclic(gt, c) for c in ct]


def test_acyclic_chain_and_cycle():
    """A forward chain is acyclic; closing it, or flipping one node's
    orientation halfway, makes it not."""
    for close, flip in ((False, False), (True, False), (False, True)):
        b = GraphBuilder()
        for i in range(1, 6):
            b.add_node(i, b"A")
        for i in range(1, 5):
            b.add_edge(i, False, i + 1, flip and i == 2)
        if close:
            b.add_edge(5, False, 1, False)
        gj = b.build()
        gt = graph_from_arrays(graph_to_arrays(gj))
        want = j_stats.component_is_acyclic(gj, np.arange(5))
        assert want == (not close and not flip)
        assert t_stats.component_is_acyclic(gt, np.arange(5)) == want


def test_empty_graph():
    gj = GraphBuilder().build()
    gt = graph_from_arrays(graph_to_arrays(gj))
    assert_same(j_stats.summary(gj), t_stats.summary(gt))
    assert_same(j_stats.base_content(gj), t_stats.base_content(gt, device="cpu"))
    assert_same(j_stats.mean_links_length(gj), t_stats.mean_links_length(gt, device="cpu"))
    assert_same(j_stats.links_length_per_nuc(gj), t_stats.links_length_per_nuc(gt, device="cpu"))
    assert_same(j_stats.pangenome_class_counts(gj, "#", 0),
                t_stats.pangenome_class_counts(gt, "#", 0, device="cpu"))


def test_array_metrics_need_a_card_by_default(pair):
    _, gt = pair
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    for call in (lambda: t_stats.base_content(gt), lambda: t_stats.mean_links_length(gt),
                 lambda: t_stats.weighted_feedback_arcs(gt),
                 lambda: t_stats.pangenome_class_counts(gt, "#", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
