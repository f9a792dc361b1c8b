"""The port's vg helper algorithms and Mondriaan sort against odgi_tpu's,
on the CPU, exact: every function of ``algorithms/vg_algos.py`` over every
handle of chain, bubble, reversing and cyclic graphs (and the DRB1-scale
synthetic graph), and ``mondriaan_sort`` at 1, 2 and 8 parts under each
weighting."""

import numpy as np
import pytest

from odgi_tpu.algorithms import mondriaan as j_mondriaan
from odgi_tpu.algorithms import vg_algos as j_va
from odgi_tpu.compat import odgi as j_odgi
from odgi_tpu.core.graph import GraphBuilder

from odgi_tpu_torch.algorithms import mondriaan, vg_algos as va
from odgi_tpu_torch.compat import odgi as t_odgi
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays

from test_torch_render import inv_graph, synth_graph


def build(nodes, edges, paths):
    """nodes: {id: seq}; edges: (id, rev, id, rev); paths: {name: [(id, rev)]}."""
    b = GraphBuilder()
    for i, s in nodes.items():
        b.add_node(i, s)
    for e in edges:
        b.add_edge(*e)
    for name, steps in paths.items():
        p = b.add_path(name)
        for i, rev in steps:
            b.append_step(p, i, rev)
    return b.build()


def chain():
    n = {i: b"ACG"[: 1 + i % 3] * 2 for i in range(1, 8)}
    return build(n, [(i, False, i + 1, False) for i in range(1, 7)],
                 {"p": [(i, False) for i in range(1, 8)]})


def bubble():
    n = {1: b"AC", 2: b"G", 3: b"TTTT", 4: b"CA", 5: b"GGG", 6: b"T", 9: b"AAAAA", 10: b"C"}
    e = [(1, False, 2, False), (1, False, 3, False), (2, False, 4, False), (3, False, 4, False),
         (4, False, 5, False), (4, False, 6, False), (5, False, 9, False), (6, False, 9, False),
         (9, False, 10, False)]
    return build(n, e, {"a": [(1, False), (2, False), (4, False), (5, False), (9, False), (10, False)],
                        "b": [(1, False), (3, False), (4, False), (6, False), (9, False)]})


def reversing():
    """An inversion: 2 is traversed backwards by one path, with the
    doubly reversing edge 4- -> 3-."""
    n = {1: b"ACGT", 2: b"GG", 3: b"TAC", 4: b"A", 5: b"CCA"}
    e = [(1, False, 2, False), (2, False, 3, False), (1, False, 2, True), (2, True, 3, False),
         (4, True, 3, True), (4, False, 5, False)]
    return build(n, e, {"f": [(1, False), (2, False), (3, False), (4, False), (5, False)],
                        "r": [(1, False), (2, True), (3, False)]})


def cyclic():
    """A loop back from 4 to 2 and a self loop on 5."""
    n = {1: b"A", 2: b"CG", 3: b"T", 4: b"GGA", 5: b"C", 6: b"TT"}
    e = [(1, False, 2, False), (2, False, 3, False), (3, False, 4, False), (4, False, 2, False),
         (4, False, 5, False), (5, False, 5, False), (5, False, 6, False)]
    return build(n, e, {"c": [(1, False), (2, False), (3, False), (4, False), (2, False),
                              (3, False), (4, False), (5, False), (5, False), (6, False)]})


GRAPHS = {"chain": chain, "bubble": bubble, "reversing": reversing, "cyclic": cyclic,
          "inv": lambda: inv_graph(nodes=30, paths=4)}


def both(name):
    gj = GRAPHS[name]()
    return gj, graph_from_arrays(graph_to_arrays(gj))


def handles(g):
    return list(range(2 * g.num_nodes))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_head_and_tail_nodes(name):
    gj, gt = both(name)
    for h in handles(gj):
        assert va.is_head_node(gt, h) == j_va.is_head_node(gj, h)
        assert va.is_tail_node(gt, h) == j_va.is_tail_node(gj, h)


@pytest.mark.parametrize("limit", [0, 3, 7, 1000])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_distance_to_head_and_tail(name, limit):
    gj, gt = both(name)
    for h in handles(gj):
        assert va.distance_to_head(gt, h, limit) == j_va.distance_to_head(gj, h, limit)
        assert va.distance_to_tail(gt, h, limit) == j_va.distance_to_tail(gj, h, limit)


@pytest.mark.parametrize("leftward", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_find_shortest_paths(name, leftward):
    """The same distances, inserted in the same order."""
    gj, gt = both(name)
    for h in handles(gj):
        got = va.find_shortest_paths(gt, h, leftward)
        want = j_va.find_shortest_paths(gj, h, leftward)
        assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["drb1_cut"])
def test_sorted_id_ranges(name):
    gj = synth_graph(3_000, 500, 600) if name == "drb1_cut" else GRAPHS[name]()
    gt = graph_from_arrays(graph_to_arrays(gj))
    want = j_va.sorted_id_ranges(gj)
    assert va.sorted_id_ranges(gt) == want
    assert all(isinstance(v, int) for r in want for v in r)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_extend(name):
    """extend() into a compat graph that holds some nodes and an edge
    already: the same nodes, edges (in insertion order) and handles."""
    gj, gt = both(name)
    into = []
    for mod in (j_odgi, t_odgi):
        g = mod.graph()
        g.create_handle("ACGTACGT", 1)
        g.create_handle("T", 1000)
        g.create_edge(g.get_handle(1000), g.get_handle(1))
        into.append(g)
    j_va.extend(gj, into[0])
    va.extend(gt, into[1])
    assert into[1]._seqs == into[0]._seqs
    assert list(into[1]._edges) == list(into[0]._edges)
    assert into[1]._next_id == into[0]._next_id


def a_star_cases(g):
    """(pos_1, pos_2) pairs over every pair of handles, offsets inside them."""
    rng = np.random.default_rng(g.num_nodes)
    out = []
    for h1 in handles(g):
        for h2 in handles(g):
            l1, l2 = int(g.node_len[h1 >> 1]), int(g.node_len[h2 >> 1])
            out.append(((h1, int(rng.integers(0, l1))), (h2, int(rng.integers(0, l2)))))
    return out


@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("name", ["chain", "bubble", "reversing", "cyclic"])
def test_a_star_min(name, heuristic):
    gj, gt = both(name)
    h = (lambda a, b: abs((a >> 1) - (b >> 1)) // 4) if heuristic else None
    for p1, p2 in a_star_cases(gj):
        want = j_va.a_star(gj, p1, p2, h)
        assert va.a_star(gt, p1, p2, h) == want
        assert va.a_star(gt, p1, p2, h, extremal_distance=3) == j_va.a_star(
            gj, p1, p2, h, extremal_distance=3)


@pytest.mark.parametrize("bound", [0, 5, 20])
@pytest.mark.parametrize("name", ["chain", "bubble", "reversing"])
def test_a_star_max(name, bound):
    """The max case on the acyclic graphs (on a cycle it explores every walk
    up to its runaway guard, 10^6 nt, in both packages)."""
    gj, gt = both(name)
    for p1, p2 in a_star_cases(gj):
        want = j_va.a_star(gj, p1, p2, find_min=False, extremal_distance=bound)
        assert va.a_star(gt, p1, p2, find_min=False, extremal_distance=bound) == want


@pytest.mark.parametrize("weights", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["plain", "depth", "delta", "depth_delta"])
@pytest.mark.parametrize("parts", [1, 2, 8])
@pytest.mark.parametrize("name", ["chain", "bubble", "reversing", "cyclic", "inv", "drb1_cut"])
def test_mondriaan_sort(name, parts, weights):
    gj = synth_graph(3_000, 500, 600) if name == "drb1_cut" else GRAPHS[name]()
    gt = graph_from_arrays(graph_to_arrays(gj))
    for seed in (0, 5):
        want = j_mondriaan.mondriaan_sort(gj, parts, 0.03, *weights, seed=seed)
        got = mondriaan.mondriaan_sort(gt, parts, 0.03, *weights, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(np.sort(got), np.arange(gt.num_nodes))


def test_mondriaan_sort_empty():
    gj = GraphBuilder().build()
    gt = graph_from_arrays(graph_to_arrays(gj))
    assert np.array_equal(mondriaan.mondriaan_sort(gt, 4),
                          j_mondriaan.mondriaan_sort(gj, 4))
