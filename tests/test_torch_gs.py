"""The host passes of a sort's ``g`` and ``s`` steps, in C++ and in Python.

- `SideAdjacency.build`'s packed-key dedupe (and its row form past the
  int64 bound) equals the `np.unique(axis=0)` form it replaced.
- The groom flip mask (with and without target paths) and the topological
  order (from the heads, the tails, neither) are array-equal on both paths
  (``native/src/graph_passes.cpp`` and the Python loops) and to odgi_tpu's.
- The structural counters read the same on both paths, and each call adds
  one run to ``gs.native`` or ``gs.python``.
- The C++ refuses a handle not below 2N.
"""

import numpy as np
import pytest

from odgi_tpu.algorithms import groom as j_groom
from odgi_tpu.algorithms import topological as j_topo
from odgi_tpu.core.graph import GraphBuilder

from odgi_tpu_torch import native
from odgi_tpu_torch.algorithms import groom, topological
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.core import graph as core_graph
from odgi_tpu_torch.core.graph import SideAdjacency, handle_flip
from odgi_tpu_torch.utils.metrics import TOTALS

from test_torch_host import _small_graph


@pytest.fixture(params=["native", "python"])
def gs_path(request, monkeypatch):
    """The groom walk and the topological order in C++, which has to load,
    or in Python, the library taken away."""
    if request.param == "native":
        assert native.gs_lib() is not None, native._gs["error"]
    else:
        monkeypatch.setattr(native, "gs_lib", lambda: None)
    return request.param


def _cycles():
    """Three rings of 5 nodes with chords, some reversing: every node has an
    edge on its left, so there is no head and the order restarts."""
    b = GraphBuilder()
    for i in range(1, 16):
        b.add_node(i, b"AC")
    for base in (0, 5, 10):
        for k in range(5):
            b.add_edge(base + k + 1, False, base + (k + 1) % 5 + 1, False)
    b.add_edge(3, False, 1, True)
    b.add_edge(7, True, 9, False)
    b.add_edge(12, False, 14, False)
    b.add_edge(15, True, 11, True)
    p = b.add_path("ring")
    for k in (1, 2, 3, 4, 5, 1, 2):
        b.append_step(p, k, False)
    q = b.add_path("rev")
    for k in (9, 8, 7, 6):
        b.append_step(q, k, True)
    return b.build()


def _self_inverse():
    """A chain with a self-inverse edge (3+ -> 3-), its mirror the same
    edge, a reversing self-loop on the left (5- -> 5+) and a plain loop."""
    b = GraphBuilder()
    for i in range(1, 9):
        b.add_node(i, b"G")
    for i in range(1, 8):
        b.add_edge(i, False, i + 1, False)
    b.add_edge(3, False, 3, True)
    b.add_edge(5, True, 5, False)
    b.add_edge(6, False, 6, False)
    b.add_edge(8, False, 2, True)
    p = b.add_path("p")
    for k, rev in ((1, False), (2, False), (3, False), (3, True), (2, True), (6, False)):
        b.append_step(p, k, rev)
    return b.build()


def _components():
    """Four components: two chains, one with reversing edges, a ring and an
    isolated node."""
    b = GraphBuilder()
    for i in range(1, 26):
        b.add_node(i, b"T")
    for i in range(1, 8):
        b.add_edge(i, False, i + 1, False)
    for i in range(9, 16):
        b.add_edge(i, i % 3 == 0, i + 1, i % 4 == 0)
    for i in range(17, 24):
        b.add_edge(i, False, i + 1 if i < 23 else 17, False)
    for name, steps in (("a", (1, 2, 3)), ("b", (12, 11, 10)), ("c", (20, 21, 17))):
        p = b.add_path(name)
        for k in steps:
            b.append_step(p, k, name == "b")
    return b.build()


def _one_node():
    b = GraphBuilder()
    b.add_node(1, b"ACGT")
    p = b.add_path("p")
    b.append_step(p, 1, True)
    return b.build()


GRAPHS = {
    "chain": lambda: _small_graph(edge_noise=False),
    "noisy": lambda: _small_graph(edge_noise=True),
    "noisy-other": lambda: _small_graph(seed=11, n=300, paths=4, steps=900, edge_noise=True),
    "cycles": _cycles,
    "self-inverse": _self_inverse,
    "components": _components,
    "one-node": _one_node,
    "empty": lambda: GraphBuilder().build(),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    gj = GRAPHS[request.param]()
    return gj, graph_from_arrays(graph_to_arrays(gj))


def _runs(name):
    return TOTALS.get(name, {}).get("runs", 0)


COUNTERS = ("groom.flipped", "groom.restarts", "topological_order.seeded",
            "topological_order.restarts")


# ---------------------------------------------------------------------------
# SideAdjacency
# ---------------------------------------------------------------------------


def _adjacency_unique_form(g):
    """`SideAdjacency.build` as the `np.unique(axis=0)` form it replaced."""
    n2 = 2 * g.num_nodes
    src = np.concatenate([g.edge_from, handle_flip(g.edge_to)])
    dst = np.concatenate([g.edge_to, handle_flip(g.edge_from)])
    pairs = np.stack([src, dst], axis=1)
    pairs = np.unique(pairs, axis=0) if len(pairs) else pairs.reshape(0, 2)
    src, dst = (pairs[:, 0], pairs[:, 1]) if len(pairs) else (src[:0], dst[:0])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n2)
    offsets = np.zeros(n2 + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst.astype(np.int64)


@pytest.mark.parametrize("form", ["packed", "rows"])
def test_adjacency_equals_unique_form(graphs, form, monkeypatch):
    _, gt = graphs
    if form == "rows":  # as past the int64 bound of the packed key
        monkeypatch.setattr(core_graph, "_PACKED_KEY_MAX", 0)
    adj = SideAdjacency.build(gt)
    want_off, want_tgt = _adjacency_unique_form(gt)
    assert adj.offsets.dtype == adj.targets.dtype == np.int64
    np.testing.assert_array_equal(adj.offsets, want_off)
    np.testing.assert_array_equal(adj.targets, want_tgt)
    for h in range(2 * gt.num_nodes):  # ascending, each edge once
        assert (np.diff(adj.neighbors(h)) > 0).all()


def test_adjacency_lists_a_self_inverse_edge_once():
    gt = graph_from_arrays(graph_to_arrays(_self_inverse()))
    h = 2 * 2  # node 3 (rank 2), forward
    assert list(gt.adjacency.neighbors(h)).count(h ^ 1) == 1


# ---------------------------------------------------------------------------
# Groom and the topological order on both paths
# ---------------------------------------------------------------------------


def _targets(gt):
    return [[]] + ([[0], list(range(gt.num_paths))[::-1]] if gt.num_paths else [])


def test_groom_equals_reference(graphs, gs_path):
    gj, gt = graphs
    for target in _targets(gt):
        flip = groom.groom(gt, target or None)
        assert flip.dtype == bool and flip.shape == (gt.num_nodes,)
        np.testing.assert_array_equal(flip, j_groom.groom(gj, target or None))


@pytest.mark.parametrize("seeds", ["heads", "tails", "neither"])
def test_topological_order_equals_reference(graphs, gs_path, seeds):
    gj, gt = graphs
    kw = dict(use_heads=seeds == "heads", use_tails=seeds == "tails")
    order = topological.topological_order(gt, **kw)
    assert order.dtype == np.int64
    np.testing.assert_array_equal(np.sort(order), np.arange(gt.num_nodes))
    np.testing.assert_array_equal(order, j_topo.topological_order(gj, **kw))


def _gs_calls(gt, monkeypatch, lib):
    """The four counters' runs, and gs.native / gs.python, added by
    groom (without and with a target path) and the three orders."""
    monkeypatch.setattr(native, "gs_lib", lambda: lib)
    names = COUNTERS + (native.GS_NATIVE, native.GS_PYTHON)
    before = [_runs(k) for k in names]
    flips = [groom.groom(gt, target or None) for target in _targets(gt)[:2]]
    orders = [topological.topological_order(gt, h, t)
              for h, t in ((True, False), (False, True), (False, False))]
    return [_runs(k) - b for k, b in zip(names, before)], flips, orders


def test_paths_count_alike(graphs, monkeypatch):
    """Both paths give the same arrays and structural counts; each call adds
    one run to its path's counter and none to the other's."""
    _, gt = graphs
    lib = native.gs_lib()
    assert lib is not None, native._gs["error"]
    calls = len(_targets(gt)[:2]) + 3
    got_n, flips_n, orders_n = _gs_calls(gt, monkeypatch, lib)
    got_p, flips_p, orders_p = _gs_calls(gt, monkeypatch, None)
    assert got_n[:4] == got_p[:4]
    assert got_n[4:] == [calls, 0] and got_p[4:] == [0, calls]
    for a, b in zip(flips_n + orders_n, flips_p + orders_p):
        np.testing.assert_array_equal(a, b)
    if gt.num_nodes and not len(topological.head_nodes(gt)):
        assert got_n[1] > 0 and got_n[3] > 0  # no head: groom and s restart


def test_cycles_restart_and_seed():
    """The cycle graph restarts groom and takes nodes from the seed set."""
    gt = graph_from_arrays(graph_to_arrays(_cycles()))
    assert not len(topological.head_nodes(gt))
    before = [_runs(k) for k in COUNTERS]
    groom.groom(gt)
    topological.topological_order(gt)
    got = [_runs(k) - b for k, b in zip(COUNTERS, before)]
    assert got[1] >= 3 and got[3] >= 3  # one restart a ring at least
    assert got[2] > 0


def test_sort_job_takes_the_native_passes():
    """`g` and `s` of a sort: one native run each, none in Python."""
    from odgi_tpu_torch.algorithms.path_sgd_sort import apply_groom, topological_order

    gt = graph_from_arrays(graph_to_arrays(_small_graph(edge_noise=True)))
    before = _runs(native.GS_NATIVE), _runs(native.GS_PYTHON)
    topological_order(apply_groom(gt), use_heads=True)
    assert (_runs(native.GS_NATIVE), _runs(native.GS_PYTHON)) == (before[0] + 2, before[1])


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


def _with_adjacency(gt, offsets, targets):
    g = graph_from_arrays(graph_to_arrays(gt))
    g._cache["adjacency"] = SideAdjacency(offsets, targets)
    return g


@pytest.mark.parametrize("bad", ["target-past-2n", "negative-target", "offsets-past-e",
                                 "offsets-descend", "offsets-short"])
def test_native_passes_refuse_handles_out_of_range(bad):
    assert native.gs_lib() is not None, native._gs["error"]
    gt = graph_from_arrays(graph_to_arrays(_small_graph(edge_noise=True)))
    off, tgt = gt.adjacency.offsets.copy(), gt.adjacency.targets.copy()
    n2 = 2 * gt.num_nodes
    if bad == "target-past-2n":
        tgt[len(tgt) // 2] = n2
    elif bad == "negative-target":
        tgt[3] = -2
    elif bad == "offsets-past-e":
        off[-1] += 1
    elif bad == "offsets-descend":
        off[5], off[6] = off[6] + 1, off[5]
    else:
        off = off[:-1]
    g = _with_adjacency(gt, off, tgt)
    with pytest.raises(ValueError):
        groom.groom(g)
    with pytest.raises(ValueError):
        topological.topological_order(g, use_heads=False)


def test_native_topological_order_refuses_an_edge_without_its_mirror():
    assert native.gs_lib() is not None, native._gs["error"]
    gt = graph_from_arrays(graph_to_arrays(_small_graph()))
    off, tgt = gt.adjacency.offsets, gt.adjacency.targets.copy()
    h = 2 * 10  # node 10 forward -> node 11 forward; drop its mirror's target
    j = int(off[h])
    assert tgt[j] == 2 * 11
    mirror = np.nonzero(tgt[off[2 * 11 + 1]:off[2 * 11 + 2]] == h ^ 1)[0]
    tgt[off[2 * 11 + 1] + mirror[0]] = h  # 11- -> 10+: still below 2N
    g = _with_adjacency(gt, off, tgt)
    with pytest.raises(ValueError):
        topological.topological_order(g)


def test_native_groom_refuses_a_seed_past_2n():
    lib = native.gs_lib()
    assert lib is not None, native._gs["error"]
    off = np.array([0, 1, 2], dtype=np.int64)  # one node, 1+ -> 1- and back
    tgt = np.array([1, 0], dtype=np.int64)
    flipped = np.zeros(1, dtype=np.uint8)
    for seed in (2, -1):
        seeds = np.array([seed], dtype=np.int64)
        assert lib.odgi_groom(2, off.ctypes.data, 2, tgt.ctypes.data, 1, seeds.ctypes.data,
                              None, None, flipped.ctypes.data) == -1
    seeds = np.array([1], dtype=np.int64)
    assert lib.odgi_groom(2, off.ctypes.data, 2, tgt.ctypes.data, 1, seeds.ctypes.data,
                          None, None, flipped.ctypes.data) == 0
    assert flipped[0] == 1
