"""The port's host modules against odgi_tpu's, on the CPU: exact equality.

The graph is built with odgi_tpu and crosses to the port as numpy arrays
(odgi_tpu_torch.convert)."""

import io

import numpy as np
import pytest

from odgi_tpu.algorithms import components as j_comp
from odgi_tpu.algorithms import groom as j_groom
from odgi_tpu.algorithms import layout as j_layout
from odgi_tpu.algorithms import stats as j_stats
from odgi_tpu.algorithms import topological as j_topo
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.io import gfa as j_gfa
from odgi_tpu.io import lay as j_lay

import odgi_tpu_torch as ot
from odgi_tpu_torch.algorithms import components, groom, layout, stats, topological
from odgi_tpu_torch.convert import FIELDS, graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.io import lay

CPU = "cpu"


def _small_graph(seed=7, n=120, paths=3, steps=1600, edge_noise=False):
    """n nodes, `paths` x `steps` steps, mixed orientations (the graph of
    tests/test_pallas_sgd.py); `edge_noise` adds reversing edges so groom
    and the topological order have work to do."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, n + 1):
        b.add_node(i, b"ACGT" * int(rng.integers(1, 5)))
    for i in range(1, n):
        b.add_edge(i, False, i + 1, False)
    if edge_noise:
        for _ in range(n // 4):
            a, c = (int(v) for v in rng.integers(1, n + 1, 2))
            b.add_edge(a, bool(rng.integers(0, 2)), c, bool(rng.integers(0, 2)))
    for pi in range(paths):
        p = b.add_path(f"p{pi}")
        k = 1
        for _ in range(steps):
            b.append_step(p, k, bool(rng.integers(0, 2)))
            k = int(np.clip(k + rng.integers(-2, 3), 1, n))
    return b.build()


@pytest.fixture(scope="module", params=[False, True], ids=["chain", "noisy"])
def graphs(request):
    gj = _small_graph(edge_noise=request.param)
    return gj, graph_from_arrays(graph_to_arrays(gj))


def _same_graph(a, b):
    for k in FIELDS:
        if k == "path_names":
            assert tuple(a.path_names) == tuple(b.path_names)
        else:
            assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_parse_gfa_of_reference_bytes(graphs):
    gj, _ = graphs
    buf = io.StringIO()
    j_gfa.write_gfa(gj, buf)
    text = buf.getvalue().encode()
    _same_graph(j_gfa.parse_gfa(text), ot.parse_gfa(text, device=CPU))
    out = io.StringIO()
    ot.write_gfa(ot.parse_gfa(text, device=CPU), out)
    assert out.getvalue().encode() == text


def test_apply_ordering(graphs):
    gj, gt = graphs
    order = np.random.default_rng(3).permutation(gj.num_nodes)
    _same_graph(gj.apply_ordering(order), gt.apply_ordering(order))
    _same_graph(gj.apply_ordering(order, compact_ids=False),
                gt.apply_ordering(order, compact_ids=False))


def test_keep_paths(graphs):
    gj, gt = graphs
    _same_graph(gj.keep_paths([2, 0]), gt.keep_paths([2, 0]))
    assert np.array_equal(gj.keep_paths([1]).path_length, gt.keep_paths([1]).path_length)


def test_groom(graphs):
    gj, gt = graphs
    assert np.array_equal(j_groom.groom(gj), groom.groom(gt))
    _same_graph(j_groom.apply_groom(gj), groom.apply_groom(gt))


def test_topological_order(graphs):
    gj, gt = graphs
    assert np.array_equal(j_topo.topological_order(gj, use_heads=True),
                          topological.topological_order(gt, use_heads=True))
    assert np.array_equal(j_topo.head_nodes(gj), topological.head_nodes(gt))


def test_weak_component_ids():
    # two components: split the chain by dropping an edge
    gj = _small_graph(seed=3)
    keep = ~((gj.edge_from >> 1) == 59)
    fields = graph_to_arrays(gj)
    fields["edge_from"], fields["edge_to"] = gj.edge_from[keep], gj.edge_to[keep]
    from odgi_tpu.core.graph import GraphTensors as JG

    gj2 = JG(**fields)
    gt2 = graph_from_arrays(fields)
    a, b = j_comp.weak_component_ids(gj2), components.weak_component_ids(gt2)
    assert a.max() == 1
    assert np.array_equal(a, b)
    c0 = j_layout.init_layout(gj2, "d")
    assert np.array_equal(j_layout.pack_components(gj2, c0),
                          layout.pack_components(gt2, c0))


def test_init_layout_and_pack(graphs):
    gj, gt = graphs
    cj = j_layout.init_layout(gj, "d")
    ct = layout.init_layout(gt, "d")
    assert np.array_equal(cj, ct)
    assert np.array_equal(j_layout.pack_components(gj, cj),
                          layout.pack_components(gt, ct))


def test_lay_bytes(graphs, tmp_path):
    gj, _ = graphs
    c = j_layout.init_layout(gj, "d") * 1.37
    c[5] = c[4]  # equal consecutive values: the codec's zero-difference quirk
    pj, pt = tmp_path / "j.lay", tmp_path / "t.lay"
    j_lay.save_layout(c, str(pj))
    lay.save_layout(c, str(pt), device=CPU)
    assert pj.read_bytes() == pt.read_bytes()
    assert np.array_equal(j_lay.load_layout(str(pj)), lay.load_layout(str(pt)))
    pj2, pt2 = tmp_path / "j.layt", tmp_path / "t.layt"
    j_lay.save_layout(c, str(pj2))
    lay.save_layout(c, str(pt2), device=CPU)
    assert pj2.read_bytes() == pt2.read_bytes()
    assert np.array_equal(lay.load_layout(str(pt2)), c)


@pytest.mark.parametrize("penalize", [False, True])
def test_sum_of_path_node_distances(graphs, penalize):
    gj, gt = graphs

    def close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.all(np.abs(a - b) <= 1e-12 * np.maximum(np.abs(a), 1.0))

    rj = j_stats.sum_of_path_node_distances(gj, penalize_diff_orientation=penalize)
    rt = stats.sum_of_path_node_distances(gt, penalize_diff_orientation=penalize,
                                          device=CPU)
    for k in ("per_path_node_space", "per_path_nt_space", "all_node_space",
              "all_nt_space"):
        close(getattr(rj, k), getattr(rt, k))
    for k in ("per_path_nodes", "per_path_nucleotides", "per_path_num_penalties",
              "per_path_num_penalties_diff_orientation"):
        assert np.array_equal(getattr(rj, k), getattr(rt, k)), k
    assert rj.all_num_penalties == rt.all_num_penalties

    c = j_layout.init_layout(gj, "d")
    xy = (c[:, 0], c[:, 1])
    rj = j_stats.sum_of_path_node_distances(gj, xy, penalize_diff_orientation=penalize)
    rt = stats.sum_of_path_node_distances(gt, xy, penalize_diff_orientation=penalize,
                                          device=CPU)
    close(rj.per_path_2d, rt.per_path_2d)
    close(rj.all_2d_by_nodes, rt.all_2d_by_nodes)
    close(rj.all_2d_by_nucleotides, rt.all_2d_by_nucleotides)
    assert (rj.all_num_penalties_diff_orientation
            == rt.all_num_penalties_diff_orientation)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt = graph_from_arrays(graph_to_arrays(_small_graph(paths=1, steps=50)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.parse_gfa(b"H\tVN:Z:1.0\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.sort_pipeline(gt, "gs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.layout_graph(gt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.sum_of_path_node_distances(gt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.save_layout(np.zeros((2, 2)), io.BytesIO())
