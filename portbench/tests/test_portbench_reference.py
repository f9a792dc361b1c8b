"""The frozen plan and the plain reference against the program on the CPU."""

import numpy as np
import pytest

from portbench import graphgen, plan as pl, reference

GRAPHS = {
    "resident": dict(haplotypes=4, nodes=3000),
    "xxl": dict(haplotypes=2, nodes=20000),
    "deep": dict(haplotypes=40, nodes=1500),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("one_d", [False, True])
def test_plan_equals_the_program(graph, one_d):
    from odgi_tpu_torch.convert import graph_from_arrays
    from odgi_tpu_torch.ops import sgd, strata_levels, strata_plan

    f = graphgen.graph_arrays(GRAPHS[graph], 7)
    g = graph_from_arrays(f)
    seed = 2**31 + 5
    cfg = sgd.derive_config_1d(g, seed=seed) if one_d else sgd.derive_config_2d(g, seed=seed)
    theirs = strata_plan.plan_run(g, cfg, one_d)
    ours = pl.plan(f, pl.derive_1d(f, seed) if one_d else pl.derive_2d(f, seed), one_d)
    for a, b in (("cpi", "cpi"), ("cgs", "cgs"), ("groups", "groups"), ("o_blk", "o"),
                 ("d_arr", "d"), ("eta_table", "eta")):
        assert np.array_equal(theirs[a], ours[b]), a
    assert theirs["data"].num_slots == ours["L"]
    assert theirs["total_valid"] == pl.valid_pairs(f["path_offset"], ours["o"], ours["d"]).sum()
    perm = strata_levels.chunk_schedule(theirs)[0]
    lv = pl.levels(ours)
    order = np.argsort(lv, axis=1, kind="stable") + np.arange(ours["groups"])[:, None] * ours["cgs"]
    assert np.array_equal(order.reshape(-1), perm)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_layout_reference_equals_the_program(graph):
    from odgi_tpu_torch.algorithms.layout import layout_graph
    from odgi_tpu_torch.convert import graph_from_arrays
    from odgi_tpu_torch.ops.sgd import derive_config_2d

    f = graphgen.graph_arrays(GRAPHS[graph], 3)
    g = graph_from_arrays(f)
    got = layout_graph(g, derive_config_2d(g, seed=99), seed=99, device="cpu")
    assert np.array_equal(got, reference.layout(f, 99, "cpu"))


@pytest.mark.parametrize("graph", ["resident", "deep"])
def test_sort_reference_equals_the_program(graph):
    from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline
    from odgi_tpu_torch.convert import graph_from_arrays

    f = graphgen.graph_arrays(GRAPHS[graph], 4)
    g = graph_from_arrays(f)
    got = sort_pipeline(g, "Ygs", sgd_overrides={"seed": 77}, device="cpu")
    ref = reference.sort_ygs(f, 77, "cpu")
    for key in ("step_handle", "edge_from", "edge_to", "seq", "node_len", "node_id"):
        assert np.array_equal(getattr(got, key), ref[key]), key


def test_components_match_scipy():
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    f = graphgen.graph_arrays(dict(haplotypes=2, nodes=3000), 5)
    # many components: keep a random part of the edges
    keep = np.random.default_rng(1).random(len(f["edge_from"])) < 0.6
    f = dict(f, edge_from=f["edge_from"][keep], edge_to=f["edge_to"][keep])
    n = len(f["node_len"])
    ncomp, lab = connected_components(
        coo_matrix((np.ones(len(f["edge_from"])), (f["edge_from"] >> 1, f["edge_to"] >> 1)),
                   shape=(n, n)), directed=False)
    ours = reference.components(f)
    assert ours.max() + 1 == ncomp > 1
    # the same partition
    pairs = set(zip(ours.tolist(), lab.tolist()))
    assert len(pairs) == ncomp
