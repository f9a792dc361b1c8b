"""The whole slice on the CPU: sort "Ygs" then the 2D layout, the port's
entry points against odgi_tpu composed from its strata twins
(order_from_x(path_sgd_1d_strata_xla) -> groom -> topological order ->
init_layout -> path_sgd_2d_strata_xla), at the default schedules."""

import numpy as np
import pytest

from odgi_tpu.algorithms import groom as j_groom
from odgi_tpu.algorithms import layout as j_layout
from odgi_tpu.algorithms import stats as j_stats
from odgi_tpu.algorithms import topological as j_topo
from odgi_tpu.algorithms.path_sgd_sort import order_from_x as j_order_from_x
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps

import odgi_tpu_torch as ot
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays

# Layout coordinates: the default 30-iteration schedule may amplify f32 ulp
# differences between XLA's fused chunk body and the port's (see
# test_torch_strata_sgd.py), so 1e-4 of the coordinate scale.
LAYOUT_TOL = 1e-4


@pytest.fixture(scope="module")
def shuffled():
    """The 120-node, 3 x 1600-step graph of tests/test_pallas_sgd.py with
    its node ids shuffled, so the sort has work to do."""
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
    gj = b.build().apply_ordering(np.random.default_rng(5).permutation(120))
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.fixture(scope="module")
def sorted_pair(shuffled):
    gj, gt = shuffled
    gj2 = gj.apply_ordering(j_order_from_x(gj, ps.path_sgd_1d_strata_xla(gj)))
    gj2 = j_groom.apply_groom(gj2)
    gj2 = gj2.apply_ordering(j_topo.topological_order(gj2, use_heads=True))
    gt2 = ot.sort_pipeline(gt, "Ygs", device="cpu")
    return gj2, gt2


def test_sort_Ygs_matches_twin_pipeline(shuffled, sorted_pair):
    gj, _ = shuffled
    gj2, gt2 = sorted_pair
    # the node orders are equal (no float ties change the X lexsort here)
    assert np.array_equal(gj2.step_handle, gt2.step_handle)
    assert np.array_equal(gj2.seq, gt2.seq)
    nt0 = j_stats.sum_of_path_node_distances(gj).all_nt_space
    nt1 = ot.sum_of_path_node_distances(gt2, device="cpu").all_nt_space
    assert nt1 == pytest.approx(j_stats.sum_of_path_node_distances(gj2).all_nt_space,
                                rel=1e-12)
    assert nt1 < 0.5 * nt0


def test_layout_matches_twin(sorted_pair):
    gj2, gt2 = sorted_pair
    c0 = j_layout.init_layout(gj2, "d")
    twin = j_layout.pack_components(gj2, np.asarray(ps.path_sgd_2d_strata_xla(gj2, c0)))
    port = ot.layout_graph(gt2, device="cpu")
    scale = np.abs(twin).max() + 1
    assert np.isfinite(port).all()
    assert np.abs(port - twin).max() / scale <= LAYOUT_TOL
    sj = j_stats.sum_of_path_node_distances(gj2, (twin[:, 0], twin[:, 1]))
    st = ot.sum_of_path_node_distances(gt2, (port[:, 0], port[:, 1]), device="cpu")
    assert st.all_2d_by_nucleotides == pytest.approx(sj.all_2d_by_nucleotides, rel=1e-3)
