"""The port's routing and its XL route against odgi_tpu's dispatch
predicates and HBM-streaming kernels (ops/pallas_sgd_xl.py, interpret mode).

- The route function equals the JAX predicates on stand-in graphs of every
  class, with JAX told it runs on a TPU (its predicates refuse any other
  backend); exact.
- The "xl" route equals the port's "resident" route exactly (same chunks,
  same merge).  Against the JAX package (max |delta| over the coordinate
  scale): within 1e-6 of the exact-arithmetic twins
  (`path_sgd_2d_strata_xla` / `path_sgd_1d_strata_xla`), as
  tests/test_torch_strata_sgd.py holds the resident route; within 1e-5 of
  the JAX XL kernels.  The JAX kernels keep f32 node coordinates plus a
  TwoSum compensation plane (the port keeps f64) and form the consensus
  sums in two bf16 MXU passes (about 2^-16 of each update), so they sit
  2e-6 to 5e-6 of the scale from their own twins on these graphs.
- The XL state carries the conflict levels of its plan, as every route's
  chunk phase runs on the leveled kernels.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from odgi_tpu.algorithms.layout import init_layout as j_init_layout
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import pallas_sgd_xl as jxl
from odgi_tpu.ops import pallas_sgd_xxl as jxxl
from odgi_tpu.ops import sgd as j_sgd

from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import sgd, strata_route, strata_sgd

TWIN_TOL = 1e-6
KERNEL_TOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    """3 paths x 1700 steps over 150 nodes (tests/test_pallas_sgd_xl.py),
    node ids shuffled."""
    rng = np.random.default_rng(11)
    b = GraphBuilder()
    N = 150
    for i in range(1, N + 1):
        b.add_node(i, b"ACGTA" * int(rng.integers(1, 5)))
    for i in range(1, N):
        b.add_edge(i, False, i + 1, False)
    for pi in range(3):
        p = b.add_path(f"p{pi}")
        n = 1
        for _ in range(1700):
            b.append_step(p, n, bool(rng.integers(0, 2)))
            n = int(np.clip(n + rng.integers(-2, 3), 1, N))
    gj = b.build().apply_ordering(np.random.default_rng(5).permutation(N))
    return gj, graph_from_arrays(graph_to_arrays(gj))


def _rel_err(port, ref):
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

# (steps, nodes, max position, space): one stand-in per class and boundary
STAND_INS = {
    "resident": (1_500_000, 10_000, 50_000, 50_000),
    "xl_graph": (5_000_000, 10_000, 50_000, 50_000),
    "xxl_1m": (10_000_000, 1_000_000, 1_000_000, 1_000_000),
    "under_1024_steps": (1_023, 100, 1_000, 500),
    "at_1024_steps": (1_024, 100, 1_000, 500),
    "pos_2^30": (5_000, 100, 2**30, 1_000),
    "pos_below_2^30": (5_000, 100, 2**30 - 1, 1_000),
    "nodes_16383": (100_000, 16_383, 100_000, 1_000),
    "nodes_16384": (100_000, 16_384, 100_000, 1_000),
    "nodes_32767": (100_000, 32_767, 100_000, 1_000),
    "nodes_32768": (100_000, 32_768, 100_000, 1_000),
    "vmem_2d_over": (1_780_000, 1_000, 50_000, 20_000),
    "vmem_2d_at_budget": (1_760_000, 1_000, 50_000, 20_000),
    "vmem_2d_under": (1_750_000, 1_000, 50_000, 20_000),
    "vmem_1d_over": (4_750_000, 1_000, 50_000, 50_000),
    "vmem_1d_under": (4_700_000, 1_000, 50_000, 50_000),
}


def _stand_in(steps, nodes, max_pos, space):
    g = SimpleNamespace(num_steps=steps, num_nodes=nodes,
                        step_pos=np.array([max_pos - 1], np.int64),
                        node_len=np.array([1], np.int64))
    return g, SimpleNamespace(space=space, delta=0.0)


def _jax_route(g, cfg, one_d):
    if one_d:
        preds = (ps.pallas_supported_1d, jxl.xl_supported_1d, jxxl.xxl_supported_1d)
    else:
        preds = (ps.pallas_supported, jxl.xl_supported, jxxl.xxl_supported)
    for route, pred in zip(("resident", "xl", "xxl"), preds):
        if pred(g, cfg):
            return route
    return "batched"


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("case", sorted(STAND_INS))
def test_route_matches_jax_predicates(monkeypatch, case, one_d):
    g, cfg = _stand_in(*STAND_INS[case])
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = _jax_route(g, cfg, one_d)
    assert strata_route.graph_route(g, cfg, one_d) == want


def test_route_classes_cover_the_chip_graphs(monkeypatch):
    """The stand-ins of the graphs the card runs take the routes the
    port's card run gates on."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for case, want in (("resident", "resident"), ("xl_graph", "xl"), ("xxl_1m", "xxl")):
        for one_d in (True, False):
            g, cfg = _stand_in(*STAND_INS[case])
            assert strata_route.graph_route(g, cfg, one_d) == want
            assert _jax_route(g, cfg, one_d) == want


def test_route_of_real_graph(graphs, monkeypatch):
    gj, gt = graphs
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for one_d, derive_j, derive_t in ((True, j_sgd.derive_config_1d, sgd.derive_config_1d),
                                      (False, j_sgd.derive_config_2d, sgd.derive_config_2d)):
        route = strata_route.graph_route(gt, derive_t(gt), one_d)
        assert route == _jax_route(gj, derive_j(gj), one_d) == "resident"


# ---------------------------------------------------------------------------
# The XL route
# ---------------------------------------------------------------------------

KW = dict(iter_max=2, min_term_updates=3 * 1024)


def test_xl_route_2d(graphs):
    gj, gt = graphs
    c0 = j_init_layout(gj, "d")
    cfg_j = j_sgd.derive_config_2d(gj, **KW)
    ref = np.asarray(jxl.path_sgd_2d_pallas_xl(gj, c0, cfg_j, interpret=True))
    twin = np.asarray(ps.path_sgd_2d_strata_xla(gj, c0, cfg_j))
    cfg = sgd.derive_config_2d(gt, **KW)
    xl = strata_sgd.path_sgd_2d_strata(gt, c0, cfg, "cpu", route="xl").numpy()
    res = strata_sgd.path_sgd_2d_strata(gt, c0, cfg, "cpu", route="resident").numpy()
    np.testing.assert_array_equal(xl, res)
    assert _rel_err(xl, twin) <= TWIN_TOL
    assert _rel_err(xl, ref) <= KERNEL_TOL
    assert np.abs(xl - c0).max() > 1.0


def test_xl_route_1d(graphs):
    gj, gt = graphs
    cfg_j = j_sgd.derive_config_1d(gj, **KW)
    ref = np.asarray(jxl.path_sgd_1d_pallas_xl(gj, cfg_j, interpret=True))
    twin = np.asarray(ps.path_sgd_1d_strata_xla(gj, cfg_j))
    cfg = sgd.derive_config_1d(gt, **KW)
    xl = strata_sgd.path_sgd_1d_strata(gt, cfg, None, "cpu", route="xl").numpy()
    res = strata_sgd.path_sgd_1d_strata(gt, cfg, None, "cpu", route="resident").numpy()
    np.testing.assert_array_equal(xl, res)
    assert _rel_err(xl, twin) <= TWIN_TOL
    assert _rel_err(xl, ref) <= KERNEL_TOL
    assert np.abs(xl - gt.node_offset).max() > 1.0


def test_xl_state_carries_levels(graphs):
    """The XL state carries its plan's conflict levels, with neither the
    xxl block schedule nor its relabel; an unknown route is refused."""
    import torch

    from odgi_tpu_torch.ops import strata_levels

    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, **KW)
    st = strata_sgd.StrataState.build(gt, cfg, j_init_layout(gt, "d"), False,
                                      torch.device("cpu"), "xl")
    assert torch.equal(st.perm, torch.from_numpy(strata_levels.chunk_levels(st.plan)[0]))
    assert st.bsch is None and st.order is None
    with pytest.raises(ValueError):
        strata_sgd.StrataState.build(gt, cfg, j_init_layout(gt, "d"), False,
                                     torch.device("cpu"), "fast")
