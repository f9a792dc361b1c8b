"""The port's XXL route against odgi_tpu's block-merge kernels
(ops/pallas_sgd_xxl.py, interpret mode) and its host pieces.

The block size is shrunk to 1024 endpoints on both sides (the JAX suite's
own setting, tests/test_pallas_sgd_xxl.py), so a small graph runs
multi-block merges; node ids are shuffled so the relabel by first visit is
not the identity.

- `locality_order`, the relabel, `block_geometry` and the schedule's rows
  0-4 equal the JAX package's byte for byte.
- The first-visit order and the schedule's entries, in C++ and in numpy,
  equal the `np.unique` forms they replace, array for array.
- The blocked plain sum equals the CSR plain sums exactly.
- The "xxl" route equals the port's "resident" route exactly; it is within
  1e-6 of the coordinate scale of the exact twins and within 1e-5 of the
  JAX XXL kernels (their f32 + TwoSum coordinates and bf16-pass merge sums,
  see tests/test_torch_xl.py).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from odgi_tpu.algorithms.layout import init_layout as j_init_layout
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import pallas_sgd_xxl as jxxl
from odgi_tpu.ops import sgd as j_sgd

from odgi_tpu_torch import native
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import sgd, strata_sgd, strata_xxl
from odgi_tpu_torch.utils.metrics import TOTALS

BS = 1024
TWIN_TOL = 1e-6
KERNEL_TOL = 1e-5
KW = dict(iter_max=2, min_term_updates=3 * 1024)


@pytest.fixture(params=["native", "numpy"])
def steps_path(request, monkeypatch):
    """The step-table passes (``native/src/strata_steps.cpp``) in C++,
    which has to load, or in numpy, the library taken away."""
    if request.param == "native":
        assert native.steps_lib() is not None, native._steps["error"]
    else:
        monkeypatch.setattr(native, "steps_lib", lambda: None)
    return request.param


@pytest.fixture(scope="module")
def graphs():
    """2000 nodes, 3 paths x 1800 steps with jumps across the id range
    (tests/test_pallas_sgd_xxl.py), node ids shuffled."""
    rng = np.random.default_rng(23)
    b = GraphBuilder()
    N = 2000
    for i in range(1, N + 1):
        b.add_node(i, b"ACGT")
    for i in range(1, N):
        b.add_edge(i, False, i + 1, False)
    for pi in range(3):
        p = b.add_path(f"p{pi}")
        n = 1
        for _ in range(1800):
            b.append_step(p, n, bool(rng.integers(0, 2)))
            n = int(np.clip(n + rng.integers(-40, 41), 1, N))
    gj = b.build().apply_ordering(np.random.default_rng(5).permutation(N))
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(jxxl, "XXL_BS", BS)
    monkeypatch.setattr(strata_xxl, "XXL_BS", BS)


def _rel_err(port, ref):
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1)


# ---------------------------------------------------------------------------
# Host pieces
# ---------------------------------------------------------------------------


def test_locality_order_and_relabel(graphs):
    gj, gt = graphs
    order = strata_xxl.locality_order(gt)
    np.testing.assert_array_equal(order, jxxl._locality_order(gj))
    assert not np.array_equal(order, np.arange(gt.num_nodes))
    g_run, order2 = strata_xxl.relabel(gt)
    gj_run, jorder = jxxl._relabel_cached(gj)
    np.testing.assert_array_equal(order2, jorder)
    for name, want in graph_to_arrays(gj_run).items():
        got = getattr(g_run, name)
        if name == "path_names":
            assert tuple(got) == want
        else:
            assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), name
    g_again, none = strata_xxl.relabel(g_run)
    assert g_again is g_run and none is None


def test_relabel_coords_round_trip(graphs):
    _, gt = graphs
    _, order = strata_xxl.relabel(gt)
    rng = np.random.default_rng(3)
    for shape in ((2 * gt.num_nodes, 2), (gt.num_nodes,)):
        c = rng.normal(size=shape)
        run = strata_xxl.relabel_coords(c, order)
        if c.ndim == 2:  # as path_sgd_2d_pallas_xxl relabels coords0
            want = c.reshape(-1, 2, 2)[order].reshape(-1, 2)
        else:
            want = c[order]
        np.testing.assert_array_equal(run, want)
        back = strata_xxl.unrelabel(torch.from_numpy(run), order).numpy()
        np.testing.assert_array_equal(back, c)


@pytest.mark.parametrize("idx_count,bs", [
    (1, 1024), (4002, 1024), (2001, 1024), (2_000_002, 2048), (1_000_001, 2048),
    (20_002, 32768), (128 * 16, 2048), (128 * 16 + 1, 2048),
])
def test_block_geometry(idx_count, bs):
    assert strata_xxl.block_geometry(idx_count, bs) == jxxl._block_geometry(idx_count, bs)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("bs", [BS, 256, strata_xxl.XXL_BS])
def test_schedule_byte_equal(graphs, one_d, bs):
    gj, gt = graphs
    g_run, _ = strata_xxl.relabel(gt)
    gj_run, _ = jxxl._relabel_cached(gj)
    for port_g, jax_g in ((gt, gj), (g_run, gj_run)):
        sched, K, nb = strata_xxl.build_schedule(port_g, bs, one_d)
        jsched, jK, jnb = jxxl._build_schedule(jax_g, bs, one_d)
        assert (K, nb) == (jK, jnb) and sched.shape == jsched.shape
        assert sched[:5].tobytes() == jsched[:5].tobytes()


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_schedule_covers_every_step(graphs, one_d):
    _, gt = graphs
    g_run, _ = strata_xxl.relabel(gt)
    bsch = strata_xxl.BlockSchedule.build(g_run, one_d, "cpu", BS)
    tile, block = bsch.tile.numpy(), bsch.block.numpy()
    off = bsch.blk_off.numpy()
    ep = g_run.step_handle >> 1 if one_d else g_run.step_handle
    want = set(zip(ep // BS, np.arange(g_run.num_steps) // strata_xxl.TILE))
    assert set(zip(block, tile)) == want and len(tile) == len(want)
    assert off[0] == 0 and off[-1] == len(tile)
    for b in range(bsch.num_blocks):
        assert (block[off[b]:off[b + 1]] == b).all()
        assert (np.diff(tile[off[b]:off[b + 1]]) > 0).all()
    # relabeling by first visit needs fewer tile reads than the shuffled ids
    assert len(tile) <= strata_xxl.build_schedule(gt, BS, one_d)[1]


# ---------------------------------------------------------------------------
# The step-table passes, in C++ and in numpy
# ---------------------------------------------------------------------------


def _steps(n_nodes, n_steps, visited, seed):
    """A step table of `n_steps` random handles over `visited` of
    `n_nodes` nodes (the rest unvisited)."""
    rng = np.random.default_rng(seed)
    nodes = rng.choice(n_nodes, visited, replace=False)
    h = 2 * nodes[rng.integers(0, visited, n_steps)] + rng.integers(0, 2, n_steps)
    return types.SimpleNamespace(step_handle=h.astype(np.int64), num_nodes=n_nodes,
                                 num_steps=n_steps)


STEP_TABLES = {
    "unvisited": lambda: _steps(700, 3000, 450, 1),
    "many-tiles": lambda: _steps(3000, 50_000, 3000, 2),
    "empty": lambda: _steps(9, 0, 1, 3),
    "one-node": lambda: _steps(40, 5000, 1, 6),
}


def _first_visit_unique(g):
    """The first-visit order as the `np.unique` form it replaced."""
    node = (g.step_handle >> 1).astype(np.int64)
    vals, idx = np.unique(node, return_index=True)
    unvisited = np.setdiff1d(np.arange(g.num_nodes, dtype=np.int64), vals)
    return np.concatenate([vals[np.argsort(idx)], unvisited])


@pytest.mark.parametrize("table", ["graph", *STEP_TABLES])
def test_locality_order_equals_unique_form(graphs, steps_path, table):
    g = graphs[1] if table == "graph" else STEP_TABLES[table]()
    order = strata_xxl.locality_order(g)
    assert order.dtype == np.int64
    np.testing.assert_array_equal(order, _first_visit_unique(g))
    if table == "graph":
        np.testing.assert_array_equal(order, jxxl._locality_order(graphs[0]))


def _entries_unique(g, bs, one_d):
    """The schedule's (tile, block) entries as the `np.unique` form they
    replaced."""
    node = (g.step_handle >> 1).astype(np.int64)
    ep = node if one_d else 2 * node + (g.step_handle & 1).astype(np.int64)
    tile = np.arange(g.num_steps, dtype=np.int64) // strata_xxl.TILE
    n_tiles = int(tile.max()) + 1 if len(tile) else 1
    pairs = np.unique(ep // bs * n_tiles + tile)
    return pairs % n_tiles, pairs // n_tiles


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("bs", [128, 256, BS, strata_xxl.XXL_BS])
@pytest.mark.parametrize("table", ["graph", "relabeled", "one-tile", "many-tiles"])
def test_schedule_entries_equal_unique_form(graphs, steps_path, table, bs, one_d):
    gt = graphs[1]
    g = {"graph": lambda: gt, "relabeled": lambda: strata_xxl.relabel(gt)[0],
         "one-tile": lambda: STEP_TABLES["unvisited"](),
         "many-tiles": STEP_TABLES["many-tiles"]}[table]()
    idx_count = g.num_nodes + 1 if one_d else 2 * g.num_nodes + 2
    nb = strata_xxl.block_geometry(idx_count, bs)[2]
    tile, block = strata_xxl.schedule_entries(g.step_handle, g.num_nodes, bs, nb, one_d)
    want_t, want_b = _entries_unique(g, bs, one_d)
    assert tile.dtype == block.dtype == np.int32
    np.testing.assert_array_equal(tile, want_t)
    np.testing.assert_array_equal(block, want_b)
    sched, K, _ = strata_xxl.build_schedule(g, bs, one_d)
    assert K == len(want_t) and (sched[0, :K] == want_t).all() and (sched[1, :K] == want_b).all()


def test_native_passes_refuse_nodes_past_the_count():
    assert native.steps_lib() is not None, native._steps["error"]
    g = _steps(50, 400, 50, 5)
    assert (g.step_handle >> 1).max() == 49
    g.num_nodes = 49
    with pytest.raises(ValueError):
        strata_xxl.locality_order(g)
    with pytest.raises(ValueError):
        strata_xxl.schedule_entries(g.step_handle, 49, 128, 8, False)
    with pytest.raises(ValueError):
        strata_sgd.merge_csr(g.step_handle, 49, 500, True)
    with pytest.raises(ValueError):  # fewer slots than steps
        strata_sgd.merge_csr(g.step_handle, 50, 399, True)


def _runs(name):
    return TOTALS.get(name, {}).get("runs", 0)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_xxl_state_counts_its_passes(graphs, steps_path, small_blocks, one_d):
    """An xxl set-up runs three passes over its steps (the first-visit
    order, the merge CSR, the block schedule), each counted under the path
    it took, and builds the same state either way."""
    _, gt = graphs
    name = native.STEPS_NATIVE if steps_path == "native" else native.STEPS_NUMPY
    other = native.STEPS_NUMPY if steps_path == "native" else native.STEPS_NATIVE
    before = _runs(name), _runs(other)
    init = gt.node_offset.astype(np.float32) if one_d else j_init_layout(gt, "d")
    derive = sgd.derive_config_1d if one_d else sgd.derive_config_2d
    st = strata_sgd.StrataState.build(gt, derive(gt, **KW), init, one_d,
                                      torch.device("cpu"), "xxl")
    assert (_runs(name), _runs(other)) == (before[0] + 3, before[1])
    np.testing.assert_array_equal(st.order, _first_visit_unique(gt))
    g_run, _ = strata_xxl.relabel(gt)
    want_t, want_b = _entries_unique(g_run, BS, one_d)
    assert torch.equal(st.bsch.tile, torch.as_tensor(want_t, dtype=torch.int32))
    assert torch.equal(st.bsch.block, torch.as_tensor(want_b, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Blocked plain merges
# ---------------------------------------------------------------------------


def _random_state(gt, one_d, seed):
    g_run, _ = strata_xxl.relabel(gt)
    init = (gt.node_offset.astype(np.float32) if one_d
            else j_init_layout(gt, "d"))
    derive = sgd.derive_config_1d if one_d else sgd.derive_config_2d
    st = strata_sgd.StrataState.build(gt, derive(gt, **KW), init, one_d,
                                      torch.device("cpu"), "xxl")
    rng = np.random.default_rng(seed)
    drift = np.zeros(st.drift.shape, np.float32)
    drift[:, : g_run.num_steps] = rng.normal(size=(drift.shape[0], g_run.num_steps))
    st.drift.copy_(torch.from_numpy(drift))
    st.upd.normal_(generator=torch.Generator().manual_seed(seed))
    st.upd[:, st.mi.recip.shape[0]:] = 0.0
    return st, g_run


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("bs", [BS, 256])
def test_blocked_merges_equal_csr_merges(graphs, one_d, bs):
    _, gt = graphs
    st, g_run = _random_state(gt, one_d, 2)
    bsch = strata_xxl.BlockSchedule.build(g_run, one_d, "cpu", bs)
    assert bsch.num_blocks >= 2

    c_b, u_b, c_p, u_p = (t.clone() for t in (st.coords, st.upd, st.coords, st.upd))
    strata_sgd.merge_sum_blocked_plain(st.drift, st.mi, bsch, c_b, u_b)
    strata_sgd.merge_sum_plain(st.drift, st.mi, c_p, u_p)
    assert torch.equal(c_b, c_p) and torch.equal(u_b, u_p)


# ---------------------------------------------------------------------------
# The XXL route
# ---------------------------------------------------------------------------


def test_xxl_route_2d(graphs, small_blocks):
    gj, gt = graphs
    c0 = j_init_layout(gj, "d")
    cfg_j = j_sgd.derive_config_2d(gj, **KW)
    ref = np.asarray(jxxl.path_sgd_2d_pallas_xxl(gj, c0, cfg_j, interpret=True))
    twin = np.asarray(ps.path_sgd_2d_strata_xla(gj, c0, cfg_j))
    cfg = sgd.derive_config_2d(gt, **KW)
    xxl = strata_sgd.path_sgd_2d_strata(gt, c0, cfg, "cpu", route="xxl").numpy()
    res = strata_sgd.path_sgd_2d_strata(gt, c0, cfg, "cpu", route="resident").numpy()
    np.testing.assert_array_equal(xxl, res)
    assert _rel_err(xxl, twin) <= TWIN_TOL
    assert _rel_err(xxl, ref) <= KERNEL_TOL
    assert np.abs(xxl - c0).max() > 1.0


def test_xxl_route_1d(graphs, small_blocks):
    gj, gt = graphs
    cfg_j = j_sgd.derive_config_1d(gj, **KW)
    ref = np.asarray(jxxl.path_sgd_1d_pallas_xxl(gj, cfg_j, interpret=True))
    twin = np.asarray(ps.path_sgd_1d_strata_xla(gj, cfg_j))
    cfg = sgd.derive_config_1d(gt, **KW)
    xxl = strata_sgd.path_sgd_1d_strata(gt, cfg, None, "cpu", route="xxl").numpy()
    res = strata_sgd.path_sgd_1d_strata(gt, cfg, None, "cpu", route="resident").numpy()
    np.testing.assert_array_equal(xxl, res)
    assert _rel_err(xxl, twin) <= TWIN_TOL
    assert _rel_err(xxl, ref) <= KERNEL_TOL
    assert np.abs(xxl - gt.node_offset).max() > 1.0


def test_xxl_state(graphs, small_blocks):
    _, gt = graphs
    st = strata_sgd.StrataState.build(gt, sgd.derive_config_2d(gt, **KW),
                                      j_init_layout(gt, "d"), False,
                                      torch.device("cpu"), "xxl")
    assert st.order is not None and st.bsch.bs == BS
    assert st.bsch.num_blocks * BS >= 2 * gt.num_nodes
    assert st.perm.shape == (st.od.shape[0],) and len(st.lvl_rows) == st.plan["groups"]


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("bs", [128, BS, strata_xxl.XXL_BS])
def test_blocked_sum_equals_ordered_loop(graphs, one_d, bs):
    """The plain blocked sum, node block by node block over the CSR, at
    blocks of one node row up to the port's size: the ascending loop's
    sums exactly, whatever the tiles of the schedule."""
    _, gt = graphs
    st, g_run = _random_state(gt, one_d, 6)
    bsch = strata_xxl.BlockSchedule.build(g_run, one_d, "cpu", bs)
    c_b, u_b, c_o, u_o = (t.clone() for t in (st.coords, st.upd, st.coords, st.upd))
    strata_sgd.merge_sum_blocked_plain(st.drift, st.mi, bsch, c_b, u_b)
    strata_sgd.merge_sum_ordered_plain(st.drift, st.mi, c_o, u_o)
    assert torch.equal(c_b, c_o) and torch.equal(u_b, u_o)
    assert float(u_o.abs().max()) > 0
    no_tiles = dataclasses.replace(bsch, tile=bsch.tile[:1], block=bsch.block[:1])
    c_n, u_n = st.coords.clone(), st.upd.clone()
    strata_sgd.merge_sum_blocked_plain(st.drift, st.mi, no_tiles, c_n, u_n)
    assert torch.equal(u_n, u_o)
