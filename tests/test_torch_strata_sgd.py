"""The port's strata PG-SGD (plain PyTorch versions, CPU) against odgi_tpu's
strata twins path_sgd_2d_strata_xla / path_sgd_1d_strata_xla.

Both run the same plan, the same coins and the same update order, and sum
the consensus in f64 in the same order; only the order of f32 operations
inside XLA's fused chunk body may differ.  Tolerances (max |delta| over the
coordinate scale):
- short runs (iter_max 2-3, min_term_updates 3*1024): 1e-6;
- the default schedules (30 iterations 2D, 100 1D): 1e-4, the tolerance
  tests/test_pallas_sgd.py holds its own kernel to, since many iterations
  may amplify ulp differences.
"""

import numpy as np
import pytest
import torch

from odgi_tpu.algorithms.layout import init_layout as j_init_layout
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import sgd as j_sgd

from odgi_tpu_torch import native
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import sgd, strata_sgd, strata_xxl
from odgi_tpu_torch.parallel import sharded_strata
from odgi_tpu_torch.utils.metrics import TOTALS
from slot_forms import slot_arrays_numpy
from test_torch_xxl import steps_path  # noqa: F401  (a fixture)

SHORT_TOL = 1e-6
DEFAULT_TOL = 1e-4


@pytest.fixture(scope="module")
def graphs():
    """3 paths x 1600 steps over 120 nodes (tests/test_pallas_sgd.py)."""
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
    gj = b.build()
    return gj, graph_from_arrays(graph_to_arrays(gj))


def _rel_err(port, twin):
    return np.abs(port - twin).max() / (np.abs(twin).max() + 1)


@pytest.mark.parametrize("kw,tol", [
    (dict(iter_max=2, min_term_updates=3 * 1024), SHORT_TOL),
    (dict(iter_max=3, min_term_updates=3 * 1024), SHORT_TOL),
    ({}, DEFAULT_TOL),
], ids=["iter2", "iter3", "default"])
def test_strata_2d_matches_twin(graphs, kw, tol):
    gj, gt = graphs
    c0 = j_init_layout(gj, "d")
    twin = np.asarray(ps.path_sgd_2d_strata_xla(gj, c0, j_sgd.derive_config_2d(gj, **kw)))
    port = sgd.path_sgd_2d(gt, c0, sgd.derive_config_2d(gt, **kw), device="cpu").numpy()
    assert port.shape == twin.shape and port.dtype == np.float64
    assert np.isfinite(port).all()
    assert _rel_err(port, twin) <= tol
    assert np.abs(port - c0).max() > 1.0  # it moved


@pytest.mark.parametrize("kw,tol", [
    (dict(iter_max=2, min_term_updates=3 * 1024), SHORT_TOL),
    (dict(iter_max=3, min_term_updates=3 * 1024), SHORT_TOL),
    ({}, DEFAULT_TOL),
], ids=["iter2", "iter3", "default"])
def test_strata_1d_matches_twin(graphs, kw, tol):
    gj, gt = graphs
    twin = np.asarray(ps.path_sgd_1d_strata_xla(gj, j_sgd.derive_config_1d(gj, **kw)))
    port = sgd.path_sgd_1d(gt, sgd.derive_config_1d(gt, **kw), device="cpu").numpy()
    assert port.shape == twin.shape and np.isfinite(port).all()
    assert _rel_err(port, twin) <= tol
    assert np.abs(port - gt.node_offset).max() > 1.0


def test_strata_1d_from_x0(graphs):
    gj, gt = graphs
    x0 = np.random.default_rng(1).permutation(gj.num_nodes).astype(np.float64) * 8
    kw = dict(iter_max=2, min_term_updates=3 * 1024)
    twin = np.asarray(ps.path_sgd_1d_strata_xla(gj, j_sgd.derive_config_1d(gj, **kw), x0=x0))
    port = sgd.path_sgd_1d(gt, sgd.derive_config_1d(gt, **kw), x0=x0, device="cpu").numpy()
    assert _rel_err(port, twin) <= SHORT_TOL


@pytest.mark.parametrize("merge", ["merge_sum_plain", "merge_sum_ordered_plain"])
def test_merge_plain_matches_bincount(graphs, merge):
    """The plain merges (f64 index_add_, and the ascending loop over the
    CSR) equal the twin's np.bincount sums exactly on random drift, and the
    broadcast resets the drift."""
    import torch

    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, iter_max=1, min_term_updates=3 * 1024)
    c0 = j_init_layout(gt, "d")
    st = strata_sgd.StrataState.build(gt, cfg, c0, False, torch.device("cpu"))
    rng = np.random.default_rng(2)
    S = gt.num_steps
    drift = np.zeros(st.drift.shape, np.float32)
    drift[:, :S] = rng.normal(size=(4, S)).astype(np.float32)
    st.drift.copy_(torch.from_numpy(drift))
    coords0 = st.coords.clone()
    getattr(strata_sgd, merge)(st.drift, st.mi, st.coords, st.upd)

    node = gt.step_handle >> 1
    epf = np.full(st.drift.shape[1], 2 * gt.num_nodes, np.int64)
    epf[:S] = gt.step_handle
    dv = drift.astype(np.float64)
    cap = 2 * gt.num_nodes + 2
    r = np.repeat(np.bincount(node, minlength=gt.num_nodes), 2).astype(np.float64)
    recip = np.where(r > 0, 1.0 / np.maximum(r, 1), 0.0)
    for ch in range(2):
        acc = np.bincount(epf, dv[2 * ch], minlength=cap)
        acc += np.bincount(epf ^ 1, dv[2 * ch + 1], minlength=cap)
        upd = acc[: 2 * gt.num_nodes] * recip
        assert np.array_equal(st.upd[ch, : 2 * gt.num_nodes].numpy(), upd)
        assert np.array_equal(st.coords[ch].numpy(), coords0[ch].numpy() + upd)

    base0 = st.base.clone()
    strata_sgd.merge_bcast_plain(st.drift, st.base, st.mi, st.upd)
    assert not st.drift.any()
    want = base0[0].numpy() + st.upd[0].numpy()[epf].astype(np.float32)
    assert np.array_equal(st.base[0].numpy(), want)


def test_merge_ordered_1d_matches_bincount_and_index_add(graphs):
    """1D: the ordered loop equals np.bincount bit for bit and the
    index_add_ merge within 1e-12 of the scale."""
    import torch

    _, gt = graphs
    cfg = sgd.derive_config_1d(gt, iter_max=1, min_term_updates=3 * 1024)
    st = strata_sgd.StrataState.build(gt, cfg, gt.node_offset.astype(np.float32), True,
                                      torch.device("cpu"))
    S = gt.num_steps
    drift = np.zeros(st.drift.shape, np.float32)
    drift[0, :S] = np.random.default_rng(3).normal(size=S).astype(np.float32) * 100
    st.drift.copy_(torch.from_numpy(drift))
    c_o, u_o, c_i, u_i = (t.clone() for t in (st.coords, st.upd, st.coords, st.upd))
    strata_sgd.merge_sum_ordered_plain(st.drift, st.mi, c_o, u_o)
    strata_sgd.merge_sum_plain(st.drift, st.mi, c_i, u_i)
    node = gt.step_handle[:S] >> 1
    r = np.bincount(node, minlength=gt.num_nodes).astype(np.float64)
    recip = np.where(r > 0, 1.0 / np.maximum(r, 1), 0.0)
    want = np.bincount(node, drift[0, :S].astype(np.float64), minlength=gt.num_nodes) * recip
    assert np.array_equal(u_o[0, :gt.num_nodes].numpy(), want)
    scale = float(c_i.abs().max()) + 1
    assert float((c_o - c_i).abs().max()) / scale <= 1e-12
    assert float((u_o - u_i).abs().max()) / scale <= 1e-12


@pytest.mark.parametrize("lengths,want", [
    ([1] * 50 + [0] * 5, 256),       # about one slot a list (sparse graphs)
    ([4, 5, 6, 5] * 30, 256),        # about 5 (the 1M-node graph in 2D)
    ([60, 75, 90] * 20, 32),         # 75 (the smoke graph in 2D)
    ([250, 240, 260] * 20, 16),      # 250 (the XL graph in 2D)
    ([500, 490, 510] * 20, 8),       # 500 (the XL graph in 1D)
    ([9000, 8000] * 4, 2),           # lists past a tile: the floor
    ([0, 0, 0], 256),                # no steps at all
], ids=["one", "five", "seventy-five", "two-fifty", "five-hundred", "long", "empty"])
def test_merge_block_eps_power_of_two(lengths, want):
    b = strata_sgd.merge_block_eps(np.concatenate([[0], np.cumsum(lengths)]))
    assert b == want and 2 <= b <= strata_sgd.SUM_THREADS and b & (b - 1) == 0


def test_merge_index_block_eps_follow_list_length(graphs):
    """MergeIndex.build sizes the blocks from the graph's own lists: at
    most one tile of CSR entries a block, and no smaller than that needs."""
    import torch

    _, gt = graphs
    for one_d in (True, False):
        mi = strata_sgd.MergeIndex.build(gt, gt.num_steps + 4096, one_d, torch.device("cpu"))
        off = mi.csr_off.numpy()
        mean = off[-1] / (len(off) - 1)
        assert mi.block_eps == strata_sgd.merge_block_eps(off)
        assert mi.block_eps * mean <= strata_sgd.SUM_TILE
        assert (mi.block_eps == strata_sgd.SUM_THREADS
                or 2 * mi.block_eps * mean > strata_sgd.SUM_TILE)


def _handles(gt, table):
    """(step handles, node count) of a case: the graph; its steps over 60
    more nodes that no step visits; its first 1000 steps; no steps."""
    h, n = gt.step_handle.astype(np.int64), gt.num_nodes
    return {"graph": (h, n), "stepless-nodes": (h, n + 60), "short": (h[:1000], n),
            "empty": (h[:0], n)}[table]


def _merge_index_argsort(h, n, num_slots, one_d):
    """The merge index's arrays as the stable argsort form they replaced:
    (ep, csr_off, csr_slot, recip)."""
    node = h >> 1
    r = np.bincount(node, minlength=n).astype(np.float64)
    if one_d:
        E, key = n, node
    else:
        E, key, r = 2 * n, h, np.repeat(r, 2)
    ep = np.full(num_slots, E, np.int64)
    ep[:len(h)] = key
    off = np.zeros(E + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=E), out=off[1:])
    recip = np.where(r > 0, 1.0 / np.maximum(r, 1), 0.0)
    return ep, off, np.argsort(key, kind="stable"), recip


@pytest.mark.parametrize("pad", [0, 4096], ids=["no-pad", "pad"])
@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("table", ["graph", "stepless-nodes", "short", "empty"])
def test_merge_csr_equals_stable_argsort(graphs, steps_path, table, one_d, pad):
    h, n = _handles(graphs[1], table)
    ep, off, slot = strata_sgd.merge_csr(h, n, len(h) + pad, one_d)
    assert ep.dtype == off.dtype == slot.dtype == np.int32
    for got, want in zip((ep, off, slot), _merge_index_argsort(h, n, len(h) + pad, one_d)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("table", ["graph", "stepless-nodes"])
def test_merge_index_equals_argsort_form(graphs, steps_path, table, one_d):
    """MergeIndex.build's tensors equal the argsort form's, and its pass is
    counted under the path it took."""
    h, n = _handles(graphs[1], table)
    g = graph_from_arrays(dict(graph_to_arrays(graphs[0])) | dict(
        node_len=np.ones(n, np.int64), seq_offset=np.arange(n + 1),
        seq=np.zeros(n, np.uint8), node_id=np.arange(1, n + 1)))
    name = native.STEPS_NATIVE if steps_path == "native" else native.STEPS_NUMPY
    before = TOTALS.get(name, {}).get("runs", 0)
    mi = strata_sgd.MergeIndex.build(g, len(h) + 4096, one_d, torch.device("cpu"))
    assert TOTALS[name]["runs"] == before + 1
    ep, off, slot, recip = _merge_index_argsort(h, n, len(h) + 4096, one_d)
    for got, want, dt in ((mi.ep, ep, torch.int32), (mi.csr_off, off, torch.int32),
                          (mi.csr_slot, slot, torch.int32), (mi.recip, recip, torch.float64)):
        assert got.dtype == dt and np.array_equal(got.numpy(), want)
    assert mi.ecap == len(off) - 1 + (1 if one_d else 2)
    assert mi.block_eps == strata_sgd.merge_block_eps(off)
    if table == "stepless-nodes":
        assert (recip[-60 * (1 if one_d else 2):] == 0).all()


def _with_empty_paths(gt):
    """`gt` with empty paths before, between and after its paths."""
    off = gt.path_offset
    names = ("e0",) + gt.path_names[:1] + ("e1",) + gt.path_names[1:] + ("e2",)
    return graph_from_arrays(dict(graph_to_arrays(gt)) | dict(
        path_names=names, path_circular=np.zeros(len(names), bool),
        path_offset=np.concatenate([[0], off[:2], off[1:], off[-1:]])))


@pytest.mark.parametrize("dim,route", [
    ("1d", "resident"), ("1d", "xxl"), ("2d", "resident"), ("2d", "xxl"), ("2d", "sharded"),
    ("1d", "empty-paths"), ("2d", "empty-paths"),
])
def test_slots_filled_on_device_equal_host_forms(graphs, dim, route):
    """StrataState.build's planes and base, filled on the device from the
    step table, equal the host forms bit for bit and dtype for dtype, pad
    slots included, on every route, on the sharded run's stacked plan and
    with empty paths in the table; each build counts one device fill.  The
    start has f64 values that f32 does not hold, so the rounding shows."""
    _, gt = graphs
    if route == "empty-paths":
        gt, route = _with_empty_paths(gt), "resident"
        assert (np.diff(gt.path_offset) == 0).sum() == 3
    one_d = dim == "1d"
    rng = np.random.default_rng(11)
    kw = dict(iter_max=2, min_term_updates=3 * 1024)
    if one_d:
        cfg = sgd.derive_config_1d(gt, **kw)
        init = gt.node_offset + rng.normal(size=gt.num_nodes) / 3
    else:
        cfg = sgd.derive_config_2d(gt, **kw)
        init = j_init_layout(gt, "d") + rng.normal(size=(2 * gt.num_nodes, 2)) / 3
    plan = sharded_strata.stacked_plan(gt, cfg, 2) if route == "sharded" else None
    before = TOTALS.get("strata.slots_device", {}).get("runs", 0)
    st = strata_sgd.StrataState.build(gt, cfg, init, one_d, torch.device("cpu"),
                                      "resident" if route == "sharded" else route, plan=plan)
    assert TOTALS["strata.slots_device"]["runs"] == before + 1
    g_run, init_run = gt, init
    if route == "xxl":
        g_run, order = strata_xxl.relabel(gt)
        assert np.array_equal(order, st.order)
        init_run = strata_xxl.relabel_coords(np.asarray(init), order)
    L = st.plan["data"].num_slots
    assert L > g_run.num_steps
    planes, base = slot_arrays_numpy(g_run, L, init_run, one_d)
    assert st.planes.dtype == torch.int32 and st.base.dtype == torch.float32
    assert np.array_equal(st.planes.numpy(), planes)
    assert np.array_equal(st.base.numpy().view(np.int32), base.view(np.int32))
    assert st.drift.shape == base.shape and not st.drift.any()


def _small_graph(gt):
    """The first 100 steps of path 0 alone: under 1,024 steps."""
    return graph_from_arrays(dict(graph_to_arrays(gt)) | dict(
        path_names=("p0",), path_circular=np.zeros(1, bool),
        path_offset=np.array([0, 100]), step_handle=gt.step_handle[:100],
        step_pos=gt.step_pos[:100]))


@pytest.mark.parametrize("case,route", [
    ("delta", "resident"), ("pin", "batched"), ("snapshot", "batched"),
    ("use_paths", "resident"), ("small", "batched"),
])
def test_out_of_slice_paths_raise(graphs, case, route):
    """The options that raised before this slice (delta, pinning,
    snapshots, a path subset, graphs under 1,024 steps) now run on the CPU
    and take the reference's route."""
    _, gt = graphs
    c0 = j_init_layout(gt, "d")
    cfg2 = sgd.derive_config_2d(gt, iter_max=2, min_term_updates=3 * 1024)
    cfg1 = sgd.derive_config_1d(gt, iter_max=2, min_term_updates=3 * 1024)
    if case == "delta":
        out = sgd.path_sgd_2d(gt, c0, sgd.derive_config_2d(gt, iter_max=2, delta=0.1),
                              device="cpu")
    elif case == "pin":
        out = sgd.path_sgd_2d(gt, c0, cfg2, pin_nodes=np.zeros(gt.num_nodes, bool),
                              device="cpu")
    elif case == "snapshot":
        seen = []
        out = sgd.path_sgd_1d(gt, cfg1, snapshot_cb=lambda it, x: seen.append(it),
                              device="cpu")
        assert seen == [0, 1]
    elif case == "use_paths":
        out = sgd.path_sgd_1d(gt, cfg1, use_paths=[0], device="cpu")
    else:
        out = sgd.path_sgd_1d(_small_graph(gt), device="cpu")
    assert sgd.LAST_RUN["route"] == route
    assert bool(torch.isfinite(out).all())
