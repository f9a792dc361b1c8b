"""Conflict levels of the chunk phases (ops/strata_levels.py) and the
leveled plain chunk phases, 2D and 1D, on the CPU.

- The levels of 2D and of 1D plans are a valid schedule: the chunks of one level are pairwise
  slot-disjoint, and every earlier chunk that shares a slot with a chunk
  has a lower level.  Plans: one path shorter than a chunk (every D <
  CHUNK, so A and B windows overlap, and every window runs past the last
  step), the 120-node graph of tests/test_pallas_sgd.py, and a synthetic
  deep-coverage graph (tools/bigscale_bench.py), with one and with several
  merge groups.
- `chunk_levels` (vectorized across groups) equals `chunk_levels_plain`
  (a per-chunk loop) exactly.
- Running a group's chunks in level order, or in reversed order within
  each level, gives the chain's drift exactly (torch.equal).
- The predecessors of `chunk_schedule`: each chunk's are exactly the last
  earlier chunk of its group on each block of its footprint (against a
  plain loop), they come before it in perm, and every earlier chunk that
  shares a slot with a chunk is among its ancestors, so a kernel that runs
  each chunk after its predecessors orders every conflicting pair.
- `chunk_schedule` (in C++, native/src/strata_schedule.cpp)
  equals `chunk_schedule_numpy` array for array, and a state built
  without the C++ library carries the same schedule.
- Running a group's chunks in perm order, or in a seeded random order that
  puts every chunk after its predecessors, gives the chain's drift exactly
  (torch.equal), 2D and 1D.
- The leveled 2D and 1D runs stay within the stated tolerances of
  odgi_tpu's exact twins path_sgd_2d_strata_xla / path_sgd_1d_strata_xla on
  every route: 1e-6 of the coordinate scale after short runs, 1e-4 after
  the default schedule (tests/test_torch_strata_sgd.py gives the reasons).
"""

import numpy as np
import pytest
import torch

from odgi_tpu.algorithms.layout import init_layout as j_init_layout
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import sgd as j_sgd
from tools.bigscale_bench import synth_graph

from odgi_tpu_torch import native
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import kernels, sgd, strata_levels, strata_plan, strata_sgd

SHORT_TOL = 1e-6
DEFAULT_TOL = 1e-4
CHUNK, LANE = strata_plan.CHUNK, strata_plan.LANE


def _walk(nodes, paths, steps, jump, seed, seq=b"ACGT"):
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, nodes + 1):
        b.add_node(i, seq * int(rng.integers(1, 5)) if len(seq) > 1 else seq)
    for i in range(1, nodes):
        b.add_edge(i, False, i + 1, False)
    for pi in range(paths):
        p = b.add_path(f"p{pi}")
        n = 1
        for _ in range(steps):
            b.append_step(p, n, bool(rng.integers(0, 2)))
            n = int(np.clip(n + rng.integers(-jump, jump + 1), 1, nodes))
    return b.build()


def _port(gj):
    return graph_from_arrays(graph_to_arrays(gj))


GRAPHS = {
    # one path of 3000 1-bp steps: space < CHUNK, every window runs past S
    "short": lambda: _walk(400, 1, 3000, 3, 3, seq=b"A"),
    # tests/test_pallas_sgd.py's graph: 3 paths x 1600 steps over 120 nodes
    "walk": lambda: _walk(120, 3, 1600, 2, 7),
    # deep coverage: 8 paths x 6000 steps over 1500 1-bp nodes
    "synth": lambda: synth_graph(48_000, 1500, 6000, seed=4),
}
# min_term_updates per graph: the synthetic graph's plan has 64+ chunks a
# group, room for levels of several chunks
TERMS = {"short": 3 * 1024, "walk": 3 * 1024, "synth": 64 * CHUNK}
PLANS = [("short", 1), ("short", 3), ("walk", 1), ("walk", 3), ("synth", 2)]
PLAN_IDS = [f"{g}-iter{i}" for g, i in PLANS]


@pytest.fixture(scope="module")
def graph_cache():
    return {}


def _graph(graph_cache, name):
    if name not in graph_cache:
        graph_cache[name] = GRAPHS[name]()
    return graph_cache[name]


def _plan(gj, iter_max, name, one_d=False):
    gt = _port(gj)
    derive = sgd.derive_config_1d if one_d else sgd.derive_config_2d
    cfg = derive(gt, iter_max=iter_max, min_term_updates=TERMS[name])
    return gt, cfg, strata_plan.plan_run(gt, cfg, one_d=one_d)


def _levels_of(p, perm, lvl_off):
    """Level (1-based) of every chunk, from the schedule."""
    lvl = np.zeros(p["groups"] * p["cgs"], np.int64)
    for g in range(p["groups"]):
        for l in range(lvl_off.shape[1] - 1):
            lvl[perm[lvl_off[g, l]:lvl_off[g, l + 1]]] = l + 1
    return lvl


def _assert_valid_schedule(gt, p, name, iter_max):
    perm, lvl_off = strata_levels.chunk_levels(p)
    groups, cgs = p["groups"], p["cgs"]
    assert groups >= iter_max
    assert perm.dtype == np.int32 and perm.shape == (groups * cgs,)
    assert lvl_off.dtype == np.int32 and lvl_off.shape[0] == groups
    lvl = _levels_of(p, perm, lvl_off)
    o = p["o_blk"].astype(np.int64) * LANE
    d = p["d_arr"].astype(np.int64)
    L = p["data"].num_slots
    if name == "short":
        assert (d < CHUNK).all() and (o + CHUNK > gt.num_steps).all()
    for g in range(groups):
        lo, hi = g * cgs, (g + 1) * cgs
        assert sorted(perm[lo:hi].tolist()) == list(range(lo, hi))
        assert lvl_off[g, 0] == lo and lvl_off[g, -1] == hi
        assert (lvl[lo:hi] >= 1).all()
        # within a level: pairwise slot-disjoint footprints
        for lv in np.unique(lvl[lo:hi]):
            marks = np.zeros(L, np.int32)
            for j in np.nonzero(lvl[lo:hi] == lv)[0] + lo:
                fp = np.zeros(L, bool)
                fp[o[j]:o[j] + CHUNK] = True
                fp[o[j] + d[j]:o[j] + d[j] + CHUNK] = True
                marks += fp
            assert marks.max() <= 1
        # every earlier chunk sharing a slot sits on a lower level
        for j in range(lo + 1, hi):
            i = np.arange(lo, j)
            inter = lambda x0, y0: (x0 < y0 + CHUNK) & (y0 < x0 + CHUNK)
            conflict = (inter(o[i], o[j]) | inter(o[i], o[j] + d[j])
                        | inter(o[i] + d[i], o[j]) | inter(o[i] + d[i], o[j] + d[j]))
            assert (lvl[i][conflict] < lvl[j]).all()
    depth = strata_levels.depths(lvl_off)
    if name == "short":  # every window covers every step: a pure chain
        assert (depth == cgs).all()
    if name == "synth":  # 48,000 steps: room for disjoint windows
        assert cgs >= 64 and depth.max() < cgs // 2


@pytest.mark.parametrize("name,iter_max", PLANS, ids=PLAN_IDS)
def test_levels_are_a_valid_schedule(graph_cache, name, iter_max):
    gt, _, p = _plan(_graph(graph_cache, name), iter_max, name)
    _assert_valid_schedule(gt, p, name, iter_max)


@pytest.mark.parametrize("name,iter_max", PLANS, ids=PLAN_IDS)
def test_levels_are_a_valid_schedule_1d(graph_cache, name, iter_max):
    """A footprint depends only on (o, D): 1D plans level by the same rule."""
    gt, _, p = _plan(_graph(graph_cache, name), iter_max, name, one_d=True)
    assert p["data"].one_d
    _assert_valid_schedule(gt, p, name, iter_max)


def _assert_levels_equal_plain_loop(p):
    perm, lvl_off = strata_levels.chunk_levels(p)
    perm_p, lvl_off_p = strata_levels.chunk_levels_plain(p)
    np.testing.assert_array_equal(perm, perm_p)
    np.testing.assert_array_equal(lvl_off, lvl_off_p)


@pytest.mark.parametrize("name,iter_max", PLANS, ids=PLAN_IDS)
def test_levels_equal_plain_loop(graph_cache, name, iter_max):
    _assert_levels_equal_plain_loop(_plan(_graph(graph_cache, name), iter_max, name)[2])


@pytest.mark.parametrize("name,iter_max", PLANS, ids=PLAN_IDS)
def test_levels_equal_plain_loop_1d(graph_cache, name, iter_max):
    _assert_levels_equal_plain_loop(
        _plan(_graph(graph_cache, name), iter_max, name, one_d=True)[2])


def _reversed_within_levels(perm, lvl_off):
    out = perm.copy()
    for row in lvl_off:
        for a, b in zip(row[:-1], row[1:]):
            out[a:b] = perm[a:b][::-1]
    return out


@pytest.mark.parametrize("order", ["levels", "reversed"])
@pytest.mark.parametrize("name", ["short", "synth"])
def test_leveled_chunks_equal_chain(graph_cache, name, order):
    gj = _graph(graph_cache, name)
    gt, cfg, _ = _plan(gj, 2, name)
    st = strata_sgd.StrataState.build(gt, cfg, j_init_layout(gj, "d"), False,
                                      torch.device("cpu"))
    p = st.plan
    perm_h, lvl_off = strata_levels.chunk_levels(p)
    if order == "reversed":
        perm_h = _reversed_within_levels(perm_h, lvl_off)
    perm = torch.from_numpy(perm_h)
    depth = strata_levels.depths(lvl_off)
    assert torch.equal(st.perm, torch.from_numpy(strata_levels.chunk_levels(p)[0]))
    for gid in range(p["groups"]):
        row = torch.from_numpy(lvl_off[gid, :depth[gid] + 1])
        d_l, d_c = st.drift.clone(), st.drift.clone()
        strata_sgd.chunks_2d_levels_plain(d_l, st.base, st.planes, st.od, st.eta, p["cpi"],
                                          perm, row)
        strata_sgd.chunks_2d_plain(d_c, st.base, st.planes, st.od, st.eta, p["cpi"],
                                   gid * p["cgs"], p["cgs"])
        assert torch.equal(d_l, d_c)
        assert float(d_c.abs().max()) > 0
        st.drift = d_c
        kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)


@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
@pytest.mark.parametrize("kw,tol", [
    (dict(iter_max=2, min_term_updates=3 * 1024), SHORT_TOL),
    (dict(iter_max=3, min_term_updates=3 * 1024), SHORT_TOL),
], ids=["iter2", "iter3"])
def test_leveled_runs_match_twin(graph_cache, route, kw, tol):
    gj = _graph(graph_cache, "walk")
    gt = _port(gj)
    c0 = j_init_layout(gj, "d")
    twin = np.asarray(ps.path_sgd_2d_strata_xla(gj, c0, j_sgd.derive_config_2d(gj, **kw)))
    port = strata_sgd.path_sgd_2d_strata(gt, c0, sgd.derive_config_2d(gt, **kw), "cpu",
                                         route=route).numpy()
    assert np.isfinite(port).all()
    assert np.abs(port - twin).max() / (np.abs(twin).max() + 1) <= tol
    assert np.abs(port - c0).max() > 1.0


def test_leveled_default_schedule_matches_twin(graph_cache):
    gj = _graph(graph_cache, "walk")
    gt = _port(gj)
    c0 = j_init_layout(gj, "d")
    twin = np.asarray(ps.path_sgd_2d_strata_xla(gj, c0, j_sgd.derive_config_2d(gj)))
    st = strata_sgd.StrataState.build(gt, sgd.derive_config_2d(gt), c0, False,
                                      torch.device("cpu"))
    assert st.perm is not None and len(st.lvl_rows) == st.plan["groups"]
    st.run()
    port = st.coords.T.numpy()
    assert np.abs(port - twin).max() / (np.abs(twin).max() + 1) <= DEFAULT_TOL


def test_one_d_state_has_levels(graph_cache):
    """A 1D state carries its conflict levels, as a 2D state does, and no
    sync flags: no kernel reads them."""
    gt = _port(_graph(graph_cache, "walk"))
    cfg = sgd.derive_config_1d(gt, iter_max=1, min_term_updates=3 * 1024)
    st = strata_sgd.StrataState.build(gt, cfg, gt.node_offset.astype(np.float32), True,
                                      torch.device("cpu"))
    perm, lvl_off = strata_levels.chunk_levels(st.plan)
    assert torch.equal(st.perm, torch.from_numpy(perm))
    depth = strata_levels.depths(lvl_off)
    assert len(st.lvl_rows) == st.plan["groups"]
    for gid, row in enumerate(st.lvl_rows):
        assert torch.equal(row, torch.from_numpy(lvl_off[gid, :depth[gid] + 1]))
    assert not hasattr(st, "sync")


@pytest.mark.parametrize("order", ["levels", "reversed"])
@pytest.mark.parametrize("name", ["short", "synth"])
def test_leveled_chunks_1d_equal_chain(graph_cache, name, order):
    gj = _graph(graph_cache, name)
    gt, cfg, _ = _plan(gj, 2, name, one_d=True)
    st = strata_sgd.StrataState.build(gt, cfg, gt.node_offset.astype(np.float32), True,
                                      torch.device("cpu"))
    p = st.plan
    perm_h, lvl_off = strata_levels.chunk_levels(p)
    if order == "reversed":
        perm_h = _reversed_within_levels(perm_h, lvl_off)
    perm = torch.from_numpy(perm_h)
    depth = strata_levels.depths(lvl_off)
    if name == "synth":
        assert depth.max() < p["cgs"]
    for gid in range(p["groups"]):
        row = torch.from_numpy(lvl_off[gid, :depth[gid] + 1])
        d_l, d_c = st.drift.clone(), st.drift.clone()
        strata_sgd.chunks_1d_levels_plain(d_l, st.base, st.planes, st.od, st.eta, p["cpi"],
                                          perm, row)
        strata_sgd.chunks_1d_plain(d_c, st.base, st.planes, st.od, st.eta, p["cpi"],
                                   gid * p["cgs"], p["cgs"])
        assert torch.equal(d_l, d_c)
        assert float(d_c.abs().max()) > 0
        st.drift = d_c
        kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)


@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
@pytest.mark.parametrize("kw,tol", [
    (dict(iter_max=2, min_term_updates=3 * 1024), SHORT_TOL),
    (dict(iter_max=3, min_term_updates=3 * 1024), SHORT_TOL),
], ids=["iter2", "iter3"])
def test_leveled_runs_1d_match_twin(graph_cache, route, kw, tol):
    gj = _graph(graph_cache, "walk")
    gt = _port(gj)
    twin = np.asarray(ps.path_sgd_1d_strata_xla(gj, j_sgd.derive_config_1d(gj, **kw)))
    port = strata_sgd.path_sgd_1d_strata(gt, sgd.derive_config_1d(gt, **kw), None, "cpu",
                                         route=route).numpy()
    assert np.isfinite(port).all()
    assert np.abs(port - twin).max() / (np.abs(twin).max() + 1) <= tol
    assert np.abs(port - gt.node_offset).max() > 1.0


@pytest.mark.parametrize("route", ["xl", "xxl"])
def test_leveled_default_schedule_1d_matches_twin(graph_cache, route):
    gj = _graph(graph_cache, "walk")
    gt = _port(gj)
    twin = np.asarray(ps.path_sgd_1d_strata_xla(gj, j_sgd.derive_config_1d(gj)))
    port = strata_sgd.path_sgd_1d_strata(gt, sgd.derive_config_1d(gt), None, "cpu",
                                         route=route).numpy()
    assert np.abs(port - twin).max() / (np.abs(twin).max() + 1) <= DEFAULT_TOL


def _conflicts(o, d, i, j):
    """Whether chunks i and j (slot starts o, jumps d) share a slot."""
    inter = lambda x0, y0: (x0 < y0 + CHUNK) & (y0 < x0 + CHUNK)
    return bool(inter(o[i], o[j]) | inter(o[i], o[j] + d[j]) | inter(o[i] + d[i], o[j])
                | inter(o[i] + d[i], o[j] + d[j]))


def _assert_valid_preds(p):
    perm, lvl_off, pred_off, pred = strata_levels.chunk_schedule(p)
    perm_p, lvl_off_p, preds_p = strata_levels.chunk_schedule_plain(p)
    np.testing.assert_array_equal(perm, perm_p)
    np.testing.assert_array_equal(lvl_off, lvl_off_p)
    groups, cgs = p["groups"], p["cgs"]
    assert pred_off.dtype == np.int32 and pred.dtype == np.int32
    assert pred_off.shape == (groups * cgs + 1,) and pred_off[0] == 0
    assert pred_off[-1] == len(pred) and (np.diff(pred_off) >= 0).all()
    o = p["o_blk"].astype(np.int64) * LANE
    d = p["d_arr"].astype(np.int64)
    lvl = _levels_of(p, perm, lvl_off)
    where = np.empty_like(perm)
    where[perm] = np.arange(len(perm))
    for g in range(groups):
        anc = {}
        for j in range(g * cgs, (g + 1) * cgs):
            mine = pred[pred_off[j]:pred_off[j + 1]].tolist()
            # exactly the last earlier chunk on each footprint block
            assert sorted(set(mine)) == preds_p[j]
            assert all(g * cgs <= q < j and where[q] < where[j] for q in mine)
            # levels: 1 + the highest level of the predecessors
            assert lvl[j] == 1 + max((lvl[q] for q in mine), default=0)
            anc[j] = set(mine).union(*(anc[q] for q in mine))
            for i in range(g * cgs, j):
                if _conflicts(o, d, i, j):
                    assert i in anc[j]


@pytest.mark.parametrize("one_d", [False, True], ids=["2d", "1d"])
@pytest.mark.parametrize("name,iter_max", PLANS, ids=PLAN_IDS)
def test_predecessors_order_every_conflict(graph_cache, name, iter_max, one_d):
    _, _, p = _plan(_graph(graph_cache, name), iter_max, name, one_d=one_d)
    _assert_valid_preds(p)


def _random_topological(perm, pred_off, pred, g0, cgs, rng):
    """The group's chunks in a random order that puts each after its
    predecessors: a random ready chunk at a time."""
    left = {j: set(pred[pred_off[j]:pred_off[j + 1]].tolist()) for j in perm[g0:g0 + cgs]}
    out = []
    while left:
        ready = sorted(j for j, ps in left.items() if not ps)
        j = ready[int(rng.integers(len(ready)))]
        out.append(j)
        del left[j]
        for ps in left.values():
            ps.discard(j)
    return out


@pytest.mark.parametrize("order", ["perm", "random"])
@pytest.mark.parametrize("one_d", [False, True], ids=["2d", "1d"])
@pytest.mark.parametrize("name", ["short", "synth"])
def test_schedule_orders_equal_chain(graph_cache, name, one_d, order):
    gj = _graph(graph_cache, name)
    gt, cfg, _ = _plan(gj, 2, name, one_d=one_d)
    init = gt.node_offset.astype(np.float32) if one_d else j_init_layout(gj, "d")
    st = strata_sgd.StrataState.build(gt, cfg, init, one_d, torch.device("cpu"))
    p = st.plan
    perm_h, lvl_off, pred_off, pred = strata_levels.chunk_schedule(p)
    assert torch.equal(st.perm, torch.from_numpy(perm_h))
    assert torch.equal(st.pred_off, torch.from_numpy(pred_off))
    assert torch.equal(st.pred, torch.from_numpy(pred))
    levels_plain = strata_sgd.chunks_1d_levels_plain if one_d else strata_sgd.chunks_2d_levels_plain
    chain = strata_sgd.chunks_1d_plain if one_d else strata_sgd.chunks_2d_plain
    rng = np.random.default_rng(17)
    for gid in range(p["groups"]):
        g0, cgs = gid * p["cgs"], p["cgs"]
        if order == "perm":
            perm = st.perm
        else:
            perm = st.perm.clone()
            perm[g0:g0 + cgs] = torch.as_tensor(
                _random_topological(perm_h, pred_off, pred, g0, cgs, rng))
            assert not torch.equal(perm, st.perm) or cgs == 1 or name == "short"
        row = torch.tensor([g0, g0 + cgs], dtype=torch.int32)
        d_s, d_c = st.drift.clone(), st.drift.clone()
        levels_plain(d_s, st.base, st.planes, st.od, st.eta, p["cpi"], perm, row)
        chain(d_c, st.base, st.planes, st.od, st.eta, p["cpi"], g0, cgs)
        assert torch.equal(d_s, d_c)
        assert float(d_c.abs().max()) > 0
        st.drift = d_c
        kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)


@pytest.mark.parametrize("one_d", [False, True], ids=["2d", "1d"])
@pytest.mark.parametrize("name,iter_max", PLANS, ids=PLAN_IDS)
def test_native_schedule_equals_numpy(graph_cache, name, iter_max, one_d):
    _, _, p = _plan(_graph(graph_cache, name), iter_max, name, one_d=one_d)
    assert native.schedule_lib() is not None, native._schedule["error"]
    got, want = strata_levels.chunk_schedule(p), strata_levels.chunk_schedule_numpy(p)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_state_without_native_schedule(graph_cache, monkeypatch):
    gj = _graph(graph_cache, "synth")
    gt, cfg, _ = _plan(gj, 2, "synth")
    c0 = j_init_layout(gj, "d")
    st = strata_sgd.StrataState.build(gt, cfg, c0, False, torch.device("cpu"))
    monkeypatch.setattr(native, "schedule_lib", lambda: None)
    st_np = strata_sgd.StrataState.build(gt, cfg, c0, False, torch.device("cpu"))
    for f in ("perm", "pred_off", "pred"):
        assert torch.equal(getattr(st, f), getattr(st_np, f))
    assert all(torch.equal(a, b) for a, b in zip(st.lvl_rows, st_np.lvl_rows))
