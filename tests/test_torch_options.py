"""The PG-SGD options of `sort -Y` and `layout` in the port, on the CPU,
against odgi_tpu:
- delta early stop (-j) on the resident route against the reference's
  tracked kernels path_sgd_1d_pallas / path_sgd_2d_pallas in interpret
  mode: a huge delta stops both after one iteration, an interior delta
  (picked from the port's own per-iteration Delta_max values, 1e-3 below
  every earlier one, so that f32 noise cannot move the stop) stops both at
  the same iteration; coordinates within 1e-4 of the scale, the bar
  tests/test_pallas_sgd.py holds the reference's kernel to.  A 1e-30
  delta (never stops) equals the untracked run bit for bit;
- delta past the resident route takes the batched path, with the note;
- use_paths (-f): the run of the kept paths' graph, and
  path_sgd_*_strata_xla on it, within 1e-6 of the scale (short runs);
- the init modes d u r g h and the TSV export byte-equal to odgi_tpu's.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from odgi_tpu.algorithms import layout as j_layout
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import sgd as j_sgd

import odgi_tpu_torch as ot
from odgi_tpu_torch.algorithms import layout
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import sgd, strata_route, strata_sgd

KERNEL_TOL = 1e-4
SHORT_TOL = 1e-6
SHORT = dict(iter_max=4, min_term_updates=3 * 1024)
# delta runs: a few chunks an iteration, so that every iteration has
# valid pairs (a one-chunk iteration can have none, and stop any run)
DELTA = dict(iter_max=6, min_term_updates=16 * 1024)


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


def _rel(a, ref):
    return np.abs(np.asarray(a) - np.asarray(ref)).max() / (np.abs(ref).max() + 1)


def _runs(gj, gt, one_d):
    """(port run, reference run, config maker) of one dimension."""
    if one_d:
        return (lambda cfg: sgd.path_sgd_1d(gt, cfg, device="cpu").numpy(),
                lambda cfg: ps.path_sgd_1d_pallas(gj, cfg, interpret=True),
                lambda **kw: (j_sgd.derive_config_1d(gj, **kw), sgd.derive_config_1d(gt, **kw)))
    c0 = j_layout.init_layout(gj, "d")
    return (lambda cfg: sgd.path_sgd_2d(gt, c0, cfg, device="cpu").numpy(),
            lambda cfg: ps.path_sgd_2d_pallas(gj, c0, cfg, interpret=True),
            lambda **kw: (j_sgd.derive_config_2d(gj, **kw), sgd.derive_config_2d(gt, **kw)))


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_huge_delta_stops_after_one_iteration(graphs, one_d):
    gj, gt = graphs
    port, ref, cfgs = _runs(gj, gt, one_d)
    cfg_j, cfg_t = cfgs(delta=1e9, **DELTA)
    got = port(cfg_t)
    assert sgd.LAST_RUN["route"] == "resident" and sgd.LAST_RUN["iterations"] == 1
    assert len(sgd.LAST_RUN["delta_max"]) == 1 and sgd.LAST_RUN["delta_max"][0] > 0
    assert _rel(got, ref(cfg_j)) <= KERNEL_TOL


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_interior_delta_stops_at_the_same_iteration(graphs, one_d):
    gj, gt = graphs
    port, ref, cfgs = _runs(gj, gt, one_d)
    _, cfg_t = cfgs(delta=1e-30, **DELTA)
    port(cfg_t)
    dm = sgd.LAST_RUN["delta_max"]
    assert len(dm) == 6 and sgd.LAST_RUN["iterations"] == 6
    k = next(i for i in range(1, 5) if all(dm[i] <= (1 - 1e-3) * v for v in dm[:i]))
    delta = dm[k] * (1 + 2e-4)
    cfg_j, cfg_t = cfgs(delta=delta, **DELTA)
    got = port(cfg_t)
    assert sgd.LAST_RUN["iterations"] == k + 1
    assert sgd.LAST_RUN["delta_max"] == dm[:k + 1]
    want = ref(cfg_j)
    assert _rel(got, want) <= KERNEL_TOL
    # the reference stopped there too: its run of k + 2 iterations of the
    # same plan would have moved on
    cfg_more = dataclasses.replace(cfg_j, delta=dm[k] * 1e-3)
    assert not np.array_equal(np.asarray(ref(cfg_more)), np.asarray(want))


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_tiny_delta_equals_untracked_run(graphs, one_d):
    gj, gt = graphs
    port, _, cfgs = _runs(gj, gt, one_d)
    _, cfg_t = cfgs(**DELTA)
    plain = port(cfg_t)
    assert sgd.LAST_RUN["delta_max"] == []
    tracked = port(dataclasses.replace(cfg_t, delta=1e-30))
    assert sgd.LAST_RUN["iterations"] == cfg_t.iter_max
    assert np.array_equal(plain, tracked)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_plain_dmax_is_the_groups_max_delta(graphs, one_d):
    """The plain leveled chunk phase with dmax leaves the drift as without
    it, and its word holds the max |delta| over the group's valid pairs,
    recomputed here pair by pair from the chain's drift changes."""
    gj, gt = graphs
    if one_d:
        st = strata_sgd.StrataState.build(gt, sgd.derive_config_1d(gt, **SHORT),
                                          gt.node_offset.astype(np.float32), True, "cpu")
        chunks = strata_sgd.chunks_1d_levels_plain
    else:
        st = strata_sgd.StrataState.build(gt, sgd.derive_config_2d(gt, **SHORT),
                                          j_layout.init_layout(gj, "d"), False, "cpu")
        chunks = strata_sgd.chunks_2d_levels_plain
    assert st.merges_per_iteration() * st.plan["cgs"] == st.plan["cpi"]
    args = (st.base, st.planes, st.od, st.eta, st.plan["cpi"], st.perm, st.lvl_rows[0])
    d0, d1 = st.drift.clone(), st.drift.clone()
    chunks(d0, *args)
    dm = torch.zeros(1)
    chunks(d1, *args, dmax=dm)
    assert torch.equal(d0, d1)
    # each chunk's max |delta|, one chunk at a time, on the chain's order
    d2, per = st.drift.clone(), []
    for gl in range(st.plan["cgs"]):
        w = torch.zeros(1)
        (strata_sgd.chunks_1d_plain if one_d else strata_sgd.chunks_2d_plain)(
            d2, st.base, st.planes, st.od, st.eta, st.plan["cpi"], gl, 1, dmax=w)
        per.append(float(w))
    assert torch.equal(d2, d0)
    assert float(dm) == max(per) > 0


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("forced", ["xl", "xxl"])
def test_delta_past_resident_takes_batched_path(graphs, one_d, forced, monkeypatch, capsys):
    gj, gt = graphs
    if forced == "xl":
        monkeypatch.setattr(strata_route, "VMEM_BUDGET", 1)
    else:
        monkeypatch.setattr(strata_route, "MAX_NODE_ROWS", 0)
    port, _, cfgs = _runs(gj, gt, one_d)
    _, cfg_t = cfgs(**SHORT)
    port(cfg_t)
    assert sgd.LAST_RUN["route"] == forced
    assert sgd.DELTA_NOTE not in capsys.readouterr().err
    port(dataclasses.replace(cfg_t, delta=1e-30))
    assert sgd.LAST_RUN["route"] == "batched"
    assert sgd.LAST_RUN["iterations"] == cfg_t.iter_max
    assert sgd.DELTA_NOTE in capsys.readouterr().err


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("use_paths", [[0, 2], [1]], ids=["two", "one"])
def test_use_paths_runs_the_kept_graph(graphs, one_d, use_paths):
    gj, gt = graphs
    kept_j, kept_t = gj.keep_paths(use_paths), gt.keep_paths(use_paths)
    if one_d:
        cfg_t = sgd.derive_config_1d(gt, **SHORT)  # from the whole graph
        got = sgd.path_sgd_1d(gt, cfg_t, use_paths=use_paths, device="cpu").numpy()
        on_kept = sgd.path_sgd_1d(kept_t, cfg_t, device="cpu").numpy()
        twin = ps.path_sgd_1d_strata_xla(kept_j, j_sgd.derive_config_1d(gj, **SHORT))
    else:
        c0 = j_layout.init_layout(gj, "d")
        cfg_t = sgd.derive_config_2d(gt, **SHORT)
        got = sgd.path_sgd_2d(gt, c0, cfg_t, use_paths=use_paths, device="cpu").numpy()
        on_kept = sgd.path_sgd_2d(kept_t, c0, cfg_t, device="cpu").numpy()
        twin = ps.path_sgd_2d_strata_xla(kept_j, c0, j_sgd.derive_config_2d(gj, **SHORT))
    assert sgd.LAST_RUN["route"] == "resident"
    assert _rel(got, on_kept) <= SHORT_TOL
    assert _rel(got, twin) <= SHORT_TOL
    # nodes no kept path visits stay where they started (1D from f32
    # positions, 2D from the f64 coordinates)
    visited = np.zeros(gt.num_nodes, bool)
    visited[kept_t.step_handle >> 1] = True
    assert not visited.all()
    if one_d:
        start = gt.node_offset.astype(np.float32).astype(np.float64)
        assert np.array_equal(got[~visited], start[~visited])
    else:
        idx = np.repeat(~visited, 2)
        assert np.array_equal(got[idx], c0[idx])


def test_layout_graph_takes_use_paths_and_snapshots(graphs):
    gj, gt = graphs
    cfg = sgd.derive_config_2d(gt, **SHORT)
    seen = []
    snap = ot.layout_graph(gt, cfg, init_mode="u", snapshot_cb=lambda it, c: seen.append(it),
                           device="cpu")
    assert seen == list(range(cfg.iter_max)) and sgd.LAST_RUN["route"] == "batched"
    sub = ot.layout_graph(gt, cfg, init_mode="u", use_paths=[1], device="cpu")
    c0 = j_layout.init_layout(gj, "u")
    twin = ps.path_sgd_2d_strata_xla(gj.keep_paths([1]), c0, j_sgd.derive_config_2d(gj, **SHORT))
    assert _rel(sub, j_layout.pack_components(gj, np.asarray(twin))) <= SHORT_TOL
    assert np.isfinite(snap).all()


@pytest.mark.parametrize("mode", list("durgh"))
def test_init_layout_modes_equal_reference(graphs, mode):
    gj, gt = graphs
    ref = j_layout.init_layout(gj, mode, seed=17)
    got = layout.init_layout(gt, mode, seed=17)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert all(layout.hilbert_d2xy(16, d) == j_layout.hilbert_d2xy(16, d) for d in range(256))


def test_layout_to_tsv_equals_reference(graphs):
    gj, gt = graphs
    coords = j_layout.init_layout(gj, "g", seed=3)
    coords[:5] = [[0.0, -0.0], [1e-300, 1.5], [123456789.125, -2.0 / 3], [np.pi, 1e17],
                  [-1e-7, 42.0]]
    a, b = io.StringIO(), io.StringIO()
    j_layout.layout_to_tsv(coords, a)
    layout.layout_to_tsv(coords, b)
    assert a.getvalue() == b.getvalue()
