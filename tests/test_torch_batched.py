"""The port's batched PG-SGD path (odgi_tpu_torch/ops/batched_sgd.py) against
odgi_tpu's batched half of ops/sgd.py, on the CPU.

The reference draws its random words from jax.random's "rbg" generator,
which the port cannot reproduce, so the pieces are held apart:
- zeta_index exactly; zipf_sample lane for lane on 10^5 seeded uniforms.
  XLA's f32 log and exp differ from PyTorch's in the last bits, so a rare
  lane's floor lands one step off: measured 0.0005% of lanes at spaces up
  to 5,000, 0.005% up to 50,000 and 0.1% up to 10^6.  The bars are 99.99%
  of lanes equal up to 50,000 (the 2D step spaces and the 1D nucleotide
  spaces of these graphs) and 99.8% at 10^6, every other lane one step off;
- sample_pairs, fed the reference's own words, gives its second steps
  within that tolerance;
- update_1d / update_2d, fed the pairs the reference sampled, give its
  scatter-form updates (mxu_* off, as on the CPU) within 1e-6 of the
  coordinate scale and the same batch max;
- whole runs (graphs under 1,024 steps, the default schedules) by quality:
  nt-distance and stress within 5% of the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odgi_tpu.algorithms import stats as j_stats
from odgi_tpu.algorithms.layout import init_layout as j_init_layout
from odgi_tpu.algorithms.path_sgd_sort import order_from_x as j_order_from_x
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import sgd as j_sgd
from odgi_tpu.ops import zipf as j_zipf

from odgi_tpu_torch.algorithms.path_sgd_sort import order_from_x
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import batched_sgd as bs
from odgi_tpu_torch.ops import sgd, zipf

UPDATE_TOL = 1e-6
QUALITY_RTOL = 0.05


def _walk(nodes, paths, steps, seed=7, shuffle=True):
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    for i in range(1, nodes + 1):
        b.add_node(i, b"ACGT" * int(rng.integers(1, 5)))
    for i in range(1, nodes):
        b.add_edge(i, False, i + 1, False)
    for pi in range(paths):
        p = b.add_path(f"p{pi}")
        n = 1
        for _ in range(steps):
            b.append_step(p, n, bool(rng.integers(0, 2)))
            n = int(np.clip(n + rng.integers(-2, 3), 1, nodes))
    gj = b.build()
    if shuffle:
        gj = gj.apply_ordering(np.random.default_rng(5).permutation(nodes))
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.fixture(scope="module")
def small():
    """900 steps (3 paths x 300) over 40 nodes: the batched path."""
    return _walk(40, 3, 300)


@pytest.fixture(scope="module")
def medium():
    """4,800 steps (3 paths x 1,600) over 120 nodes."""
    return _walk(120, 3, 1600, shuffle=False)


def _cfgs(gj, gt, one_d, **kw):
    if one_d:
        return j_sgd.derive_config_1d(gj, **kw), sgd.derive_config_1d(gt, **kw)
    return j_sgd.derive_config_2d(gj, **kw), sgd.derive_config_2d(gt, **kw)


def _data(gj, gt, cfg_j, cfg_t, use_paths=None):
    args = lambda c: (c.theta, c.space, c.space_max, c.space_quantization_step, use_paths)
    return j_sgd.SgdData.build(gj, *args(cfg_j)), bs.SgdData.build(gt, *args(cfg_t),
                                                                   device="cpu")


@pytest.mark.parametrize("space,space_max,quant,min_equal", [
    (5_000, 1000, 100, 0.9999), (50_000, 100, 499, 0.9999), (1_000_000, 100, 10_000, 0.998),
], ids=["5e3", "5e4", "1e6"])
def test_zeta_index_and_zipf_sample(space, space_max, quant, min_equal):
    rng = np.random.default_rng(3)
    ze = j_zipf.zeta_eta_table(space, space_max, quant, 0.99)
    n = rng.integers(1, space + 1, 100_000).astype(np.int32)
    zi = np.asarray(j_zipf.zeta_index(jnp.asarray(n), space_max, quant))
    assert np.array_equal(zipf.zeta_index(torch.as_tensor(n), space_max, quant).numpy(), zi)
    u = (rng.integers(0, 2**32, n.size, dtype=np.uint64) >> 8).astype(np.float32) \
        * np.float32(2**-24)
    ref = np.asarray(j_zipf.zipf_sample(jnp.asarray(u), jnp.asarray(n), 0.99,
                                        jnp.float32(ze[2, 0]), jnp.asarray(ze[zi, 0]),
                                        eta=jnp.asarray(ze[zi, 1])))
    got = zipf.zipf_sample(torch.as_tensor(u), torch.as_tensor(n), 0.99,
                           torch.as_tensor(ze[zi, 0]), torch.as_tensor(ze[zi, 1])).numpy()
    assert (got == ref).mean() >= min_equal
    assert np.abs(got.astype(np.int64) - ref).max() <= 1
    assert got.min() >= 1 and (got <= n).all()


@pytest.mark.parametrize("use_paths", [None, [0, 2], [1]], ids=["all", "two", "one"])
def test_sgd_data_equals_reference(medium, use_paths):
    gj, gt = medium
    for one_d in (True, False):
        cfg_j, cfg_t = _cfgs(gj, gt, one_d)
        dj, dt = _data(gj, gt, cfg_j, cfg_t, use_paths)
        for f in ("tab_a", "tab_b", "zetas", "zeta_eta"):
            a, b = np.asarray(getattr(dj, f)), getattr(dt, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (dt.num_steps, dt.num_nodes) == (dj.num_steps, dj.num_nodes)


@pytest.mark.parametrize("graph", ["small", "medium"])
@pytest.mark.parametrize("kw", [{}, dict(batch_size=100), dict(iter_max=7, space_max=50),
                                dict(batch_size=10**6, delta=0.5)],
                         ids=["default", "batch", "overrides", "clamped"])
def test_derived_configs_equal_reference(request, graph, kw):
    gj, gt = request.getfixturevalue(graph)
    shared = [f.name for f in dataclasses.fields(sgd.SgdConfig)]
    for one_d in (True, False):
        cfg_j, cfg_t = _cfgs(gj, gt, one_d, **kw)
        assert {f: getattr(cfg_t, f) for f in shared} == {f: getattr(cfg_j, f) for f in shared}
        assert cfg_t.num_batches == cfg_j.num_batches
        assert cfg_t.first_cooling_iteration == cfg_j.first_cooling_iteration
    # every field the two configs share is there; the rest steer XLA only
    assert set(f.name for f in dataclasses.fields(j_sgd.SgdConfig)) - set(shared) == {
        "mxu_coords", "mxu_tables", "pallas", "rng_impl"}


def _step_of(gt, cols_a_lo, rows_b_pos):
    """Second-step indices of the reference's rows: the step of its path
    (first step `lo`) at path position `pos` (unique within a path)."""
    out = np.empty(len(cols_a_lo), np.int64)
    for lo in np.unique(cols_a_lo):
        p = int(np.searchsorted(gt.path_offset, lo, side="right")) - 1
        pos = gt.step_pos[gt.path_offset[p]:gt.path_offset[p + 1]]
        m = cols_a_lo == lo
        out[m] = lo + np.searchsorted(pos, rows_b_pos[m])
    return out


def _reference_words(seed: int, b: int, B: int):
    kb = jax.random.fold_in(jax.random.key(seed, impl="rbg"), b)
    return kb, np.array(jax.random.bits(kb, (2, B), jnp.uint32))


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("cooling", [False, True], ids=["warm", "cooling"])
def test_sample_pairs_on_reference_words(medium, one_d, cooling):
    gj, gt = medium
    cfg_j, cfg_t = _cfgs(gj, gt, one_d)
    cfg_j = dataclasses.replace(cfg_j, batch_size=gt.num_steps)
    cfg_t = dataclasses.replace(cfg_t, batch_size=gt.num_steps)
    dj, dt = _data(gj, gt, cfg_j, cfg_t)
    same = lanes = 0
    for b in range(4):
        kb, words = _reference_words(cfg_j.seed, b, cfg_j.batch_size)
        start = bs.batch_start(b + 5, cfg_t.batch_size, dt.num_steps)
        assert start == int(j_sgd._batch_start(b + 5, cfg_j.batch_size, dj.num_steps))
        cols_a, rows_b, valid, w1 = (np.asarray(x) for x in
                                     j_sgd._sample_pairs(kb, start, dj, cfg_j, cooling))
        pairs, step_b = bs.sample_pairs(torch.as_tensor(words), start, dt, cfg_t, cooling)
        assert np.array_equal(pairs.cols_a.numpy(), cols_a)
        assert np.array_equal(pairs.valid.numpy(), valid)
        assert np.array_equal(pairs.w1.numpy(), w1.astype(np.int64))
        ref = _step_of(gt, cols_a[bs.A_LO].astype(np.int64), rows_b[:, bs.B_POS])
        got = step_b.numpy().astype(np.int64)
        assert np.abs(got - ref).max() <= 1
        eq = got == ref
        assert np.array_equal(pairs.rows_b.numpy()[eq], rows_b[eq])
        same += int(eq.sum())
        lanes += eq.size
    assert same / lanes >= 0.9999


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
def test_updates_on_reference_pairs(medium, one_d, pinned):
    gj, gt = medium
    cfg_j, cfg_t = _cfgs(gj, gt, one_d)
    dj, _ = _data(gj, gt, cfg_j, cfg_t)
    rng = np.random.default_rng(1)
    if one_d:
        x0 = gt.node_offset.astype(np.float32) + rng.normal(0, 5, gt.num_nodes).astype(np.float32)
        pin = rng.random(gt.num_nodes) < 0.3 if pinned else None
    else:
        x0 = j_init_layout(gj, "d").astype(np.float32)
        pin = np.repeat(rng.random(gt.num_nodes) < 0.3, 2) if pinned else None
    x_j, x_t = jnp.asarray(x0), torch.as_tensor(x0)
    update_j = j_sgd._update_1d if one_d else j_sgd._update_2d
    update_t = bs.update_1d if one_d else bs.update_2d
    for b in range(3):
        kb, _ = _reference_words(cfg_j.seed, b, cfg_j.batch_size)
        start = bs.batch_start(b, cfg_t.batch_size, gt.num_steps)
        eta = np.float32(37.5 / (b + 1))
        pairs = bs.Pairs(*(torch.as_tensor(np.asarray(x).astype(np.int64) if i == 3 else
                                           np.array(x))
                           for i, x in enumerate(j_sgd._sample_pairs(kb, start, dj, cfg_j,
                                                                     False))))
        x_j, m_j = update_j(x_j, kb, start, dj, cfg_j, jnp.float32(eta), False,
                            None if pin is None else jnp.asarray(pin))
        x_t, m_t = update_t(x_t, pairs, torch.tensor(eta),
                            None if pin is None else torch.as_tensor(pin))
        ref = np.asarray(x_j)
        scale = np.abs(ref).max() + 1
        assert np.abs(x_t.numpy() - ref).max() / scale <= UPDATE_TOL
        assert float(m_t) == pytest.approx(float(m_j), rel=1e-6)
        if pin is not None:
            assert np.array_equal(x_t.numpy()[pin], x0[pin])


def test_whole_batched_runs_match_reference_quality(small):
    gj, gt = small
    assert gt.num_steps < 1024
    x_j = j_sgd.path_sgd_1d(gj)
    x_t = sgd.path_sgd_1d(gt, device="cpu").numpy()
    assert sgd.LAST_RUN == dict(route="batched", iterations=100, delta_max=[])
    nt = lambda order: j_stats.sum_of_path_node_distances(gj.apply_ordering(order)).all_nt_space
    nt_j, nt_t = nt(j_order_from_x(gj, x_j)), nt(order_from_x(gt, x_t))
    assert nt_t == pytest.approx(nt_j, rel=QUALITY_RTOL)
    assert nt_t < 0.5 * j_stats.sum_of_path_node_distances(gj).all_nt_space

    c0 = j_init_layout(gj, "d")
    c_j = j_sgd.path_sgd_2d(gj, c0)
    c_t = sgd.path_sgd_2d(gt, c0, device="cpu").numpy()
    assert sgd.LAST_RUN["route"] == "batched" and sgd.LAST_RUN["iterations"] == 30
    stress = lambda c: j_stats.sum_of_path_node_distances(
        gj, (c[:, 0], c[:, 1])).all_2d_by_nucleotides
    assert np.isfinite(c_t).all()
    assert stress(c_t) == pytest.approx(stress(c_j), rel=QUALITY_RTOL)
    assert stress(c_t) < 0.5 * stress(c0)


def _pin_first_path(g):
    from odgi_tpu_torch.algorithms.path_sgd_sort import target_pin_mask

    return target_pin_mask(g, [0])


@pytest.mark.parametrize("graph", ["small", "medium"])
def test_pinning_freezes_target_nodes(request, graph):
    """As tests/test_snapshots_pinning.py: pinned nodes keep f32(x0) bit
    for bit, the others move; on a graph the strata kernels would take
    too, pinning takes the batched path."""
    gj, gt = request.getfixturevalue(graph)
    pin = _pin_first_path(gt)
    assert 0 < pin.sum() < gt.num_nodes
    x0 = gt.node_offset.astype(np.float64)
    X = sgd.path_sgd_1d(gt, sgd.derive_config_1d(gt, iter_max=5), pin_nodes=pin,
                        device="cpu").numpy()
    assert sgd.LAST_RUN["route"] == "batched"
    x0_f32 = x0.astype(np.float32).astype(np.float64)
    assert np.array_equal(X[pin], x0_f32[pin])
    assert not np.array_equal(X[~pin], x0_f32[~pin])

    c0 = j_init_layout(gj, "d")
    out = sgd.path_sgd_2d(gt, c0, sgd.derive_config_2d(gt, iter_max=3), pin_nodes=pin,
                          device="cpu").numpy()
    pin_ep = np.repeat(pin, 2)
    c0_f32 = c0.astype(np.float32).astype(np.float64)
    assert np.array_equal(out[pin_ep], c0_f32[pin_ep])
    assert not np.array_equal(out[~pin_ep], c0_f32[~pin_ep])


def test_path_sgd_order_pins_target_paths(small):
    """path_sgd_order(target_paths=) builds the reference's pin mask and
    keeps those nodes at their start."""
    from odgi_tpu.core.graph import handle_rank
    from odgi_tpu_torch.algorithms import path_sgd_sort

    gj, gt = small
    ref = np.zeros(gj.num_nodes, bool)
    for t in (0, 2):
        lo, hi = int(gj.path_offset[t]), int(gj.path_offset[t + 1])
        ref[handle_rank(gj.step_handle[lo:hi])] = True
    assert np.array_equal(path_sgd_sort.target_pin_mask(gt, [0, 2]), ref)
    order, X = path_sgd_sort.path_sgd_order(gt, return_x=True, overrides=dict(iter_max=4),
                                            target_paths=[0], device="cpu")
    pin = path_sgd_sort.target_pin_mask(gt, [0])
    assert np.array_equal(X[pin], gt.node_offset.astype(np.float32)[pin])
    assert np.array_equal(order, order_from_x(gt, X))
    assert sgd.LAST_RUN["iterations"] == 4


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_snapshot_cb_once_per_iteration(medium, one_d):
    """-u: the callback gets every iteration's host f64 coordinates, and
    the last equals the result."""
    gj, gt = medium
    seen = []
    cb = lambda it, x: seen.append((it, np.array(x)))
    if one_d:
        cfg = sgd.derive_config_1d(gt, iter_max=6)
        out = sgd.path_sgd_1d(gt, cfg, snapshot_cb=cb, device="cpu").numpy()
    else:
        cfg = sgd.derive_config_2d(gt, iter_max=4)
        out = sgd.path_sgd_2d(gt, j_init_layout(gj, "d"), cfg, snapshot_cb=cb,
                              device="cpu").numpy()
    assert sgd.LAST_RUN["route"] == "batched"
    assert [it for it, _ in seen] == list(range(cfg.iter_max))
    assert all(x.dtype == np.float64 and x.shape == out.shape for _, x in seen)
    assert np.array_equal(seen[-1][1], out)
    assert not np.array_equal(seen[0][1], seen[-1][1])


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_batched_delta_stops_at_first_iteration_under_delta(small, one_d, capsys):
    """-j on the batched path: the run stops after the first iteration
    whose max |delta| is at most delta, and it prints the reference's
    note (the graph is past the resident kernels)."""
    gj, gt = small
    derive = sgd.derive_config_1d if one_d else sgd.derive_config_2d
    run = (lambda cfg: sgd.path_sgd_1d(gt, cfg, device="cpu")) if one_d else \
        (lambda cfg: sgd.path_sgd_2d(gt, j_init_layout(gj, "d"), cfg, device="cpu"))
    full = run(derive(gt, iter_max=12, delta=1e-30))
    dm = list(sgd.LAST_RUN["delta_max"])
    assert sgd.LAST_RUN["iterations"] == 12 and len(dm) == 12
    assert sgd.DELTA_NOTE in capsys.readouterr().err
    k = 6
    delta = dm[k] * (1 + 1e-6)
    if any(v <= delta for v in dm[:k]):
        k = next(i for i, v in enumerate(dm) if v <= delta)
    stopped = run(derive(gt, iter_max=12, delta=delta))
    assert sgd.LAST_RUN["iterations"] == k + 1
    assert sgd.LAST_RUN["delta_max"] == dm[:k + 1]
    assert not torch.equal(stopped, full)
