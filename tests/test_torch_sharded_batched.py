"""The port's multi-device batched sampler (odgi_tpu_torch/parallel/sharded.py
and ops/scatter.py) against odgi_tpu/parallel/sharded.py, on the CPU.

The reference draws its words from jax.random "rbg" keys folded by
iteration, batch and device, which the port cannot reproduce; here the
port is fed those words through its word source:
- scatter.py's scatter-add and mean merge against odgi_tpu's one-hot
  matmuls (1e-6);
- local_acc_2d / local_acc_1d lane for lane on the reference's words for
  kd = fold_in(fold_in(fold_in(key, it), b), dev): within 1e-6 of the
  accumulator's scale, counts exact;
- make_sharded_sgd_2d / _1d for 3 iterations at 4 devices, both consensus
  modes, against the reference's on a 4-device sub-mesh of the conftest's
  8 virtual CPU devices: within 1e-5 of the coordinate scale (2D at 2
  batch rounds an iteration, see the test), and 2D at all its rounds by
  stress within 5%;
- "batch" consensus equals one batch of 4 B pairs (tests/test_parallel.py's
  claim for the reference): within 1e-6 of the scale;
- two and four gloo ranks equal the simulation within 1e-6 of the scale;
- sharded_sort_order and sharded_layout on their own generators improve
  nt-distance and stress from their start.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from odgi_tpu.algorithms import stats as j_stats
from odgi_tpu.algorithms.layout import init_layout as j_init_layout
from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import scatter as j_scatter
from odgi_tpu.ops import sgd as j_sgd
from odgi_tpu.parallel import sharded as j_sharded

from odgi_tpu_torch.algorithms.layout import init_layout
from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import batched_sgd as bs
from odgi_tpu_torch.ops import scatter, sgd
from odgi_tpu_torch.parallel import sharded

ACC_TOL = 1e-6      # local accumulators, of their scale
RUN_TOL = 1e-5      # whole sharded runs against the reference, of the scale
SIM_TOL = 1e-6      # gloo ranks and one big batch against the simulation
QUALITY_RTOL = 0.05
ITERS = 3
N_DEV = 4
JOIN_S = 240


def _walk(nodes, paths, steps, seed=7):
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
    gj = b.build().apply_ordering(np.random.default_rng(5).permutation(nodes))
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.fixture(scope="module")
def graphs():
    """2,400 steps (3 paths x 800) over 80 nodes, node order shuffled."""
    return _walk(80, 3, 800)


def _cfgs(gj, gt, one_d, **kw):
    kw.setdefault("iter_max", ITERS)
    if one_d:
        return j_sgd.derive_config_1d(gj, **kw), sgd.derive_config_1d(gt, **kw)
    return j_sgd.derive_config_2d(gj, **kw), sgd.derive_config_2d(gt, **kw)


def _data(gj, gt, cfg_j, cfg_t):
    args = lambda c: (c.theta, c.space, c.space_max, c.space_quantization_step)
    return j_sgd.SgdData.build(gj, *args(cfg_j)), bs.SgdData.build(gt, *args(cfg_t),
                                                                   device="cpu")


_bits = jax.jit(lambda key, it, b, d, B: jax.random.bits(
    jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, it), b), d), (2, B),
    jnp.uint32), static_argnums=4)


def reference_words(cfg_j):
    """The reference's words for device d's batch b of iteration it, as a
    word source."""
    key = jax.random.key(cfg_j.seed, impl=cfg_j.rng_impl)
    return lambda it, b, d: torch.as_tensor(
        np.asarray(_bits(key, it, b, d, cfg_j.batch_size)).astype(np.int64))


def _etas(cfg):
    return sgd.sgd_schedule(1.0 / cfg.eta_max, 1.0, cfg.iter_max,
                            cfg.iter_with_max_learning_rate, cfg.eps).astype(np.float32)


def _start(gj, one_d):
    return (gj.node_offset.astype(np.float32) if one_d
            else j_init_layout(gj, "d").astype(np.float32))


# ---------------------------------------------------------------------------
# ops/scatter.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,C", [(100, 3), (300, 2), (20000, 1)])
def test_scatter_functions_equal_reference(M, C):
    rng = np.random.default_rng(M)
    table = rng.normal(0, 1000, (M, C)).astype(np.float32)
    idx = rng.integers(0, M, 4096).astype(np.int32)
    idx[:64] = idx[0]  # conflicts
    vals = rng.normal(0, 1, (4096, C)).astype(np.float32)
    valid = rng.random(4096) < 0.8
    t = lambda a: torch.as_tensor(a)

    # the reference's factored_gather is the port's indexing (pair_acc_*)
    ref = np.asarray(j_scatter.factored_gather(jnp.asarray(table), jnp.asarray(idx)))
    assert np.abs(t(table)[t(idx).long()].numpy() - ref).max() <= ACC_TOL * np.abs(table).max()

    got = scatter.factored_scatter_add(M, t(idx), t(vals)).numpy()
    ref = np.asarray(j_scatter.factored_scatter_add(M, jnp.asarray(idx), jnp.asarray(vals)))
    assert got.shape == ref.shape == (M, C)
    assert np.abs(got - ref).max() <= ACC_TOL * np.abs(ref).max()

    idx2 = rng.integers(0, M, 4096).astype(np.int32)
    # the reference's scatter_mean_apply is mean_apply of one accumulator
    v = np.concatenate([valid, valid]).astype(np.float32)[:, None]
    acc = scatter.factored_scatter_add(M, t(np.concatenate([idx, idx2])),
                                       t(np.concatenate([np.concatenate([-vals, vals]), v], 1)))
    got = scatter.mean_apply(t(table), acc).numpy()
    ref = np.asarray(j_scatter.scatter_mean_apply(
        jnp.asarray(table), [jnp.asarray(idx), jnp.asarray(idx2)],
        [jnp.asarray(-vals), jnp.asarray(vals)], jnp.asarray(valid)))
    assert np.abs(got - ref).max() <= ACC_TOL * np.abs(table).max()
    untouched = np.setdiff1d(np.arange(M), np.concatenate([idx, idx2]))
    assert np.array_equal(got[untouched], table[untouched])


# ---------------------------------------------------------------------------
# The local accumulators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cooling", [False, True], ids=["warm", "cooling"])
@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_local_acc_equals_reference(graphs, one_d, cooling):
    gj, gt = graphs
    cfg_j, cfg_t = _cfgs(gj, gt, one_d)
    dj, dt = _data(gj, gt, cfg_j, cfg_t)
    words = reference_words(cfg_j)
    key = jax.random.key(cfg_j.seed, impl=cfg_j.rng_impl)
    x0 = _start(gj, one_d)
    x_j, x_t = jnp.asarray(x0), torch.as_tensor(x0)
    acc_j_fn = j_sharded._local_acc_1d if one_d else j_sharded._local_acc_2d
    acc_t_fn = sharded.local_acc_1d if one_d else sharded.local_acc_2d
    nb = cfg_t.num_batches
    for it, b, dev in ((0, 0, 0), (1, 2, 3), (2, nb - 1, 1)):
        kd = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, it), b), dev)
        start = bs.batch_start((it * nb + b) * N_DEV + dev, cfg_t.batch_size, dt.num_steps)
        eta = np.float32(_etas(cfg_t)[it])
        ref = np.asarray(acc_j_fn(x_j, kd, start, dj, cfg_j, jnp.float32(eta), cooling))
        got = acc_t_fn(x_t, words(it, b, dev), start, dt, cfg_t, torch.tensor(eta),
                       cooling).numpy()
        assert got.shape == ref.shape == ((gt.num_nodes, 2) if one_d else (2 * gt.num_nodes, 3))
        assert np.array_equal(got[:, -1], ref[:, -1])  # counts
        scale = np.abs(ref[:, :-1]).max()
        assert scale > 0 and np.abs(got - ref).max() <= ACC_TOL * scale


def test_local_acc_mean_is_the_batched_update(graphs):
    """x + acc / max(count, 1) is the batched path's own update on the same
    words (tests/test_parallel.py's claim for the reference)."""
    gj, gt = graphs
    for one_d in (True, False):
        _, cfg = _cfgs(gj, gt, one_d)
        _, data = _data(gj, gt, *_cfgs(gj, gt, one_d))
        x = torch.as_tensor(_start(gj, one_d))
        w = bs.draw_words(bs.make_generator(cfg, "cpu"), cfg.batch_size, "cpu")
        eta = torch.tensor(np.float32(3.5))
        pairs, _ = bs.sample_pairs(w, 17, data, cfg, False)
        if one_d:
            acc = sharded.local_acc_1d(x, w, 17, data, cfg, eta, False)
            want, _ = bs.update_1d(x, pairs, eta)
            got = x + acc[:, 0] / torch.clamp_min(acc[:, 1], 1.0)
        else:
            acc = sharded.local_acc_2d(x, w, 17, data, cfg, eta, False)
            want, _ = bs.update_2d(x, pairs, eta)
            got = x + acc[:, :2] / torch.clamp_min(acc[:, 2:], 1.0)
        assert torch.allclose(got, want, rtol=0, atol=1e-6 * float(x.abs().max()))


# ---------------------------------------------------------------------------
# Whole sharded runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("data",))


def _runs(gj, gt, mesh4, one_d, consensus, num_batches=None, iter_max=ITERS):
    """(reference, port, start) of one sharded run at 4 devices on the
    reference's words."""
    cfg_j, cfg_t = _cfgs(gj, gt, one_d, iter_max=iter_max)
    dj, dt = _data(gj, gt, cfg_j, cfg_t)
    nb = cfg_t.num_batches if num_batches is None else num_batches
    make_j = j_sharded.make_sharded_sgd_1d if one_d else j_sharded.make_sharded_sgd_2d
    make_t = sharded.make_sharded_sgd_1d if one_d else sharded.make_sharded_sgd_2d
    x0, etas = _start(gj, one_d), _etas(cfg_t)
    fn_j = make_j(mesh4, cfg_j, nb, consensus=consensus)
    ref = np.asarray(fn_j(jnp.asarray(x0), jax.random.key(cfg_j.seed, impl=cfg_j.rng_impl),
                          jnp.asarray(etas), dj))
    fn_t = make_t(cfg_t, nb, n_dev=N_DEV, consensus=consensus)
    got = fn_t(torch.as_tensor(x0), torch.as_tensor(etas), dt, reference_words(cfg_j)).numpy()
    assert got.dtype == np.float32 and got.shape == x0.shape
    return ref, got, x0


@pytest.mark.parametrize("consensus", ["iteration", "batch"])
@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_sharded_run_equals_reference(graphs, mesh4, one_d, consensus):
    """3 iterations at 4 devices: 1D at its 6 batch rounds an iteration,
    2D at 2.  From the same state the accumulators agree exactly
    (test_local_acc_equals_reference); but at the first iterations' full
    steps (mu = 1) a 2D pair whose endpoints coincide in one run and lie an
    ulp apart in the other (XLA's and PyTorch's last bits differ) turns its
    push by up to 90 degrees, so from the third 2D round on the two runs
    part by whole units (measured: 6e-5 after 2 rounds, 25 after 3 of this
    graph's 2,500-unit layout).  The full 2D schedule is held by quality
    below."""
    gj, gt = graphs
    ref, got, x0 = _runs(gj, gt, mesh4, one_d, consensus, None if one_d else 2)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= RUN_TOL * scale
    assert np.abs(got - x0).max() > 1e3 * RUN_TOL * scale  # it moved


@pytest.mark.parametrize("consensus", ["iteration", "batch"])
def test_sharded_2d_run_matches_reference_quality(graphs, mesh4, consensus):
    """The 2D runs at the default schedule (30 iterations of 20 batch
    rounds): stress within 5% of the reference's (tests/test_torch_batched.py's
    bar for whole runs)."""
    gj, gt = graphs
    ref, got, x0 = _runs(gj, gt, mesh4, False, consensus, iter_max=30)
    stress = lambda c: j_stats.sum_of_path_node_distances(
        gj, (c[:, 0], c[:, 1])).all_2d_by_nucleotides
    assert np.isfinite(got).all()
    assert stress(got) == pytest.approx(stress(ref), rel=QUALITY_RTOL)
    assert stress(got) < 0.5 * stress(x0)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_batch_consensus_equals_one_big_batch(graphs, one_d):
    """One iteration of one batch round at 4 devices in "batch" consensus
    equals one merge over the union of the 4 local batches."""
    gj, gt = graphs
    _, cfg = _cfgs(gj, gt, one_d, iter_max=1)
    _, data = _data(gj, gt, *_cfgs(gj, gt, one_d, iter_max=1))
    x0, etas = torch.as_tensor(_start(gj, one_d)), torch.as_tensor(_etas(cfg))
    gens = [torch.Generator().manual_seed(100 + d) for d in range(N_DEV)]
    words = [bs.draw_words(gen, cfg.batch_size, "cpu") for gen in gens]
    make = sharded.make_sharded_sgd_1d if one_d else sharded.make_sharded_sgd_2d
    got = make(cfg, 1, n_dev=N_DEV, consensus="batch")(x0, etas, data,
                                                        lambda it, b, d: words[d])
    acc_fn = sharded.local_acc_1d if one_d else sharded.local_acc_2d
    cooling = 0 > cfg.first_cooling_iteration if one_d else 0 >= cfg.first_cooling_iteration
    acc = sum(acc_fn(x0, words[d], bs.batch_start(d, cfg.batch_size, data.num_steps), data,
                     cfg, etas[0], cooling) for d in range(N_DEV))
    mean = acc[:, :-1] / torch.clamp_min(acc[:, -1:], 1.0)
    want = x0 + mean.reshape(x0.shape)
    assert int(acc[:, -1].sum()) > 2 * cfg.batch_size  # more pairs than one device's
    assert float((got - want).abs().max()) <= SIM_TOL * float(want.abs().max())


def test_seeds_and_determinism(graphs):
    """Device d's generator is seeded by device_seed(seed, d); a run is
    deterministic, and more devices give another result."""
    gj, gt = graphs
    assert sharded.device_seed(9399220, 0) == 9399220
    assert sharded.device_seed(9399220, 3) == (9399220 + 3 * 0x9E3779B9) & 0x7FFFFFFF
    _, cfg = _cfgs(gj, gt, False, iter_max=2)
    x0 = _start(gj, False)
    a = sharded.sharded_positions(gt, x0, cfg, False, n_dev=2, device="cpu")
    b = sharded.sharded_positions(gt, x0, cfg, False, n_dev=2, device="cpu")
    c = sharded.sharded_positions(gt, x0, cfg, False, n_dev=3, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def sims(graphs):
    """(one_d, consensus, ranks) -> the simulation's f32 result."""
    _, gt = graphs
    out = {}
    for one_d in (True, False):
        cfg = (sgd.derive_config_1d if one_d else sgd.derive_config_2d)(gt, iter_max=2)
        x0 = gt.node_offset if one_d else init_layout(gt, "d")
        for consensus in ("iteration", "batch"):
            for ranks in (2, 4):
                out[one_d, consensus, ranks] = (cfg, sharded.sharded_positions(
                    gt, x0, cfg, one_d, n_dev=ranks, consensus=consensus,
                    device="cpu").numpy())
    return out


def _spawn_ranks(ranks, args, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=sharded.run_rank,
                         args=(r, ranks, init, "gloo", *args, str(tmp_path / f"rank{r}.npy")))
             for r in range(ranks)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0] * ranks
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [np.load(tmp_path / f"rank{r}.npy") for r in range(ranks)]


@pytest.mark.parametrize("ranks,one_d,consensus", [
    (2, False, "iteration"), (4, True, "iteration"), (4, False, "batch"), (2, True, "batch"),
])
def test_gloo_ranks_equal_simulation(graphs, sims, tmp_path, monkeypatch, ranks, one_d,
                                     consensus):
    """Gloo ranks, each a spawned process running run_rank, give the
    simulation's result on every rank within rounding."""
    _, gt = graphs
    cfg, sim = sims[one_d, consensus, ranks]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    outs = _spawn_ranks(ranks, (gt, cfg, one_d, consensus), tmp_path)
    for r, out in enumerate(outs):
        assert out.dtype == np.float32 and out.shape == sim.shape
        assert np.abs(out - sim).max() <= SIM_TOL * np.abs(sim).max(), r
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


def test_entry_points_improve_quality(graphs):
    gj, gt = graphs
    nt = lambda g: j_stats.sum_of_path_node_distances(g).all_nt_space
    order = sharded.sharded_sort_order(gt, sgd.derive_config_1d(gt, iter_max=20), n_dev=N_DEV,
                                       device="cpu")
    assert sorted(order.tolist()) == list(range(gt.num_nodes))
    assert nt(gj.apply_ordering(order)) < 0.5 * nt(gj)

    c0 = j_init_layout(gj, "d")
    stress = lambda c: j_stats.sum_of_path_node_distances(
        gj, (c[:, 0], c[:, 1])).all_2d_by_nucleotides
    c = sharded.sharded_layout(gt, sgd.derive_config_2d(gt, iter_max=10), n_dev=N_DEV,
                               device="cpu")
    assert c.dtype == np.float64 and c.shape == c0.shape and np.isfinite(c).all()
    assert stress(c) < 0.5 * stress(c0)


def test_no_fallback(graphs):
    """No card: the entry points raise unless device="cpu"; a bad n_dev or
    consensus raises."""
    _, gt = graphs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.sharded_layout(gt)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.sharded_sort_order(gt)
    cfg = sgd.derive_config_2d(gt, iter_max=1)
    with pytest.raises(ValueError, match="n_dev"):
        sharded.sharded_layout(gt, cfg, n_dev=0, device="cpu")
    with pytest.raises(ValueError, match="consensus"):
        sharded.make_sharded_sgd_2d(cfg, 1, consensus="step")
