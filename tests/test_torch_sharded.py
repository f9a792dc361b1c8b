"""The port's multi-device 2D PG-SGD (odgi_tpu_torch/parallel/sharded_strata.py)
against odgi_tpu's path_sgd_2d_pallas_sharded, on the CPU.

The graph and config are tests/test_parallel.py's: _tiny_graph_steps(5200)
(__graft_entry__.py), iter_max=2, min_term_updates=2*2048.  Tolerances:
- the device streams equal _per_device_od exactly;
- the 4-device port run (plain versions) against the reference's simulation
  (interpret-mode Pallas): 1e-4 of the scale, the bar the JAX suite holds
  its own kernel to against its twin (tests/test_pallas_sgd.py).  The
  reference keeps the consensus in f32, the port in f64;
- one device against the port's single-device resident run: 1e-4 of the
  scale (tests/test_parallel.py's bar: the base planes are rebuilt from the
  consensus every iteration, rounding otherwise than the broadcast does);
- four gloo ranks against the 4-device simulation: bit for bit (the same
  streams, the same fold in rank order).
"""

import multiprocessing
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import sgd as j_sgd
from odgi_tpu.parallel import sharded_pallas

from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import sgd, strata_levels, strata_plan, strata_sgd
from odgi_tpu_torch.parallel import sharded_strata

TOL = 1e-4
KW = dict(iter_max=2, min_term_updates=2 * 2048)
JOIN_S = 240  # each rank's join; a hung rank fails the test


@pytest.fixture(scope="module")
def graphs():
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    from __graft_entry__ import _tiny_graph_steps

    gj = _tiny_graph_steps(5200)
    return gj, graph_from_arrays(graph_to_arrays(gj))


@pytest.fixture(scope="module")
def c0(graphs):
    """Random start (tests/test_parallel.py): a 2-iteration run must move."""
    gj, _ = graphs
    return np.random.default_rng(0).normal(0, 100, (2 * gj.num_nodes, 2)).astype(np.float64)


@pytest.fixture(scope="module")
def sim4(graphs, c0):
    _, gt = graphs
    return sharded_strata.path_sgd_2d_strata_sharded(
        gt, c0, sgd.derive_config_2d(gt, **KW), n_dev=4, device="cpu").numpy()


def _rel_err(a, ref):
    return np.abs(a - ref).max() / (np.abs(ref).max() + 1)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_streams_equal_per_device_od(graphs, n_dev):
    gj, gt = graphs
    cfg_j, cfg_t = j_sgd.derive_config_2d(gj, **KW), sgd.derive_config_2d(gt, **KW)
    pj = ps.plan_run(gj, cfg_j, one_d=False)
    ref = sharded_pallas._per_device_od(gj, cfg_j, pj, n_dev)
    pt = strata_plan.plan_run(gt, cfg_t, one_d=False)
    got = sharded_strata.per_device_streams(gt, cfg_t, pt, n_dev)
    cgs = pj["kcgs"]
    assert got.shape == (n_dev, 2, pt["groups"] * pt["cgs"]) and got.dtype == np.int32
    assert (pt["groups"], pt["cgs"]) == (pj["kgroups"], cgs)
    for d in range(n_dev):
        for row in (0, 1):
            assert np.array_equal(got[d, row], ref[d, :, row, :cgs].reshape(-1)), (d, row)
    if n_dev > 1:
        assert not np.array_equal(got[0], got[1])


def test_stacked_plan_levels_every_device(graphs):
    """The stacked plan: n_dev x the groups, cgs and cpi unchanged, the eta
    table tiled, and its conflict levels those of each device's own groups
    with the chunk indices offset by the device's base."""
    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, **KW)
    p = strata_plan.plan_run(gt, cfg, one_d=False)
    sp = sharded_strata.stacked_plan(gt, cfg, 4)
    assert (sp["groups"], sp["cgs"], sp["cpi"]) == (4 * p["groups"], p["cgs"], p["cpi"])
    total = p["groups"] * p["cgs"]
    assert len(sp["o_blk"]) == 4 * total
    gl = np.arange(4 * total)
    assert np.array_equal(sp["eta_table"][gl // sp["cpi"]], np.tile(p["eta_arr"], 4))
    assert "total_valid" not in sp
    perm, lvl_off = strata_levels.chunk_levels(sp)
    streams = sharded_strata.per_device_streams(gt, cfg, p, 4)
    for d in range(4):
        own = dict(p, o_blk=streams[d, 0], d_arr=streams[d, 1])
        perm_d, off_d = strata_levels.chunk_levels(own)
        rows = slice(d * p["groups"], (d + 1) * p["groups"])
        assert np.array_equal(perm[d * total:(d + 1) * total], perm_d + d * total)
        w = off_d.shape[1]
        assert np.array_equal(lvl_off[rows, :w], off_d + d * total)
        assert (lvl_off[rows, w:] == lvl_off[rows, w - 1:w]).all()


def test_four_devices_match_reference(graphs, c0, sim4):
    gj, _ = graphs
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    ref = sharded_pallas.path_sgd_2d_pallas_sharded(
        gj, c0, j_sgd.derive_config_2d(gj, **KW), mesh=mesh4)
    assert sim4.shape == ref.shape and sim4.dtype == np.float64
    assert _rel_err(sim4, ref) <= TOL


def test_deterministic_and_more_devices_differ(graphs, c0, sim4):
    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, **KW)
    again = sharded_strata.path_sgd_2d_strata_sharded(gt, c0, cfg, n_dev=4, device="cpu")
    assert np.array_equal(again.numpy(), sim4)
    assert np.isfinite(sim4).all()
    assert np.abs(sim4 - c0).max() > 1.0  # it optimized
    one = sharded_strata.path_sgd_2d_strata_sharded(gt, c0, cfg, n_dev=1, device="cpu")
    assert not np.array_equal(one.numpy(), sim4)


def test_one_device_matches_single_run(graphs, c0):
    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, **KW)
    one = sharded_strata.path_sgd_2d_strata_sharded(gt, c0, cfg, device="cpu").numpy()
    single = strata_sgd.path_sgd_2d_strata(gt, c0, cfg, "cpu", route="resident").numpy()
    assert _rel_err(one, single) <= TOL
    assert not np.array_equal(one, c0)


def test_gloo_ranks_equal_simulation(graphs, c0, sim4, tmp_path, monkeypatch):
    """Four gloo ranks, each a spawned process running the port's worker,
    give the 4-device simulation's coordinates bit for bit."""
    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, **KW)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=sharded_strata.run_rank,
                         args=(r, 4, init, "gloo", gt, c0, cfg, str(tmp_path / f"rank{r}.npy")))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0] * 4
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for r in range(4):
        assert np.array_equal(np.load(tmp_path / f"rank{r}.npy"), sim4), r


def test_no_fallback(graphs, c0):
    """No card: the entry point raises unless device="cpu"; NCCL ranks past
    the GPU count, or a backend that does not serve the device, raise."""
    _, gt = graphs
    cfg = sgd.derive_config_2d(gt, **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_strata.path_sgd_2d_strata_sharded(gt, c0, cfg, n_dev=2)
    gpus = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="need a GPU each"):
        sharded_strata.check_world(gpus + 1, "nccl", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="needs the gloo backend"):
        sharded_strata.check_world(1, "nccl", torch.device("cpu"))
    with pytest.raises(RuntimeError, match="needs the nccl backend"):
        sharded_strata.check_world(1, "gloo", torch.device("cuda"))
    sharded_strata.check_world(4, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError):
        sharded_strata.path_sgd_2d_strata_sharded(gt, c0, cfg, n_dev=0, device="cpu")


def test_pathless_graph_returns_start():
    from odgi_tpu_torch.core.graph import GraphBuilder

    b = GraphBuilder()
    for i in range(1, 4):
        b.add_node(i, b"A")
    b.add_path("p")
    g = b.build()
    start = np.arange(12, dtype=np.float64).reshape(6, 2)
    out = sharded_strata.path_sgd_2d_strata_sharded(g, start, n_dev=3, device="cpu")
    assert out.dtype == torch.float64 and np.array_equal(out.numpy(), start)


@pytest.mark.parametrize("n_dev,local", [(4, 0), (4, 1_499_999), (8, 1_999_999)])
def test_device_coins_past_wraparound(n_dev, local):
    """Global chunk indices of the last device of a 4M-chunk run: the key
    gl * 1000003 wraps in int32 (past gl = 2147), as the reference's."""
    gl = (n_dev - 1) * 2_000_000 + local
    ref = np.asarray(ps._pair_coins(jnp.int32(gl) * jnp.int32(1000003)))
    assert np.array_equal(ref.reshape(2, strata_plan.CHUNK), strata_sgd.chunk_coins(gl).numpy())

