"""The port's strata plan against odgi_tpu's, on the CPU: exact equality of
the Zipf tables, the schedule, the configs, plan_run (its step planes as
``strata_sgd.fill_slots`` writes them) and the coin hash."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odgi_tpu.core.graph import GraphBuilder
from odgi_tpu.ops import pallas_sgd as ps
from odgi_tpu.ops import sgd as j_sgd
from odgi_tpu.ops import zipf as j_zipf

from odgi_tpu_torch.convert import graph_from_arrays, graph_to_arrays
from odgi_tpu_torch.ops import sgd, strata_plan, strata_sgd, zipf


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


@pytest.mark.parametrize("space,space_max,quant,theta", [
    (50, 100, 100, 0.99), (100, 100, 100, 0.99), (6400, 100, 64, 0.99),
    (50_000, 1000, 100, 0.99), (12345, 100, 2, 0.5),
])
def test_zeta_tables(space, space_max, quant, theta):
    assert np.array_equal(j_zipf.zeta_table(space, space_max, quant, theta),
                          zipf.zeta_table(space, space_max, quant, theta))
    assert np.array_equal(j_zipf.zeta_eta_table(space, space_max, quant, theta),
                          zipf.zeta_eta_table(space, space_max, quant, theta))


@pytest.mark.parametrize("args", [(1 / 9e6, 1.0, 100, 0, 0.01),
                                  (1 / 2500.0, 1.0, 30, 0, 0.01),
                                  (1.0, 1.0, 1, 0, 0.01), (1 / 64.0, 1.0, 7, 3, 0.1)])
def test_sgd_schedule(args):
    assert np.array_equal(j_sgd.sgd_schedule(*args), sgd.sgd_schedule(*args))


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_derived_configs(graphs, dim):
    gj, gt = graphs
    jd = j_sgd.derive_config_1d if dim == "1d" else j_sgd.derive_config_2d
    td = sgd.derive_config_1d if dim == "1d" else sgd.derive_config_2d
    for kw in ({}, dict(iter_max=7, min_term_updates=999), dict(space_max=50)):
        if dim == "2d" and "space_max" in kw:
            continue
        cj, ct = jd(gj, **kw), td(gt, **kw)
        for f in dataclasses.fields(ct):
            assert getattr(cj, f.name) == getattr(ct, f.name), f.name
        assert cj.first_cooling_iteration == ct.first_cooling_iteration


PLAN_CASES = [
    ("1d", {}),
    ("1d", dict(iter_max=3, min_term_updates=3 * 1024)),
    ("2d", {}),
    ("2d", dict(iter_max=2, min_term_updates=3 * 1024)),
    # one iteration splits into several merge groups (cpi > MAX_CGS)
    ("2d", dict(iter_max=1, min_term_updates=4097 * 4096)),
]


@pytest.mark.parametrize("dim,kw", PLAN_CASES)
def test_plan_run(graphs, dim, kw):
    gj, gt = graphs
    one_d = dim == "1d"
    cj = (j_sgd.derive_config_1d if one_d else j_sgd.derive_config_2d)(gj, **kw)
    ct = (sgd.derive_config_1d if one_d else sgd.derive_config_2d)(gt, **kw)
    pj = ps.plan_run(gj, cj, one_d=one_d)
    pt = strata_plan.plan_run(gt, ct, one_d=one_d)
    for k in ("o_blk", "d_arr", "eta_arr", "eta_table"):
        assert pj[k].dtype == pt[k].dtype and np.array_equal(pj[k], pt[k]), k
    for k in ("cpi", "cgs", "groups", "total_valid", "total_slots"):
        assert pj[k] == pt[k], k
    # the planes as fill_slots writes them on the run's device (here the CPU)
    n = gt.num_nodes if one_d else 2 * gt.num_nodes
    planes, _ = strata_sgd.fill_slots(gt, pt["data"], torch.zeros((1 if one_d else 2, n),
                                                                  dtype=torch.float64))
    assert planes.dtype == torch.int32 and planes.shape[1] == pt["data"].num_slots
    assert np.array_equal(np.asarray(pj["data"].planes).reshape(planes.shape), planes.numpy())
    if kw.get("iter_max") == 1:
        assert pt["groups"] > 1


@pytest.mark.parametrize("gl", [0, 1, 7, 2146, 2147, 2148, 4096, 123_456,
                                2**31 - 1])
def test_chunk_coins_bit_equal(gl):
    ref = np.asarray(ps._pair_coins(jnp.int32(gl) * jnp.int32(1000003)))
    assert np.array_equal(ref.reshape(2, strata_plan.CHUNK),
                          strata_sgd.chunk_coins(gl).numpy())
