"""The CUDA kernels of odgi_tpu_torch against their plain PyTorch versions,
on the card (marker `cuda`; skipped where there is none).

Run on a machine with an NVIDIA card:  python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the chunk kernels are compiled with -fmad=false and IEEE sqrt
and division, so they round as the plain versions do; max |drift delta|
over the scale <= 1e-6 (bit-equality expected).  The merge sums are f64 in
ascending slot order, while the plain version's CUDA index_add_ adds in no
fixed order: <= 1e-12 of the scale.
"""

import numpy as np
import pytest
import torch

from odgi_tpu_torch.algorithms.layout import init_layout
from odgi_tpu_torch.core.graph import GraphBuilder
from odgi_tpu_torch.ops import kernels, sgd, strata_sgd

pytestmark = pytest.mark.cuda

CHUNK_TOL = 1e-6
MERGE_TOL = 1e-12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
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
    return b.build()


def _state(graph, one_d, device):
    kw = dict(iter_max=2, min_term_updates=3 * 1024)
    if one_d:
        return strata_sgd.StrataState.build(
            graph, sgd.derive_config_1d(graph, **kw),
            graph.node_offset.astype(np.float32), True, device)
    return strata_sgd.StrataState.build(
        graph, sgd.derive_config_2d(graph, **kw), init_layout(graph), False, device)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_kernels_match_plain(cuda, graph, one_d):
    st = _state(graph, one_d, cuda)
    p = st.plan
    chunks = kernels.strata_chunks_1d if one_d else kernels.strata_chunks_2d
    plain = strata_sgd.chunks_1d_plain if one_d else strata_sgd.chunks_2d_plain
    before = dict(kernels.LAUNCHES)
    for gid in range(p["groups"]):
        args = (st.base, st.planes, st.od, st.eta, p["cpi"], gid * p["cgs"], p["cgs"])
        scale = float(st.base.abs().max()) + 1
        d_k, d_p = st.drift.clone(), st.drift.clone()
        chunks(d_k, *args)
        plain(d_p, *args)
        torch.cuda.synchronize()
        assert float((d_k - d_p).abs().max()) / scale <= CHUNK_TOL
        assert float(d_k.abs().max()) > 0

        c_k, u_k, c_p, u_p = (t.clone() for t in (st.coords, st.upd, st.coords, st.upd))
        kernels.strata_merge_sum(d_k, st.mi, c_k, u_k)
        strata_sgd.merge_sum_plain(d_k, st.mi, c_p, u_p)
        cscale = float(c_p.abs().max()) + 1
        assert float((c_k - c_p).abs().max()) / cscale <= MERGE_TOL
        assert float((u_k - u_p).abs().max()) / cscale <= MERGE_TOL

        b_k, b_p = st.base.clone(), st.base.clone()
        dk2, dp2 = d_k.clone(), d_k.clone()
        kernels.strata_merge_bcast(dk2, b_k, st.mi, u_k)
        strata_sgd.merge_bcast_plain(dp2, b_p, st.mi, u_k)
        assert float((b_k - b_p).abs().max()) / scale <= MERGE_TOL
        assert not dk2.any()
        st.drift, st.base, st.coords, st.upd = dk2, b_k, c_k, u_k
    names = ["strata_chunks_1d" if one_d else "strata_chunks_2d",
             "strata_merge_sum", "strata_merge_bcast"]
    for n in names:
        assert kernels.LAUNCHES[n] - before[n] == p["groups"]


def test_strata_runs_match_cpu(cuda, graph):
    """The whole 2D and 1D runs on the card against the CPU plain runs."""
    c0 = init_layout(graph)
    cfg2 = sgd.derive_config_2d(graph, iter_max=3, min_term_updates=3 * 1024)
    on_card = sgd.path_sgd_2d(graph, c0, cfg2, device="cuda").cpu().numpy()
    on_cpu = sgd.path_sgd_2d(graph, c0, cfg2, device="cpu").numpy()
    assert np.abs(on_card - on_cpu).max() / (np.abs(on_cpu).max() + 1) <= CHUNK_TOL
    cfg1 = sgd.derive_config_1d(graph, iter_max=3, min_term_updates=3 * 1024)
    on_card = sgd.path_sgd_1d(graph, cfg1, device="cuda").cpu().numpy()
    on_cpu = sgd.path_sgd_1d(graph, cfg1, device="cpu").numpy()
    assert np.abs(on_card - on_cpu).max() / (np.abs(on_cpu).max() + 1) <= CHUNK_TOL


def test_wrapper_rejects_bad_arguments(cuda, graph):
    st = _state(graph, False, cuda)
    p = st.plan
    with pytest.raises(ValueError):
        kernels.strata_chunks_2d(st.drift, st.base, st.planes, st.od, st.eta,
                                 p["cpi"], 0, st.od.shape[0] + 1)
    with pytest.raises(ValueError):
        kernels.strata_chunks_2d(st.drift.double(), st.base, st.planes, st.od, st.eta,
                                 p["cpi"], 0, p["cgs"])
