"""The CUDA kernels of odgi_tpu_torch against their plain PyTorch versions,
on the card (marker `cuda`; skipped where there is none).

Run on a machine with an NVIDIA card:  python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the chunk kernels are compiled with -fmad=false and IEEE sqrt
and division, so they round as the plain versions do; max |drift delta|
over the scale <= 1e-6 (bit-equality expected).  The merge sums are f64 in
ascending slot order, while the plain version's CUDA index_add_ adds in no
fixed order: <= 1e-12 of the scale.  The XL and XXL routes give the
resident route's coordinates exactly, the blocked sum of the XXL route
equals the CSR sum exactly, and the broadcast, which every route runs,
equals its plain version exactly.  The leveled 2D and 1D chunk kernels (a
thread-block cluster a chunk, each chunk after its predecessors: the main
path's chunk phase on every route) equal the chain kernels, their
reference, exactly, group by group and over whole runs; strata_merge_sum
equals the ascending-order loop merge_sum_ordered_plain exactly at every
block size, and the blocked sum equals it too, at every node-block size.
The sharded run at two simulated devices on the card lies within 1e-9 of
the same run on the CPU, and a one-rank NCCL group equals the one-device
simulation exactly.  The leveled kernels' tracking instances (delta early
stop) give the untracked drift exactly and the plain versions' Delta_max
exactly, and tracked runs on the card stop where the CPU's stop; a batched
step on the card lies within 1e-6 of the scale of the same words' step on
the CPU (index_add_ adds by atomics there), and so do the multi-device
sampler's accumulators, a round of its "batch" consensus, and a one-rank
NCCL run of it against its one-device simulation.  The command line on the
card (build -> sort -p Ygs -> layout -> stats) writes the Python API's
bytes, every other sort code, the graph walks of stats and paths give the
CPU's bytes there, and the stats functions that do their array work on the caller's device
give the CPU's answer on the card: integers exact, floats within 1e-12
relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from odgi_tpu_torch.algorithms.layout import init_layout
from odgi_tpu_torch.core.graph import GraphBuilder
from odgi_tpu_torch.ops import kernels, sgd, strata_levels, strata_sgd, strata_xxl

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


def _walk_graph(nodes, paths, steps, jump, seed, shuffle=False):
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
            n = int(np.clip(n + rng.integers(-jump, jump + 1), 1, nodes))
    g = b.build()
    return g.apply_ordering(np.random.default_rng(5).permutation(nodes)) if shuffle else g


@pytest.fixture(scope="module")
def long_graph():
    """3 paths x 12,000 steps over 120 nodes: room for chunks whose windows
    lie far apart."""
    return _walk_graph(120, 3, 12_000, 2, 7)


@pytest.fixture(scope="module")
def wide_graph():
    """2000 nodes, 3 paths x 1800 steps (tests/test_pallas_sgd_xxl.py), ids
    shuffled: multi-block XXL merges at small block sizes."""
    return _walk_graph(2000, 3, 1800, 40, 23, shuffle=True)


def _state(graph, one_d, device, route="resident"):
    kw = dict(iter_max=2, min_term_updates=3 * 1024)
    if one_d:
        return strata_sgd.StrataState.build(
            graph, sgd.derive_config_1d(graph, **kw),
            graph.node_offset.astype(np.float32), True, device, route)
    return strata_sgd.StrataState.build(
        graph, sgd.derive_config_2d(graph, **kw), init_layout(graph), False, device, route)


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


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("bs", [256, 1024, strata_xxl.XXL_BS])
def test_blocked_merges_equal_csr_merges(cuda, wide_graph, one_d, bs, monkeypatch):
    monkeypatch.setattr(strata_xxl, "XXL_BS", bs)
    st = _state(wide_graph, one_d, cuda, "xxl")
    assert st.bsch.bs == bs
    gen = torch.Generator(device=cuda).manual_seed(5)
    S = st.bsch.num_steps
    st.drift[:, :S] = torch.randn(st.drift[:, :S].shape, generator=gen, device=cuda)
    c_b, u_b, c_k, u_k = (t.clone() for t in (st.coords, st.upd, st.coords, st.upd))
    kernels.strata_merge_sum_blocked(st.drift, st.mi, st.bsch, c_b, u_b)
    kernels.strata_merge_sum(st.drift, st.mi, c_k, u_k)
    c_p, u_p = st.coords.clone(), st.upd.clone()
    strata_sgd.merge_sum_blocked_plain(st.drift, st.mi, st.bsch, c_p, u_p)
    torch.cuda.synchronize()
    assert torch.equal(c_b, c_k) and torch.equal(u_b, u_k)
    cscale = float(c_p.abs().max()) + 1
    assert float((u_b - u_p).abs().max()) / cscale <= MERGE_TOL

    d_k, b_k, d_p, b_p = (t.clone() for t in (st.drift, st.base, st.drift, st.base))
    kernels.strata_merge_bcast(d_k, b_k, st.mi, u_k)
    strata_sgd.merge_bcast_plain(d_p, b_p, st.mi, u_k)
    torch.cuda.synchronize()
    assert torch.equal(b_k, b_p) and not d_k.any()


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_routes_equal_on_card(cuda, wide_graph, one_d, monkeypatch):
    """The whole run on each route: the XL and XXL kernels give the
    resident kernels' coordinates, bit for bit, and the CPU's within the
    chunk tolerance."""
    monkeypatch.setattr(strata_xxl, "XXL_BS", 1024)
    kw = dict(iter_max=3, min_term_updates=3 * 1024)
    if one_d:
        cfg = sgd.derive_config_1d(wide_graph, **kw)
        run = lambda route, dev: strata_sgd.path_sgd_1d_strata(
            wide_graph, cfg, None, dev, route).cpu().numpy()
    else:
        cfg = sgd.derive_config_2d(wide_graph, **kw)
        c0 = init_layout(wide_graph)
        run = lambda route, dev: strata_sgd.path_sgd_2d_strata(
            wide_graph, c0, cfg, dev, route).cpu().numpy()
    before = dict(kernels.LAUNCHES)
    res = run("resident", cuda)
    for route in ("xl", "xxl"):
        np.testing.assert_array_equal(run(route, cuda), res)
    on_cpu = run("resident", "cpu")
    assert np.abs(res - on_cpu).max() / (np.abs(on_cpu).max() + 1) <= CHUNK_TOL
    for n in ("strata_chunks_1d_levels" if one_d else "strata_chunks_2d_levels",
              "strata_merge_sum_blocked", "strata_merge_bcast"):
        assert kernels.LAUNCHES[n] > before[n]
    for n in ("strata_chunks_1d", "strata_chunks_2d"):
        assert kernels.LAUNCHES[n] == before[n]


def test_new_wrappers_reject_bad_arguments(cuda, wide_graph):
    st = _state(wide_graph, False, cuda, "xxl")
    bs = st.bsch
    for bad in (dataclasses.replace(bs, tile=bs.tile.cpu()),
                dataclasses.replace(bs, tile=bs.tile.long()),
                dataclasses.replace(bs, block=bs.block[:-1]),
                dataclasses.replace(bs, bs=bs.bs + 1)):
        with pytest.raises(ValueError):
            kernels.strata_merge_sum_blocked(st.drift, st.mi, bad, st.coords, st.upd)
    with pytest.raises(ValueError):
        kernels.strata_merge_sum_blocked(st.drift.double(), st.mi, bs, st.coords, st.upd)
    with pytest.raises(ValueError):
        kernels.strata_merge_bcast(st.drift, st.base[:1].contiguous(), st.mi, st.upd)


def _level_state(graph, device, route):
    """A 2D state with a few hundred chunks a group, so that levels hold
    several chunks each."""
    cfg = sgd.derive_config_2d(graph, iter_max=2, min_term_updates=256 * 4096)
    return strata_sgd.StrataState.build(graph, cfg, init_layout(graph), False, device, route)


@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
def test_leveled_chunks_equal_chain_groups(cuda, long_graph, route):
    st = _level_state(long_graph, cuda, route)
    p = st.plan
    depth = strata_levels.depths(strata_levels.chunk_levels(p)[1])
    assert depth.max() < p["cgs"]  # levels of more than one chunk
    before = dict(kernels.LAUNCHES)
    for gid in range(p["groups"]):
        tail = (st.eta, p["cpi"], gid * p["cgs"], p["cgs"])
        d_l, d_c = st.drift.clone(), st.drift.clone()
        kernels.strata_chunks_2d_levels(d_l, st.base, st.planes, st.od, st.eta, p["cpi"],
                                        st.perm, st.lvl_rows[gid], st.pred_off, st.pred)
        kernels.strata_chunks_2d(d_c, st.base, st.planes, st.od, *tail)
        torch.cuda.synchronize()
        assert torch.equal(d_l, d_c)
        assert float(d_c.abs().max()) > 0
        st.drift = d_l
        kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)
    for name in ("strata_chunks_2d_levels", "strata_chunks_2d"):
        assert kernels.LAUNCHES[name] - before[name] == p["groups"]


@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
def test_leveled_runs_equal_chain_runs(cuda, long_graph, route, monkeypatch):
    """Whole 2D runs: the leveled kernel against the same run with the
    chunk phase forced onto the chain kernel, bit for bit."""
    cfg = sgd.derive_config_2d(long_graph, iter_max=3, min_term_updates=128 * 4096)
    c0 = init_layout(long_graph)
    run = lambda: strata_sgd.path_sgd_2d_strata(long_graph, c0, cfg, cuda, route).cpu().numpy()
    leveled = run()

    def chain(drift, base, planes, od, eta, cpi, perm, lvl_off, pred_off, pred):
        # the group's chunks are the range perm[lvl_off[0]:lvl_off[-1]] covers
        g0, g1 = int(lvl_off[0]), int(lvl_off[-1])
        kernels.strata_chunks_2d(drift, base, planes, od, eta, cpi, g0, g1 - g0)

    monkeypatch.setattr(kernels, "strata_chunks_2d_levels", chain)
    np.testing.assert_array_equal(run(), leveled)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("block_eps", [2, 16, 256])
def test_merge_sum_blocks_equal_ordered_and_blocked(cuda, wide_graph, one_d, block_eps):
    st = _state(wide_graph, one_d, cuda, "xxl")
    gen = torch.Generator(device=cuda).manual_seed(11)
    S = st.bsch.num_steps
    st.drift[:, :S] = torch.randn(st.drift[:, :S].shape, generator=gen, device=cuda) * 50
    mi = dataclasses.replace(st.mi, block_eps=block_eps)
    c_k, u_k, c_o, u_o, c_b, u_b = (t.clone() for t in (st.coords, st.upd) * 3)
    kernels.strata_merge_sum(st.drift, mi, c_k, u_k)
    strata_sgd.merge_sum_ordered_plain(st.drift, mi, c_o, u_o)
    kernels.strata_merge_sum_blocked(st.drift, mi, st.bsch, c_b, u_b)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_o) and torch.equal(u_k, u_o)
    assert torch.equal(c_k, c_b) and torch.equal(u_k, u_b)
    assert float(u_k.abs().max()) > 0


def test_levels_wrapper_rejects_bad_arguments(cuda, long_graph):
    st = _level_state(long_graph, cuda, "resident")
    p = st.plan
    row = st.lvl_rows[0]
    args = (st.drift, st.base, st.planes, st.od, st.eta, p["cpi"])
    preds = (st.pred_off, st.pred)
    for bad_perm in (st.perm.cpu(), st.perm.long(), st.perm[:-1], st.perm[::2]):
        with pytest.raises(ValueError):
            kernels.strata_chunks_2d_levels(*args, bad_perm, row, *preds)
    for bad_off in (row.cpu(), row.long(), row[:1], row[None, :].expand(2, -1)):
        with pytest.raises(ValueError):
            kernels.strata_chunks_2d_levels(*args, st.perm, bad_off, *preds)
    for bad_preds in ((st.pred_off[:-1], st.pred), (st.pred_off.long(), st.pred),
                      (st.pred_off, st.pred.cpu()), (st.pred_off, st.pred[None, :]),
                      (st.pred_off[::2], st.pred)):
        with pytest.raises(ValueError):
            kernels.strata_chunks_2d_levels(*args, st.perm, row, *bad_preds)
    with pytest.raises(ValueError):
        kernels.strata_chunks_2d_levels(st.drift, st.base, st.planes, st.od, st.eta[:1],
                                        p["cpi"] // 2, st.perm, row, *preds)
    with pytest.raises(ValueError):
        kernels.strata_merge_sum(st.drift, dataclasses.replace(st.mi, block_eps=3), st.coords,
                                 st.upd)
    for bad in (1, 512):  # 2D pairs e, e^1 in one block; at most 256 endpoints
        with pytest.raises(ValueError):
            kernels.strata_merge_sum(st.drift, dataclasses.replace(st.mi, block_eps=bad),
                                     st.coords, st.upd)


def _level_state_1d(graph, device, route):
    """A 1D state with a few hundred chunks a group."""
    cfg = sgd.derive_config_1d(graph, iter_max=2, min_term_updates=256 * 4096)
    return strata_sgd.StrataState.build(graph, cfg, graph.node_offset.astype(np.float32),
                                        True, device, route)


@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
def test_leveled_1d_chunks_equal_chain_groups(cuda, long_graph, route):
    st = _level_state_1d(long_graph, cuda, route)
    p = st.plan
    depth = strata_levels.depths(strata_levels.chunk_levels(p)[1])
    assert depth.max() < p["cgs"]  # levels of more than one chunk
    before = dict(kernels.LAUNCHES)
    for gid in range(p["groups"]):
        tail = (st.eta, p["cpi"], gid * p["cgs"], p["cgs"])
        d_l, d_c = st.drift.clone(), st.drift.clone()
        kernels.strata_chunks_1d_levels(d_l, st.base, st.planes, st.od, st.eta, p["cpi"],
                                        st.perm, st.lvl_rows[gid], st.pred_off, st.pred)
        kernels.strata_chunks_1d(d_c, st.base, st.planes, st.od, *tail)
        torch.cuda.synchronize()
        assert torch.equal(d_l, d_c)
        assert float(d_c.abs().max()) > 0
        st.drift = d_l
        if route == "xxl":
            kernels.strata_merge_sum_blocked(st.drift, st.mi, st.bsch, st.coords, st.upd)
        else:
            kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)
    for name in ("strata_chunks_1d_levels", "strata_chunks_1d"):
        assert kernels.LAUNCHES[name] - before[name] == p["groups"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for one_d in (True, False):  # the leveled kernels' clusters fill the card
        clusters, blocks = kernels.levels_clusters(one_d)
        assert clusters >= 1 and clusters * blocks >= sms


@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
def test_leveled_1d_runs_equal_chain_runs(cuda, long_graph, route, monkeypatch):
    """Whole 1D runs: the leveled kernel against the same run with the
    chunk phase forced onto the chain kernel, bit for bit."""
    cfg = sgd.derive_config_1d(long_graph, iter_max=3, min_term_updates=128 * 4096)
    run = lambda: strata_sgd.path_sgd_1d_strata(long_graph, cfg, None, cuda,
                                                route).cpu().numpy()
    leveled = run()

    def chain(drift, base, planes, od, eta, cpi, perm, lvl_off, pred_off, pred):
        g0, g1 = int(lvl_off[0]), int(lvl_off[-1])
        kernels.strata_chunks_1d(drift, base, planes, od, eta, cpi, g0, g1 - g0)

    monkeypatch.setattr(kernels, "strata_chunks_1d_levels", chain)
    np.testing.assert_array_equal(run(), leveled)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_blocked_sum_in_pieces(cuda, long_graph, one_d):
    """Deep coverage, 36,000 steps over 120 nodes: a thread block's CSR
    span takes a dozen or more pieces, bit-equal all the same to
    strata_merge_sum and the ascending loop."""
    st = _state(long_graph, one_d, cuda, "xxl")
    assert int(st.mi.csr_off[-1]) >= 36_000 and st.bsch.num_blocks == 1
    gen = torch.Generator(device=cuda).manual_seed(19)
    S = st.bsch.num_steps
    st.drift[:, :S] = torch.randn(st.drift[:, :S].shape, generator=gen, device=cuda)
    c_k, u_k, c_o, u_o = (t.clone() for t in (st.coords, st.upd) * 2)
    kernels.strata_merge_sum(st.drift, st.mi, c_k, u_k)
    strata_sgd.merge_sum_ordered_plain(st.drift, st.mi, c_o, u_o)
    assert torch.equal(c_k, c_o) and torch.equal(u_k, u_o)
    c_b, u_b = st.coords.clone(), st.upd.clone()
    kernels.strata_merge_sum_blocked(st.drift, st.mi, st.bsch, c_b, u_b)
    torch.cuda.synchronize()
    assert torch.equal(c_b, c_k) and torch.equal(u_b, u_k)


def test_levels_1d_wrapper_rejects_bad_arguments(cuda, long_graph):
    st = _level_state_1d(long_graph, cuda, "resident")
    p = st.plan
    row = st.lvl_rows[0]
    args = (st.drift, st.base, st.planes, st.od, st.eta, p["cpi"])
    preds = (st.pred_off, st.pred)
    for bad_perm in (st.perm.cpu(), st.perm.long(), st.perm[:-1]):
        with pytest.raises(ValueError):
            kernels.strata_chunks_1d_levels(*args, bad_perm, row, *preds)
    for bad_off in (row.cpu(), row[:1]):
        with pytest.raises(ValueError):
            kernels.strata_chunks_1d_levels(*args, st.perm, bad_off, *preds)
    with pytest.raises(ValueError):
        kernels.strata_chunks_1d_levels(*args, st.perm, row, st.pred_off[1:], st.pred)
    st2 = _level_state(long_graph, cuda, "resident")  # 2D planes
    with pytest.raises(ValueError):
        kernels.strata_chunks_1d_levels(st2.drift, st2.base, st2.planes, st2.od, st2.eta,
                                        st2.plan["cpi"], st2.perm, st2.lvl_rows[0],
                                        st2.pred_off, st2.pred)
    with pytest.raises(ValueError):
        kernels.strata_chunks_2d_levels(*args, st.perm, row, *preds)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_refused_levels_launch_raises(cuda, long_graph, one_d, monkeypatch):
    """A launch the runtime refuses (here: an error code from the C
    entry, as a refused cluster launch returns one) raises, counted; no
    plain version runs in its place."""
    st = (_level_state_1d if one_d else _level_state)(long_graph, cuda, "resident")
    name = "strata_chunks_1d_levels" if one_d else "strata_chunks_2d_levels"
    plain = "chunks_1d_levels_plain" if one_d else "chunks_2d_levels_plain"
    monkeypatch.setattr(kernels, "_fn", lambda n: lambda *a: 801)  # cudaErrorNotSupported
    monkeypatch.setattr(strata_sgd, plain, lambda *a, **kw: pytest.fail("plain version ran"))
    before = kernels.LAUNCHES[name]
    drift = st.drift.clone()
    with pytest.raises(RuntimeError, match="CUDA error 801"):
        getattr(kernels, name)(drift, st.base, st.planes, st.od, st.eta, st.plan["cpi"],
                               st.perm, st.lvl_rows[0], st.pred_off, st.pred)
    assert kernels.LAUNCHES[name] == before + 1 and not drift.any()


def test_blocked_sum_rejects_bad_arguments(cuda, wide_graph):
    st = _state(wide_graph, True, cuda, "xxl")
    bs = st.bsch
    for bad in (dataclasses.replace(bs, bs=bs.bs // 2),  # the blocks miss endpoints
                dataclasses.replace(bs, bs=bs.bs - 1)):
        with pytest.raises(ValueError):
            kernels.strata_merge_sum_blocked(st.drift, st.mi, bad, st.coords, st.upd)
    with pytest.raises(ValueError):
        kernels.strata_merge_sum_blocked(st.drift[:, :-1], st.mi, bs, st.coords, st.upd)


SHARDED_TOL = 1e-9


def test_sharded_card_matches_cpu(cuda, graph):
    """Two simulated devices on the card against the same run on the CPU:
    <= 1e-9 of the scale (the CUDA merge sum folds each endpoint's slots in
    ascending order, the CPU plain sum through index_add_); every group of
    the stacked plan goes through the resident kernels once."""
    from odgi_tpu_torch.parallel import sharded_strata

    c0 = init_layout(graph)
    cfg = sgd.derive_config_2d(graph, iter_max=3, min_term_updates=3 * 1024)
    before = dict(kernels.LAUNCHES)
    on_card = sharded_strata.path_sgd_2d_strata_sharded(graph, c0, cfg, n_dev=2,
                                                        device="cuda").cpu().numpy()
    groups = sharded_strata.stacked_plan(graph, cfg, 2)["groups"]
    for n in ("strata_chunks_2d_levels", "strata_merge_sum", "strata_merge_bcast"):
        assert kernels.LAUNCHES[n] - before[n] == groups
    on_cpu = sharded_strata.path_sgd_2d_strata_sharded(graph, c0, cfg, n_dev=2,
                                                       device="cpu").numpy()
    assert np.isfinite(on_card).all()
    assert np.abs(on_card - on_cpu).max() / (np.abs(on_cpu).max() + 1) <= SHARDED_TOL


def test_sharded_one_rank_nccl_equals_simulation(cuda, graph):
    """A one-rank NCCL group gives the one-device simulation's coordinates
    bit for bit."""
    import datetime
    import socket

    from odgi_tpu_torch.parallel import sharded_strata

    c0 = init_layout(graph)
    cfg = sgd.derive_config_2d(graph, iter_max=3, min_term_updates=3 * 1024)
    sim = sharded_strata.path_sgd_2d_strata_sharded(graph, c0, cfg, n_dev=1, device="cuda")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                         world_size=1, rank=0,
                                         timeout=datetime.timedelta(seconds=120))
    try:
        with pytest.raises(ValueError):
            sharded_strata.path_sgd_2d_strata_sharded(graph, c0, cfg, n_dev=2, device="cuda")
        nccl = sharded_strata.path_sgd_2d_strata_sharded(graph, c0, cfg, device="cuda")
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(nccl, sim)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("route", ["resident", "xl", "xxl"])
def test_bcast_equals_plain(cuda, wide_graph, route, one_d):
    """The one-pass broadcast on each route's state, with a random update
    table (zero past the real endpoints, as the sums leave it) and nonzero
    drift: base bit-equal to merge_bcast_plain's, drift zero, pad slots'
    base unchanged."""
    st = _state(wide_graph, one_d, cuda, route)
    E, S = st.mi.recip.shape[0], wide_graph.num_steps
    rng = np.random.default_rng(13)
    upd = np.zeros(tuple(st.upd.shape))
    upd[:, :E] = rng.normal(size=(upd.shape[0], E)) * 10.0
    st.upd.copy_(torch.from_numpy(upd))
    st.drift.fill_(1.0)
    d_k, b_k, d_p, b_p = (t.clone() for t in (st.drift, st.base, st.drift, st.base))
    before = kernels.LAUNCHES["strata_merge_bcast"]
    kernels.strata_merge_bcast(d_k, b_k, st.mi, st.upd)
    strata_sgd.merge_bcast_plain(d_p, b_p, st.mi, st.upd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["strata_merge_bcast"] == before + 1
    assert torch.equal(b_k, b_p) and not d_k.any()
    assert torch.equal(b_k[:, S:], st.base[:, S:])
    assert not torch.equal(b_k[:, :S], st.base[:, :S])


def test_bcast_rejects_misaligned_upd(cuda, wide_graph):
    """2D gathers an endpoint's forward and reverse update as one 16-byte
    pair, so an update table whose row 1 starts off a 16-byte boundary (an
    odd ecap, or a table 8 bytes into its storage) is refused, as are
    planes whose L is not a multiple of 4."""
    st = _state(wide_graph, False, cuda)
    E = st.mi.recip.shape[0]
    odd = dataclasses.replace(st.mi, ecap=E + 3)
    with pytest.raises(ValueError):
        kernels.strata_merge_bcast(st.drift, st.base, odd,
                                   torch.zeros((2, E + 3), dtype=torch.float64, device=cuda))
    shifted = torch.zeros(2 * st.mi.ecap + 1, dtype=torch.float64, device=cuda)[1:]
    with pytest.raises(ValueError):
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, shifted.view(2, st.mi.ecap))
    L = st.drift.shape[1]
    short = dataclasses.replace(st.mi, ep=st.mi.ep[:L - 2].contiguous())
    with pytest.raises(ValueError):
        kernels.strata_merge_bcast(st.drift[:, :L - 2].contiguous(),
                                   st.base[:, :L - 2].contiguous(), short, st.upd)
    before = kernels.LAUNCHES["strata_merge_bcast"]
    kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)  # the aligned table runs
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["strata_merge_bcast"] == before + 1


# ---------------------------------------------------------------------------
# Delta early stop: the tracking instances of the leveled kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("route", ["resident", "xxl"])
def test_tracked_levels_equal_untracked_and_plain(cuda, long_graph, one_d, route):
    """Group by group: the tracking instance's drift equals the untracked
    kernel's bit for bit, its Delta_max word equals the plain version's
    bit for bit, and it is counted apart."""
    st = _state(long_graph, one_d, cuda, route)
    p = st.plan
    name = "strata_chunks_1d_levels" if one_d else "strata_chunks_2d_levels"
    levels = getattr(kernels, name)
    plain = strata_sgd.chunks_1d_levels_plain if one_d else strata_sgd.chunks_2d_levels_plain
    before = dict(kernels.LAUNCHES)
    for gid in range(p["groups"]):
        args = (st.base, st.planes, st.od, st.eta, p["cpi"], st.perm, st.lvl_rows[gid])
        d_u, d_t, d_p = st.drift.clone(), st.drift.clone(), st.drift.clone()
        levels(d_u, *args, st.pred_off, st.pred)
        levels(d_t, *args, st.pred_off, st.pred, dmax=st.dmax[gid:gid + 1])
        w = torch.zeros(1, device=cuda)
        plain(d_p, *args, dmax=w)
        torch.cuda.synchronize()
        assert torch.equal(d_t, d_u)
        scale = float(st.base.abs().max()) + 1
        assert float((d_t - d_p).abs().max()) / scale <= CHUNK_TOL
        assert torch.equal(st.dmax[gid:gid + 1], w) and float(w) > 0
        st.drift = d_t
        kernels.strata_merge_sum(st.drift, st.mi, st.coords, st.upd)
        kernels.strata_merge_bcast(st.drift, st.base, st.mi, st.upd)
    assert kernels.LAUNCHES[name] - before[name] == p["groups"]
    assert kernels.LAUNCHES[kernels.TRACKED[name]] - before[kernels.TRACKED[name]] == p["groups"]


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_delta_runs_on_card_equal_cpu(cuda, long_graph, one_d):
    """A 1e-30 delta equals the untracked run bit for bit on the card; an
    interior delta stops at the iteration the CPU stops at, with the same
    Delta_max values and coordinates within CHUNK_TOL."""
    import dataclasses

    kw = dict(iter_max=6, min_term_updates=16 * 1024)
    if one_d:
        cfg = sgd.derive_config_1d(long_graph, **kw)
        run = lambda c, dev: sgd.path_sgd_1d(long_graph, c, device=dev).cpu().numpy()
    else:
        cfg = sgd.derive_config_2d(long_graph, **kw)
        c0 = init_layout(long_graph)
        run = lambda c, dev: sgd.path_sgd_2d(long_graph, c0, c, device=dev).cpu().numpy()
    name = "strata_chunks_1d_levels" if one_d else "strata_chunks_2d_levels"
    before = dict(kernels.LAUNCHES)
    plain = run(cfg, cuda)
    assert kernels.LAUNCHES[kernels.TRACKED[name]] == before[kernels.TRACKED[name]]
    tiny = run(dataclasses.replace(cfg, delta=1e-30), cuda)
    dm = list(sgd.LAST_RUN["delta_max"])
    assert sgd.LAST_RUN["route"] == "resident" and len(dm) == cfg.iter_max
    assert np.array_equal(tiny, plain)
    k = next(i for i in range(1, cfg.iter_max - 1)
             if all(dm[i] <= (1 - 1e-3) * v for v in dm[:i]))
    stop = dataclasses.replace(cfg, delta=dm[k] * (1 + 2e-4))
    on_card = run(stop, cuda)
    assert sgd.LAST_RUN["iterations"] == k + 1 and sgd.LAST_RUN["delta_max"] == dm[:k + 1]
    on_cpu = run(stop, "cpu")
    assert sgd.LAST_RUN["delta_max"] == dm[:k + 1]
    assert np.abs(on_card - on_cpu).max() / (np.abs(on_cpu).max() + 1) <= CHUNK_TOL


def test_tracked_wrapper_rejects_bad_dmax(cuda, long_graph):
    st = _state(long_graph, False, cuda)
    args = (st.drift.clone(), st.base, st.planes, st.od, st.eta, st.plan["cpi"], st.perm,
            st.lvl_rows[0], st.pred_off, st.pred)
    for bad in (st.dmax, st.dmax[:1].double(), torch.zeros(1)):
        with pytest.raises(ValueError):
            kernels.strata_chunks_2d_levels(*args, dmax=bad)


# ---------------------------------------------------------------------------
# The batched path on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_batched_step_on_card_matches_cpu(cuda, graph, one_d):
    """One batch from the same words on the card and on the CPU: the same
    pairs, and updates within 1e-6 of the scale (index_add_ adds by
    atomics on the card)."""
    from odgi_tpu_torch.ops import batched_sgd as bs

    cfg = sgd.derive_config_1d(graph) if one_d else sgd.derive_config_2d(graph)
    words = bs.draw_words(bs.make_generator(cfg, "cpu"), cfg.batch_size, "cpu")
    x0 = (graph.node_offset.astype(np.float32) if one_d
          else init_layout(graph).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        data = bs.SgdData.build(graph, cfg.theta, cfg.space, cfg.space_max,
                                cfg.space_quantization_step, device=dev)
        pairs, step_b = bs.sample_pairs(words.to(dev), 17, data, cfg, False)
        update = bs.update_1d if one_d else bs.update_2d
        x, m = update(torch.as_tensor(x0, device=dev), pairs, torch.tensor(np.float32(40.0),
                                                                           device=dev))
        out[str(dev)] = (step_b.cpu(), x.cpu().numpy(), float(m))
    (s_c, x_c, m_c), (s_k, x_k, m_k) = out["cpu"], out[str(cuda)]
    assert torch.equal(s_c, s_k)
    assert np.abs(x_k - x_c).max() / (np.abs(x_c).max() + 1) <= 1e-6
    assert m_k == m_c


def test_batched_pinned_run_on_card(cuda, graph):
    """A pinned 1D run on the card: the pinned positions stay f32(x0) bit
    for bit, the others move, and the order improves on the start."""
    from odgi_tpu_torch.algorithms import path_sgd_sort
    from odgi_tpu_torch.algorithms.stats import sum_of_path_node_distances

    g = graph.apply_ordering(np.random.default_rng(5).permutation(graph.num_nodes))
    pin = path_sgd_sort.target_pin_mask(g, [0])
    order, X = path_sgd_sort.path_sgd_order(g, return_x=True, target_paths=[0],
                                            device="cuda")
    assert sgd.LAST_RUN["route"] == "batched"
    x0 = g.node_offset.astype(np.float32).astype(np.float64)
    assert np.array_equal(X[pin], x0[pin]) and not np.array_equal(X[~pin], x0[~pin])
    nt = lambda h: sum_of_path_node_distances(h, device="cpu").all_nt_space
    assert nt(g.apply_ordering(order)) < nt(g)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
def test_sampler_on_card_matches_cpu(cuda, graph, one_d):
    """The multi-device sampler on the card: one device's local accumulator
    against the CPU's on the same words, and one round of "batch"
    consensus at 4 devices against the same round on the CPU, each within
    1e-6 of the scale (index_add_ adds by atomics on the card)."""
    from odgi_tpu_torch.ops import batched_sgd as bs
    from odgi_tpu_torch.parallel import sharded

    cfg = (sgd.derive_config_1d if one_d else sgd.derive_config_2d)(graph, iter_max=1,
                                                                    batch_size=512)
    words = [bs.draw_words(torch.Generator().manual_seed(d), cfg.batch_size, "cpu")
             for d in range(4)]
    x0 = (graph.node_offset if one_d else init_layout(graph)).astype(np.float32)
    eta = np.float32(25.0)
    acc_fn = sharded.local_acc_1d if one_d else sharded.local_acc_2d
    make = sharded.make_sharded_sgd_1d if one_d else sharded.make_sharded_sgd_2d
    out = {}
    for dev in ("cpu", cuda):
        data = bs.SgdData.build(graph, cfg.theta, cfg.space, cfg.space_max,
                                cfg.space_quantization_step, device=dev)
        x = torch.as_tensor(x0, device=dev)
        acc = acc_fn(x, words[1].to(dev), 33, data, cfg, torch.tensor(eta, device=dev), False)
        run = make(cfg, 1, n_dev=4, consensus="batch")(
            x, torch.tensor([eta], device=dev), data, lambda it, b, d: words[d])
        out[str(dev)] = (acc.cpu(), run.cpu())
    (a_c, r_c), (a_k, r_k) = out["cpu"], out[str(cuda)]
    assert torch.equal(a_k[:, -1], a_c[:, -1])
    assert float((a_k - a_c).abs().max()) <= 1e-6 * float(a_c[:, :-1].abs().max())
    assert float((r_k - r_c).abs().max()) <= 1e-6 * float(r_c.abs().max())


def test_sampler_one_rank_nccl_matches_simulation(cuda, graph):
    """One device simulated and the same run in a one-rank NCCL group
    (two rounds of one iteration, 2D) within 1e-6 of the scale; the
    4-device layout on the card at most 5% above the single-device batched
    layout's stress (this graph's init is near its optimum, so both end
    above their start at 10 iterations)."""
    import datetime
    import socket

    import torch.distributed as dist

    from odgi_tpu_torch.algorithms.stats import sum_of_path_node_distances
    from odgi_tpu_torch.ops import batched_sgd as bs
    from odgi_tpu_torch.parallel import sharded

    cfg = sgd.derive_config_2d(graph, iter_max=1)
    x0 = init_layout(graph)
    run = lambda: sharded.sharded_positions(graph, x0, cfg, False, device=cuda, num_batches=2)
    sim = run()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        nccl = run()
    finally:
        dist.destroy_process_group()
    assert float((nccl - sim).abs().max()) <= 1e-6 * float(sim.abs().max())
    cfg10 = sgd.derive_config_2d(graph, iter_max=10)
    c = sharded.sharded_layout(graph, cfg10, n_dev=4)
    one = bs.path_sgd_2d_batched(graph, x0, cfg10, device=cuda)["x"].cpu().numpy()
    stress = lambda xy: sum_of_path_node_distances(
        graph, (xy[:, 0], xy[:, 1]), device="cpu").all_2d_by_nucleotides
    assert np.isfinite(c).all() and stress(c) <= 1.05 * stress(one)


def test_cli_sort_codes_and_paths_on_card_equal_cpu(cuda, graph, tmp_path):
    """Every sort code in one chain, stats --is-acyclic / --count-walks /
    --shortest-cycle and paths -L -l -H through the command line on the
    card (device None) give the CPU's bytes and printouts."""
    import contextlib
    import io

    from odgi_tpu_torch.cli.main import main
    from odgi_tpu_torch.io import og

    d = str(tmp_path)
    og.save_graph(graph.apply_ordering(np.random.default_rng(3).permutation(graph.num_nodes)),
                  f"{d}/g.otg")

    def cli(argv, device):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv, device=device) == 0
        return out.getvalue()

    for dev, tag in ((None, "card"), ("cpu", "cpu")):
        cli(["sort", "-i", f"{d}/g.otg", "-o", f"{d}/{tag}.og", "-p", "nfrbzwcdel"], dev)
    with open(f"{d}/card.og", "rb") as a, open(f"{d}/cpu.og", "rb") as b:
        assert a.read() == b.read()
    for argv in (["stats", "-i", f"{d}/g.otg", "--is-acyclic", "--count-walks",
                  "--shortest-cycle"], ["paths", "-i", f"{d}/g.otg", "-L", "-l", "-H"]):
        assert cli(argv, None) == cli(argv, "cpu")


def test_cli_chain_on_card_equals_api(cuda, graph, tmp_path):
    """build -> sort -p Ygs -> layout -> stats through the command line on
    the card (device None) write what the Python API writes on the card,
    byte for byte, and stats prints the API's nt-distance and stress."""
    import contextlib
    import io

    from odgi_tpu_torch.algorithms.layout import layout_graph
    from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline
    from odgi_tpu_torch.algorithms.stats import sum_of_path_node_distances
    from odgi_tpu_torch.cli.main import main
    from odgi_tpu_torch.io import gfa, lay, og_compat

    d = str(tmp_path)
    gfa.write_gfa(graph, f"{d}/g.gfa")

    def cli(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(list(argv)) == 0
        return out.getvalue()

    cli("build", "-g", f"{d}/g.gfa", "-o", f"{d}/g.og")
    assert gfa.LAST_PARSER["name"] == "native"
    cli("sort", "-i", f"{d}/g.og", "-o", f"{d}/s.og", "-p", "Ygs")
    cli("layout", "-i", f"{d}/s.og", "-o", f"{d}/s.lay")
    nt = cli("stats", "-i", f"{d}/s.og", "-s").splitlines()[-1].split("\t")[2]
    stress = cli("stats", "-i", f"{d}/s.og", "-s", "-c", f"{d}/s.lay").splitlines()[-1]
    g2 = sort_pipeline(gfa.parse_gfa(f"{d}/g.gfa"), "Ygs")
    og_compat.save_og(g2, f"{d}/api.og")
    coords = layout_graph(og_compat.load_og(f"{d}/s.og"))
    lay.save_layout(coords, f"{d}/api.lay")
    for a, b in (("s.og", "api.og"), ("s.lay", "api.lay")):
        with open(f"{d}/{a}", "rb") as fa, open(f"{d}/{b}", "rb") as fb:
            assert fa.read() == fb.read(), a
    assert nt == f"{sum_of_path_node_distances(g2).all_nt_space:.6g}"
    xy = lay.load_layout(f"{d}/s.lay")
    want = sum_of_path_node_distances(g2, (xy[:, 0], xy[:, 1])).all_2d_by_nucleotides
    assert stress.split("\t")[2] == f"{want:.6g}"


@pytest.fixture(scope="module")
def stats_graph():
    """Random walks over 400 nodes with mixed orientations, an edge for
    every step pair, a self-loop and a reversing self-edge, PanSN path
    names, shuffled out of id order (tests/test_torch_stats.py's walks)."""
    rng = np.random.default_rng(5)
    b = GraphBuilder()
    for i in range(1, 401):
        b.add_node(i, bytes(rng.choice(list(b"ACGTacgtN"), size=int(rng.integers(1, 5)))))
    for pi in range(6):
        p = b.add_path(f"sample{pi % 3}#{pi}#chr{pi % 2}")
        n, prev = int(rng.integers(1, 401)), None
        for _ in range(2000):
            rev = bool(rng.integers(0, 4) == 0)
            if prev is not None:
                b.add_edge(prev[0], prev[1], n, rev)
            b.append_step(p, n, rev)
            prev = (n, rev)
            n = int(np.clip(n + rng.integers(-2, 4), 1, 400))
    b.add_edge(3, False, 3, False)
    b.add_edge(5, False, 5, True)
    return b.build().apply_ordering(rng.permutation(400), compact_ids=False)


def _same_value(a, b):
    """Integers and strings exact, floats within MERGE_TOL relative."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same_value(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_value(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y)
    elif isinstance(a, np.ndarray) and a.dtype.kind in "iub":
        assert b.dtype.kind in "iub" and np.array_equal(a, b)
    elif isinstance(a, (np.ndarray, float, np.floating)):
        np.testing.assert_allclose(b, a, rtol=MERGE_TOL, atol=0)
    else:
        assert type(a) is type(b) and a == b, (a, b)


_XY = np.random.default_rng(11).normal(0, 50, (2, 800))
STATS_ON_DEVICE = {
    "base_content": lambda s, g, d: s.base_content(g, device=d),
    "links_1d": lambda s, g, d: s.mean_links_length(g, device=d),
    "links_1d_no_gap": lambda s, g, d: s.mean_links_length(g, penalize_gap_links=False,
                                                           device=d),
    "links_2d": lambda s, g, d: s.mean_links_length(g, xy=tuple(_XY), device=d),
    "distances_1d": lambda s, g, d: s.sum_of_path_node_distances(g, device=d),
    "distances_2d_orient": lambda s, g, d: s.sum_of_path_node_distances(
        g, xy=tuple(_XY), penalize_diff_orientation=True, device=d),
    "feedback_arcs": lambda s, g, d: s.weighted_feedback_arcs(g, device=d),
    "reversing_joins": lambda s, g, d: s.weighted_reversing_joins(g, device=d),
    "links_per_nuc": lambda s, g, d: s.links_length_per_nuc(g, device=d),
    "classes_sample": lambda s, g, d: s.pangenome_class_counts(g, "#", 0, device=d),
    "classes_chrom": lambda s, g, d: s.pangenome_class_counts(g, "#", 2, device=d),
    "self_loops": lambda s, g, d: s.unique_self_loop_nodes(g, device=d),
}


@pytest.mark.parametrize("case", list(STATS_ON_DEVICE))
def test_stats_on_card_equal_cpu(cuda, stats_graph, case):
    """Every stats function that does its array work on the caller's
    device (the CLI's stats flags on the card) gives the CPU's answer:
    integers exact, floats within MERGE_TOL relative."""
    from odgi_tpu_torch.algorithms import stats

    fn = STATS_ON_DEVICE[case]
    _same_value(fn(stats, stats_graph, "cpu"), fn(stats, stats_graph, cuda))


@pytest.fixture(scope="module")
def chip_graphs():
    """chip_smoke.py's XL graph (5,000,000 steps over 10,000 nodes: the xl
    route in both dimensions) and 1M-node graph (10,000,000 steps: the xxl
    route), ids shuffled."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs

    return {"xl": cs.shuffled_graph(cs.XL_STEPS, cs.XL_NODES, cs.XL_PATH_STEPS),
            "1m": cs.shuffled_graph(cs.BIG_STEPS, cs.BIG_NODES, cs.BIG_PATH_STEPS)}


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("name", ["xl", "1m"])
def test_slots_filled_on_card_equal_cpu(cuda, chip_graphs, name, one_d):
    """On the XL and 1M-node graphs, each on its own route: the planes and
    base that StrataState.build fills on the card equal the CPU build's and
    the host forms (tests/slot_forms.py) bit for bit, and a whole run from
    them gives the coordinates of the same run from the host forms, bit
    for bit."""
    from odgi_tpu_torch.ops import strata_route
    from slot_forms import slot_arrays_numpy

    g = chip_graphs[name]
    if one_d:
        cfg, init = sgd.derive_config_1d(g), g.node_offset.astype(np.float32)
    else:
        cfg, init = sgd.derive_config_2d(g), init_layout(g)
    route = strata_route.graph_route(g, cfg, one_d)
    assert route == {"xl": "xl", "1m": "xxl"}[name]
    st = strata_sgd.StrataState.build(g, cfg, init, one_d, cuda, route)
    on_cpu = strata_sgd.StrataState.build(g, cfg, init, one_d, torch.device("cpu"), route)
    assert torch.equal(st.planes.cpu(), on_cpu.planes)
    assert torch.equal(st.base.cpu().view(torch.int32), on_cpu.base.view(torch.int32))
    del on_cpu
    g_run, init_run = g, init
    if route == "xxl":
        g_run, order = strata_xxl.relabel(g)
        init_run = strata_xxl.relabel_coords(np.asarray(init), order)
    planes, base = slot_arrays_numpy(g_run, st.plan["data"].num_slots, init_run, one_d)
    assert np.array_equal(st.planes.cpu().numpy(), planes)
    assert np.array_equal(st.base.cpu().numpy().view(np.int32), base.view(np.int32))
    host = dataclasses.replace(
        st, planes=torch.from_numpy(planes).to(cuda), base=torch.from_numpy(base).to(cuda),
        drift=torch.zeros_like(st.drift), coords=st.coords.clone(),
        upd=torch.zeros_like(st.upd), dmax=torch.zeros_like(st.dmax))
    start = st.coords.clone()
    st.run()
    host.run()
    assert torch.equal(st.coords, host.coords)
    assert not torch.equal(st.coords, start)
