"""The consensus broadcast's state on every route, as its CUDA kernel
(`strata_merge_bcast`, csrc/strata_sgd.cu) assumes it.

The kernel takes four slots a thread with 16-byte accesses (an int4 of
endpoints, a float4 of each base and drift plane) and, in 2D, gathers an
endpoint's forward and reverse update as one aligned double2 of the update
table.  It runs on the resident, xl and xxl routes alike, pad slots
included: those hold the dummy endpoint, whose update no sum writes, so
their base stays as it was and their drift is reset.  These CPU tests
check that state after one merge group (the plain versions run on the
CPU); the kernel itself is held bit-equal against `merge_bcast_plain` on
the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from odgi_tpu_torch.algorithms.layout import init_layout
from odgi_tpu_torch.core.graph import GraphBuilder
from odgi_tpu_torch.ops import sgd, strata_sgd

ROUTES = ("resident", "xl", "xxl")


@pytest.fixture(scope="module")
def graph():
    """400 nodes, 3 paths x 1500 steps with jumps across the id range, ids
    shuffled (the xxl route relabels them)."""
    rng = np.random.default_rng(31)
    b = GraphBuilder()
    n_nodes = 400
    for i in range(1, n_nodes + 1):
        b.add_node(i, b"ACGT" * int(rng.integers(1, 4)))
    for i in range(1, n_nodes):
        b.add_edge(i, False, i + 1, False)
    for pi in range(3):
        p = b.add_path(f"p{pi}")
        n = 1
        for _ in range(1500):
            b.append_step(p, n, bool(rng.integers(0, 2)))
            n = int(np.clip(n + rng.integers(-12, 13), 1, n_nodes))
    return b.build().apply_ordering(np.random.default_rng(5).permutation(n_nodes))


def _state(g, one_d: bool, route: str):
    kw = dict(iter_max=2, min_term_updates=3 * 1024)
    if one_d:
        return strata_sgd.StrataState.build(g, sgd.derive_config_1d(g, **kw),
                                            g.node_offset.astype(np.float32), True,
                                            torch.device("cpu"), route)
    return strata_sgd.StrataState.build(g, sgd.derive_config_2d(g, **kw), init_layout(g),
                                        False, torch.device("cpu"), route)


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("route", ROUTES)
def test_pad_slots_take_no_update(graph, route, one_d):
    st = _state(graph, one_d, route)
    S, L = graph.num_steps, st.drift.shape[1]
    E = st.mi.recip.shape[0]
    assert S < L  # the planes have pad slots
    base0 = st.base.clone()
    st.run_group(0)
    pad_ep = st.mi.ep[S:]
    assert (pad_ep == E).all()
    if not one_d:
        assert ((pad_ep ^ 1) == E + 1).all() and st.mi.ecap == E + 2
    assert not st.upd[:, E:].any()
    assert torch.equal(st.base[:, S:], base0[:, S:])
    assert not st.drift.any()
    assert not torch.equal(st.base[:, :S], base0[:, :S])  # the real slots took the update


@pytest.mark.parametrize("one_d", [True, False], ids=["1d", "2d"])
@pytest.mark.parametrize("route", ROUTES)
def test_bcast_layout_preconditions(graph, route, one_d):
    st = _state(graph, one_d, route)
    L = st.drift.shape[1]
    nc, planes = (1, 1) if one_d else (2, 4)
    E = st.mi.recip.shape[0]
    assert L % 4 == 0
    if one_d:
        assert st.mi.ecap == E + 1
    else:
        assert st.mi.ecap % 2 == 0  # row 1 of upd starts 16-byte aligned
    for name, t, dtype, shape in (("ep", st.mi.ep, torch.int32, (L,)),
                                  ("base", st.base, torch.float32, (planes, L)),
                                  ("drift", st.drift, torch.float32, (planes, L)),
                                  ("upd", st.upd, torch.float64, (nc, st.mi.ecap))):
        assert t.dtype == dtype and tuple(t.shape) == shape, name
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
