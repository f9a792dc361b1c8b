"""Which strata kernels a graph runs on: ``"resident"``, ``"xl"`` or
``"xxl"`` (``"batched"`` where the reference leaves the strata scheme).

The counterpart of the JAX package's dispatch (``odgi_tpu/ops/sgd.py``
``path_sgd_1d`` / ``path_sgd_2d``) and of its predicates, less their
backend test: ``_supported`` (``ops/pallas_sgd.py``), ``xl_supported`` /
``xl_supported_1d`` (``ops/pallas_sgd_xl.py``) and ``xxl_supported`` /
``xxl_supported_1d`` (``ops/pallas_sgd_xxl.py``).  The port runs the Hopper
counterpart of the kernel the JAX package would run on its TPU, so the
decision keeps the TPU's constants below.  They describe the TPU v5e
(its VMEM budget and its merge tiling), not the H100.
"""

from __future__ import annotations

from .strata_plan import CHUNK, LANE, RC, TR, _pad_to

# TPU constants of the decision (odgi_tpu/ops/pallas_sgd.py): the VMEM
# budget for the resident planes, and the one-hot merge's cap on the
# node-array width in LANE-wide rows.
VMEM_BUDGET = 110 * 1024 * 1024
MAX_NODE_ROWS = 256
# Below this many steps, or at positions of 2^30 and more, the reference
# takes its batched path.
MIN_STRATA_STEPS = 1024
MAX_STRATA_POS = 2**30

ROUTES = ("resident", "xl", "xxl")


def node_rows(num_nodes: int, one_d: bool) -> int:
    """The TPU merge's node-array width ``nl`` (rows of LANE endpoints,
    padded to 8) for N nodes plus the dummy endpoint(s)."""
    idx_count = (num_nodes + 1) if one_d else (2 * num_nodes + 2)
    return _pad_to(max(-(-idx_count // LANE), 1), 8)


def resident_vmem_bytes(num_steps: int, space: int, one_d: bool) -> int:
    """The resident kernel's VMEM need: the static planes, cp0, drift and
    base over the padded slot count."""
    pad = _pad_to(num_steps + CHUNK + space + 4 * RC * LANE, TR * LANE)
    np_planes, ncp = (3, 1) if one_d else (4, 4)
    return (np_planes + 3 * ncp) * pad * 4


def strata_route(num_steps: int, num_nodes: int, max_pos: int, space: int,
                 one_d: bool) -> str:
    """The route of a run with `num_steps` steps over `num_nodes` nodes,
    largest path position `max_pos` (last step position plus the longest
    node) and Zipf `space`."""
    if num_steps < MIN_STRATA_STEPS or max_pos >= MAX_STRATA_POS:
        return "batched"
    if node_rows(num_nodes, one_d) > MAX_NODE_ROWS:
        return "xxl"
    if resident_vmem_bytes(num_steps, space, one_d) < VMEM_BUDGET:
        return "resident"
    return "xl"


def graph_route(g, cfg, one_d: bool) -> str:
    """`strata_route` of graph `g` under config `cfg`."""
    max_pos = int(g.step_pos.max(initial=0)) + int(g.node_len.max(initial=0))
    return strata_route(g.num_steps, g.num_nodes, max_pos, int(cfg.space), one_d)
