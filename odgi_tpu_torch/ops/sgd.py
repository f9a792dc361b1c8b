"""Path-guided SGD (1D sort + 2D layout): schedule, configs and dispatch.

The counterpart of ``odgi_tpu/ops/sgd.py``.  The learning-rate schedule
and the derived configs are exact copies, so a config built here equals
the JAX package's field for field (less the fields that only steer XLA and
the TPU's MXU).  ``path_sgd_1d`` and ``path_sgd_2d`` route a run as the
reference does: the strata scheme of ``ops/strata_sgd.py`` on the route
``ops/strata_route.py`` picks (resident, XL or XXL kernels), or the
batched path of ``ops/batched_sgd.py`` for small graphs, pinning,
snapshots and delta early stop past the resident route.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.graph import GraphTensors
from ..device import resolve_device
from ..utils.metrics import count


def sgd_schedule(
    w_min: float,
    w_max: float,
    iter_max: int,
    iter_with_max_learning_rate: int,
    eps: float,
) -> np.ndarray:
    """path_linear_sgd_schedule: per-iteration learning rates (f64)."""
    eta_max = 1.0 / w_min
    eta_min = eps / w_max
    lam = math.log(eta_max / eta_min) / (iter_max - 1) if iter_max > 1 else 0.0
    t = np.arange(iter_max + 1, dtype=np.float64)
    etas = eta_max * np.exp(-lam * np.abs(t - iter_with_max_learning_rate))
    return np.where(np.isfinite(etas), etas, eta_min)


@dataclass(frozen=True)
class SgdConfig:
    """PG-SGD parameters (defaults follow `odgi sort` / `odgi layout`)."""

    iter_max: int
    min_term_updates: int
    eta_max: float
    eps: float = 0.01
    delta: float = 0.0
    iter_with_max_learning_rate: int = 0
    theta: float = 0.99
    space: int = 1
    space_max: int = 100
    space_quantization_step: int = 100
    cooling_start: float = 0.5
    batch_size: int = 32768
    seed: int = 9399220

    @property
    def first_cooling_iteration(self) -> int:
        return int(math.floor(self.cooling_start * self.iter_max))

    @property
    def num_batches(self) -> int:
        """Batches an iteration of the batched path."""
        return max(1, -(-self.min_term_updates // self.batch_size))


def _clamp_batch(batch_size: int, num_steps: int, epoch_div: int = 4) -> int:
    """The batched path's batch: at most the step count (the permuted
    table's walk wraps once) and at most S / epoch_div, so that an epoch
    spans several coordinate snapshots (1D takes epoch_div 4, 2D 2)."""
    if num_steps <= 0:
        return 1
    cap = max(1, num_steps // epoch_div) if num_steps >= 2 * epoch_div else num_steps
    return max(1, min(batch_size, cap))


def derive_config_1d(g: GraphTensors, **overrides) -> SgdConfig:
    """1D defaults: iter_max=100, min_term_updates = steps, eta_max =
    max_steps^2, Zipf space = longest path in nucleotides."""
    sum_steps = int(g.num_steps)
    max_steps = int(g.path_step_count.max()) if g.num_paths else 1
    space = int(g.path_length.max()) if g.num_paths else 1
    space_max = int(overrides.pop("space_max", 100))
    max_dists = max(space_max + 1, 100)
    if space > space_max:
        quant = max(2, -(-(space - space_max) // (max_dists - space_max)))
    else:
        quant = 100
    cfg = dict(
        iter_max=100,
        min_term_updates=sum_steps,
        eta_max=float(max_steps) ** 2,
        space=max(1, space),
        space_max=space_max,
        space_quantization_step=quant,
        theta=0.99,
        cooling_start=0.5,
    )
    cfg.update(overrides)
    cfg["batch_size"] = _clamp_batch(cfg.get("batch_size", SgdConfig.batch_size), sum_steps, 4)
    return SgdConfig(**cfg)


def derive_config_2d(g: GraphTensors, **overrides) -> SgdConfig:
    """2D defaults: iter_max=30, min_term_updates = 10 x steps, Zipf space =
    most steps in a path, space_max=1000, quantization step 100."""
    sum_steps = int(g.num_steps)
    max_steps = int(g.path_step_count.max()) if g.num_paths else 1
    space = max(1, max_steps)
    cfg = dict(
        iter_max=30,
        min_term_updates=10 * sum_steps,
        eta_max=float(max_steps) ** 2,
        space=space,
        space_max=min(space, 1000),
        space_quantization_step=100,
        theta=0.99,
        cooling_start=0.5,
    )
    cfg.update(overrides)
    cfg["batch_size"] = _clamp_batch(cfg.get("batch_size", SgdConfig.batch_size), sum_steps, 2)
    return SgdConfig(**cfg)


DELTA_NOTE = ("[odgi_tpu_torch::sgd] note: delta early-stop (-j) with a graph beyond the "
              "resident kernels falls back to the slower batched path")

# What the last run of path_sgd_1d / path_sgd_2d did: its route
# ("resident", "xl", "xxl" or "batched"), the iterations it ran and, with
# delta > 0, each iteration's Delta_max.
LAST_RUN: dict = {}


def _run_route(g: GraphTensors, cfg: SgdConfig, one_d: bool, use_paths, pin_nodes,
               snapshot_cb):
    """(graph, route) of a run, as the reference dispatches it: PG-SGD on a
    subset of the paths runs the graph of the kept paths (the config stays
    the caller's); pinning and snapshots take the batched path; so does
    delta early stop past the resident route, after a note on stderr.
    Each run counts one ``strata.route.<route>`` in ``utils.metrics.TOTALS``."""
    from .strata_route import graph_route

    if use_paths is not None and sorted(use_paths) != list(range(g.num_paths)):
        g = g.keep_paths(sorted(use_paths))
    if pin_nodes is not None or snapshot_cb is not None:
        route = "batched"
    else:
        route = graph_route(g, cfg, one_d)
        if cfg.delta > 0 and route != "resident":
            print(DELTA_NOTE, file=sys.stderr)
            route = "batched"
    count(f"strata.route.{route}")
    return g, route


def path_sgd_1d(
    g: GraphTensors,
    cfg: Optional[SgdConfig] = None,
    use_paths: Optional[Sequence[int]] = None,
    x0=None,
    pin_nodes=None,
    snapshot_cb=None,
    device=None,
) -> torch.Tensor:
    """1D PG-SGD; returns the final X positions, f64 (N,) on `device`.

    X starts at the cumulative node lengths in current order unless `x0`
    is given.  Skips when no path has more than one step.  `use_paths`
    runs on those paths only (-f); `pin_nodes` (bool (N,)) keeps those
    nodes where they start (-H); `snapshot_cb(it, X)` gets the host f64
    positions after every iteration (-u); cfg.delta > 0 stops early (-j)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = derive_config_1d(g)
    if not (g.path_step_count > 1).any():
        return torch.as_tensor(g.node_offset.astype(np.float64), device=dev)
    g_run, route = _run_route(g, cfg, True, use_paths, pin_nodes, snapshot_cb)
    LAST_RUN.clear()
    if route == "batched":
        from .batched_sgd import path_sgd_1d_batched

        out = path_sgd_1d_batched(g_run, cfg, x0, pin_nodes, snapshot_cb, dev)
        LAST_RUN.update(route=route, iterations=out["iterations"], delta_max=out["delta_max"])
        return out["x"]
    from .strata_sgd import path_sgd_1d_strata

    return path_sgd_1d_strata(g_run, cfg, x0, dev, route=route)


def path_sgd_2d(
    g: GraphTensors,
    coords0,
    cfg: Optional[SgdConfig] = None,
    use_paths: Optional[Sequence[int]] = None,
    pin_nodes=None,
    snapshot_cb=None,
    device=None,
) -> torch.Tensor:
    """2D PG-SGD layout from the (2N, 2) initial coordinates `coords0`;
    returns f64 (2N, 2) coordinates on `device`.  The options as
    `path_sgd_1d` (pinning keeps both endpoints of a pinned node)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = derive_config_2d(g)
    if not (g.path_step_count > 1).any():
        return torch.as_tensor(np.asarray(coords0, np.float64), device=dev)
    g_run, route = _run_route(g, cfg, False, use_paths, pin_nodes, snapshot_cb)
    LAST_RUN.clear()
    if route == "batched":
        from .batched_sgd import path_sgd_2d_batched

        out = path_sgd_2d_batched(g_run, coords0, cfg, pin_nodes, snapshot_cb, dev)
        LAST_RUN.update(route=route, iterations=out["iterations"], delta_max=out["delta_max"])
        return out["x"]
    from .strata_sgd import path_sgd_2d_strata

    return path_sgd_2d_strata(g_run, coords0, cfg, dev, route=route)
