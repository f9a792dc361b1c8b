"""PG-SGD 1D sort and the sort pipeline ("Ygs").

Run 1D PG-SGD, then order nodes by (weakly-connected component, X, rank);
the pipeline chains sort passes by one-letter codes, every code of
``odgi_tpu``'s pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.graph import GraphTensors, handle_rank
from ..device import resolve_device
from ..io.og_compat import save_og
from ..ops.sgd import SgdConfig, derive_config_1d, path_sgd_1d
from ..utils.metrics import span
from ..utils.progress import ProgressMeter
from .components import weak_component_ids
from .graph_misc import eades_order, linear_sgd_order
from .groom import apply_groom
from .sorts_extra import (breadth_first_topological_order, cycle_breaking_order,
                          dagify_sort_order, depth_first_topological_order,
                          two_way_topological_order)
from .topological import topological_order

# Every code of odgi_tpu's sort pipeline.
CODES = "Ygsnfrbzwcdel"


@span("sort.order")
def order_from_x(g: GraphTensors, X) -> np.ndarray:
    """(component, X, rank) lexsort of a 1D embedding."""
    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    comp = weak_component_ids(g)
    ranks = np.arange(g.num_nodes, dtype=np.int64)
    return np.lexsort((ranks, np.asarray(X), comp))


def target_pin_mask(g: GraphTensors, target_paths: Sequence[int]) -> np.ndarray:
    """bool (N,): the nodes the target paths visit (-H pins them)."""
    pin = np.zeros(g.num_nodes, dtype=bool)
    for t in target_paths:
        lo, hi = int(g.path_offset[t]), int(g.path_offset[t + 1])
        pin[handle_rank(g.step_handle[lo:hi])] = True
    return pin


def path_sgd_order(g: GraphTensors, cfg: Optional[SgdConfig] = None,
                   use_paths: Optional[Sequence[int]] = None, return_x: bool = False,
                   overrides: Optional[dict] = None,
                   target_paths: Optional[Sequence[int]] = None, snapshot_cb=None,
                   device=None):
    """1D PG-SGD node order: i64[N] of old ranks (and the f64 host X with
    `return_x`).  `overrides` derive the config when `cfg` is None;
    `target_paths` pin their nodes (-H); `use_paths` (-f) and
    `snapshot_cb(it, X)` (-u) as `ops.sgd.path_sgd_1d`."""
    if cfg is None and overrides:
        cfg = derive_config_1d(g, **overrides)
    pin = target_pin_mask(g, target_paths) if target_paths else None
    X = path_sgd_1d(g, cfg, use_paths, pin_nodes=pin, snapshot_cb=snapshot_cb,
                    device=device).cpu().numpy()
    order = order_from_x(g, X)
    return (order, X) if return_x else order


def _snapshot_writer(g: GraphTensors, prefix: str):
    """-u: after iteration it, write `g` sorted by that iteration's X as
    the .og file "<prefix><it + 1>"."""

    def write(it, X):
        save_og(g.apply_ordering(order_from_x(g, X), compact_ids=True), f"{prefix}{it + 1}")

    return write


def _progress_meter(g: GraphTensors, sgd_overrides: Optional[dict]):
    """-P: a meter of the Y pass's iterations on stderr, as its callback."""
    meter = ProgressMeter(derive_config_1d(g, **(sgd_overrides or {})).iter_max,
                          "[odgi_tpu_torch::sort] 1D PG-SGD iterations")

    def tick(it, X):
        meter.increment()
        if it + 1 >= meter.total:
            meter.finish()

    return tick


def sort_pipeline(g: GraphTensors, pipeline: str = "Ygs", sgd_overrides: Optional[dict] = None,
                  target_paths: Optional[Sequence[int]] = None,
                  use_paths: Optional[Sequence[int]] = None,
                  snapshot_prefix: Optional[str] = None, progress: bool = False,
                  bfs_chunk: int = 0, dfs_chunk: int = 0, device=None) -> GraphTensors:
    """Apply a chain of sort passes, one a code:
    Y  1D PG-SGD on `device` (span ``sort.path_sgd``: the run, the copy of
       its positions to the host and their order), with the config
       overrides `sgd_overrides`,
       the pinned `target_paths` and the path subset `use_paths`; with
       `snapshot_prefix` each iteration's order is written as the .og file
       "<prefix><iteration>", and `progress` (without snapshots) shows a
       meter of its iterations on stderr; either callback takes the batched
       path, as in ``odgi_tpu``;
    g  groom;  s  topological order from the heads;  n  without them;
    f  reverse the order;  r  a random order (default_rng(9399220));
    b / z  breadth- / depth-first from the heads (`bfs_chunk` / `dfs_chunk`
       are taken and, as in ``odgi_tpu``, change nothing);
    w  two-way topological;  c  cycle breaking;  d  dagify;
    e  Eades' feedback-arc-set order;  l  the non-path linear SGD order.
    An unknown code raises ValueError before any pass runs."""
    dev = resolve_device(device)
    for c in pipeline:
        if c not in CODES:
            raise ValueError(f"unsupported sort pipeline code {c!r}")
    for c in pipeline:
        if c == "Y":
            snapshot_cb = None
            if snapshot_prefix:
                snapshot_cb = _snapshot_writer(g, snapshot_prefix)
            elif progress:
                snapshot_cb = _progress_meter(g, sgd_overrides)
            with span("sort.path_sgd"):
                order = path_sgd_order(g, use_paths=use_paths, overrides=sgd_overrides,
                                       target_paths=target_paths, snapshot_cb=snapshot_cb,
                                       device=dev)
        elif c == "g":
            g = apply_groom(g)
            continue
        elif c == "s":
            order = topological_order(g, use_heads=True)
        elif c == "n":
            order = topological_order(g, use_heads=False)
        elif c == "f":
            order = np.arange(g.num_nodes - 1, -1, -1, dtype=np.int64)
        elif c == "r":
            order = np.random.default_rng(9399220).permutation(g.num_nodes).astype(np.int64)
        elif c == "b":
            order = breadth_first_topological_order(g, bfs_chunk)
        elif c == "z":
            order = depth_first_topological_order(g, dfs_chunk)
        elif c == "w":
            order = two_way_topological_order(g)
        elif c == "c":
            order = cycle_breaking_order(g)
        elif c == "d":
            order = dagify_sort_order(g)
        elif c == "e":
            order = eades_order(g)
        else:  # "l"
            order = linear_sgd_order(g)
        g = g.apply_ordering(order, compact_ids=True)
    return g
