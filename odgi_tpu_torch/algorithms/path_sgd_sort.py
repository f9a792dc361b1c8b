"""PG-SGD 1D sort and the sort pipeline ("Ygs").

Run 1D PG-SGD, then order nodes by (weakly-connected component, X, rank);
the pipeline chains sort passes by one-letter codes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.graph import GraphTensors, handle_rank
from ..device import resolve_device
from ..ops.sgd import SgdConfig, derive_config_1d, not_ported, path_sgd_1d
from ..utils.progress import ProgressMeter
from .components import weak_component_ids
from .groom import apply_groom
from .topological import topological_order

# The codes of this slice; the reference's others wait for the host
# algorithm modules (ROADMAP.md queue 1 item 13).
SUPPORTED_CODES = "Ygs"


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


def sort_pipeline(g: GraphTensors, pipeline: str = "Ygs", sgd_overrides: Optional[dict] = None,
                  target_paths: Optional[Sequence[int]] = None,
                  use_paths: Optional[Sequence[int]] = None,
                  snapshot_prefix: Optional[str] = None, progress: bool = False,
                  device=None) -> GraphTensors:
    """Apply a chain of sort passes: Y (1D PG-SGD on `device`, with the
    config overrides `sgd_overrides`, the pinned `target_paths` and the
    path subset `use_paths`; `progress` shows a meter of its iterations on
    stderr, whose per-iteration callback takes the batched path, as in
    ``odgi_tpu``), g (groom), s (topological order from the heads)."""
    dev = resolve_device(device)
    for c in pipeline:
        if c not in SUPPORTED_CODES:
            raise not_ported(f"sort pipeline code {c!r}", 13)
    if snapshot_prefix:
        raise not_ported("per-iteration .og snapshots of the sort (-u)", 13)
    for c in pipeline:
        if c == "Y":
            snapshot_cb = None
            if progress:
                meter = ProgressMeter(derive_config_1d(g, **(sgd_overrides or {})).iter_max,
                                      "[odgi_tpu_torch::sort] 1D PG-SGD iterations")

                def snapshot_cb(it, X, _m=meter):
                    _m.increment()
                    if it + 1 >= _m.total:
                        _m.finish()

            g = g.apply_ordering(
                path_sgd_order(g, use_paths=use_paths, overrides=sgd_overrides,
                               target_paths=target_paths, snapshot_cb=snapshot_cb,
                               device=dev),
                compact_ids=True,
            )
        elif c == "g":
            g = apply_groom(g)
        elif c == "s":
            g = g.apply_ordering(topological_order(g, use_heads=True), compact_ids=True)
    return g
