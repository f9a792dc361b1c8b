"""PG-SGD 1D sort and the sort pipeline ("Ygs").

Run 1D PG-SGD, then order nodes by (weakly-connected component, X, rank);
the pipeline chains sort passes by one-letter codes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.graph import GraphTensors
from ..device import resolve_device
from ..ops.sgd import SgdConfig, not_ported, path_sgd_1d
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


def path_sgd_order(g: GraphTensors, cfg: Optional[SgdConfig] = None,
                   device=None) -> np.ndarray:
    """1D PG-SGD node order: i64[N] of old ranks."""
    return order_from_x(g, path_sgd_1d(g, cfg, device=device))


def sort_pipeline(g: GraphTensors, pipeline: str = "Ygs", device=None) -> GraphTensors:
    """Apply a chain of sort passes: Y (1D PG-SGD on `device`), g (groom),
    s (topological order from the heads)."""
    dev = resolve_device(device)
    for c in pipeline:
        if c not in SUPPORTED_CODES:
            raise not_ported(f"sort pipeline code {c!r}", 13)
    for c in pipeline:
        if c == "Y":
            g = g.apply_ordering(
                path_sgd_order(g, device=dev),
                compact_ids=True,
            )
        elif c == "g":
            g = apply_groom(g)
        elif c == "s":
            g = g.apply_ordering(topological_order(g, use_heads=True), compact_ids=True)
    return g
