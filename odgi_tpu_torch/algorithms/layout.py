"""2D layout: initial coordinates, PG-SGD layout, component packing.

Coordinates are (2N, 2): two endpoints per node (start, end) x (x, y), with
endpoint index 2*rank + use_other_end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.graph import GraphTensors
from ..device import resolve_device
from ..ops.sgd import SgdConfig, not_ported, path_sgd_2d
from .components import weak_component_ids


def init_layout(g: GraphTensors, mode: str = "d", seed: int = 9399220) -> np.ndarray:
    """Initial (2N, 2) coordinates, mode 'd' (the default): X = cumulative
    bp of each endpoint, Y = gaussian with sd sqrt(2N), from numpy's
    default_rng(seed), so the values equal the JAX package's."""
    if mode != "d":
        raise not_ported(f"layout init mode {mode!r}", 13)
    n = g.num_nodes
    rng = np.random.default_rng(seed)
    coords = np.zeros((2 * n, 2), dtype=np.float64)
    sd = np.sqrt(2.0 * n)
    starts = g.node_offset.astype(np.float64)
    coords[0::2, 0] = starts
    coords[1::2, 0] = starts + g.node_len
    coords[:, 1] = rng.normal(0, sd, 2 * n)
    return coords


def pack_components(g: GraphTensors, coords: np.ndarray, border: float = 1000.0) -> np.ndarray:
    """Stack weakly-connected components vertically with a border."""
    comp = weak_component_ids(g)
    ncomp = int(comp.max()) + 1 if len(comp) else 0
    out = np.array(coords, dtype=np.float64)
    ep_comp = np.repeat(comp, 2)
    curr_y_offset = border
    for c in range(ncomp):
        sel = ep_comp == c
        min_x = out[sel, 0].min()
        min_y = out[sel, 1].min()
        max_y = out[sel, 1].max()
        out[sel, 0] -= min_x - border
        out[sel, 1] += curr_y_offset - min_y
        curr_y_offset += (max_y - min_y) + border
    return out


def layout_graph(g: GraphTensors, cfg: Optional[SgdConfig] = None,
                 seed: int = 9399220, device=None) -> np.ndarray:
    """`odgi layout`: initial coordinates (mode 'd'), 2D PG-SGD on `device`,
    component packing.  Returns (2N, 2) f64 on the host."""
    dev = resolve_device(device)
    coords0 = init_layout(g, "d", seed)
    return pack_components(g, path_sgd_2d(g, coords0, cfg, device=dev).cpu().numpy())
