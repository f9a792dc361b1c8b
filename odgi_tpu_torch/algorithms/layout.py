"""2D layout: initial coordinates, PG-SGD layout, component packing, TSV.

Coordinates are (2N, 2): two endpoints per node (start, end) x (x, y), with
endpoint index 2*rank + use_other_end.
"""

from __future__ import annotations

from typing import Optional, TextIO, Tuple, Union

import numpy as np

from ..core.graph import GraphTensors
from ..device import resolve_device
from ..ops.sgd import SgdConfig, path_sgd_2d
from ..utils.metrics import span
from .components import weak_component_ids


def hilbert_d2xy(n: int, d: int) -> Tuple[int, int]:
    """Hilbert curve index d -> (x, y) on an n x n grid (the reference's
    hilbert.hpp, as odgi_tpu's `hilbert_d2xy`)."""
    rx = ry = 0
    x = y = 0
    t = d
    s = 1
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


@span("layout.init")
def init_layout(g: GraphTensors, mode: str = "d", seed: int = 9399220) -> np.ndarray:
    """Initial (2N, 2) coordinates, from numpy's default_rng(seed), so every
    mode equals the JAX package's byte for byte.  Modes: 'd' (the default:
    X = cumulative bp of each endpoint, Y gaussian with sd sqrt(2N)), 'u'
    (X cumulative, Y uniform in [0, sd)), 'r' (both uniform in the total
    length), 'g' (both gaussian), 'h' (a Hilbert curve over the endpoint
    index space); any other mode is 'd', as in the JAX package."""
    n = g.num_nodes
    rng = np.random.default_rng(seed)
    coords = np.zeros((2 * n, 2), dtype=np.float64)
    sd = np.sqrt(2.0 * n)
    starts = g.node_offset.astype(np.float64)
    if mode == "g":
        coords[:, 0] = rng.normal(0, sd, 2 * n)
        coords[:, 1] = rng.normal(0, sd, 2 * n)
    elif mode == "r":
        total_len = float(g.total_length)
        coords[:, 0] = rng.uniform(0, total_len, 2 * n)
        coords[:, 1] = rng.uniform(0, total_len, 2 * n)
    elif mode == "h":
        side = 1
        while side * side < 2 * n:
            side *= 2
        for pos in range(2 * n):
            coords[pos] = hilbert_d2xy(side, pos)
    else:
        coords[0::2, 0] = starts
        coords[1::2, 0] = starts + g.node_len
        coords[:, 1] = (rng.uniform(0, sd, 2 * n) if mode == "u"
                        else rng.normal(0, sd, 2 * n))
    return coords


@span("layout.pack")
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
                 seed: int = 9399220, init_mode: str = "d", use_paths=None,
                 snapshot_cb=None, device=None) -> np.ndarray:
    """`odgi layout`: initial coordinates (`init_mode`, from `seed`), 2D
    PG-SGD on `device` (on the paths `use_paths` only, -f;
    `snapshot_cb(it, coords)` after every iteration, -u), component
    packing.  Returns (2N, 2) f64 on the host."""
    dev = resolve_device(device)
    coords0 = init_layout(g, init_mode, seed)
    coords = path_sgd_2d(g, coords0, cfg, use_paths=use_paths, snapshot_cb=snapshot_cb,
                         device=dev)
    return pack_components(g, coords.cpu().numpy())


def layout_to_tsv(coords: np.ndarray, out: Union[str, TextIO]) -> None:
    """TSV export, one row per endpoint, 17 significant digits (the
    reference's Layout::to_tsv, as odgi_tpu's `layout_to_tsv`)."""
    close = isinstance(out, str)
    if close:
        out = open(out, "w")
    try:
        out.write("idx\tX\tY\n")
        for i in range(len(coords)):
            out.write(f"{i}\t{_fmt(coords[i, 0])}\t{_fmt(coords[i, 1])}\n")
    finally:
        if close:
            out.close()


def _fmt(v: float) -> str:
    """std::setprecision(digits10 + 1) default-float formatting."""
    return np.format_float_positional(v, precision=16, unique=True, trim="-")
