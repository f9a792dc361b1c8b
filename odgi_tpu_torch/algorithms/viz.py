"""1D binned graph raster: the ``odgi viz`` model, the counterpart of
``odgi_tpu/algorithms/viz.py``, drawn without PIL.

Every bin statistic (mean depth, inversion, uncalled share and position
of each path in each pixel column) is a bincount over the step table; the
picture is a numpy RGB array: a top band of node marks and link arcs, then
one row (or packed rows) a path.  The path-name labels come from
``font.py``'s copy of PIL's default font, and the PNG from ``io/png.py``,
so the pixels and the file bytes are ``odgi_tpu``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..core.graph import GraphTensors, handle_is_reverse, handle_rank
from ..io import png
from .colorbrewer import parse_scheme_spec
from .font import text_raster


@dataclass
class PathBins:
    """Per-path binned statistics (bin_path_info.hpp:24-41 analog)."""

    mean_depth: np.ndarray      # f64[P, B] mean coverage depth per bin
    mean_inv: np.ndarray        # f64[P, B] fraction of reverse coverage
    mean_pos: np.ndarray        # f64[P, B] mean path-position per bin
    mean_uncalled: np.ndarray   # f64[P, B] fraction of N bases per bin
    first_bin: np.ndarray       # i64[P] first covered bin per path
    last_bin: np.ndarray        # i64[P] last covered bin per path


def bin_paths(g: GraphTensors, num_bins: int) -> PathBins:
    """Bin every path's coverage over the pangenome positions.

    Each step covers [node_offset, node_offset+len) in the linearized
    pangenome; contributions are split across bins at bp granularity
    using prefix sums (no per-bp loops).
    """
    P = g.num_paths
    total = max(1, g.total_length)
    bin_width = total / num_bins
    depth = np.zeros((P, num_bins), dtype=np.float64)
    inv = np.zeros((P, num_bins), dtype=np.float64)
    pos_sum = np.zeros((P, num_bins), dtype=np.float64)
    unc_sum = np.zeros((P, num_bins), dtype=np.float64)

    # per-node fraction of uncalled (N/n) bases, for the -N color mode
    is_n = (g.seq == ord("N")) | (g.seq == ord("n"))
    if g.num_nodes and len(g.seq):
        idx = np.minimum(g.seq_offset[:-1], len(g.seq) - 1)
        n_count = np.add.reduceat(is_n.astype(np.int64), idx)
    else:
        n_count = np.zeros(g.num_nodes, np.int64)
    if g.num_nodes:
        n_frac_node = np.where(
            g.node_len > 0, n_count / np.maximum(g.node_len, 1), 0.0
        )
    else:
        n_frac_node = np.zeros(0)

    ranks = handle_rank(g.step_handle)
    revs = handle_is_reverse(g.step_handle)
    starts = g.node_offset[ranks].astype(np.float64)  # pangenome start bp
    lens = g.node_len[ranks].astype(np.float64)
    ends = starts + lens
    b0 = np.minimum((starts / bin_width).astype(np.int64), num_bins - 1)
    b1 = np.minimum(((ends - 1e-9) / bin_width).astype(np.int64), num_bins - 1)
    sp = g.step_path
    ppos = g.step_pos.astype(np.float64)

    # most steps fall in one bin; handle multi-bin spans per extra bin
    span = b1 - b0
    max_span = int(span.max()) if len(span) else 0
    for k in range(max_span + 1):
        sel = span >= k
        if not sel.any():
            break
        b = b0[sel] + k
        # overlap of [start, end) with bin b
        lo = np.maximum(starts[sel], b * bin_width)
        hi = np.minimum(ends[sel], (b + 1) * bin_width)
        frac = np.maximum(hi - lo, 0.0)
        flat = sp[sel] * num_bins + b
        np.add.at(depth.ravel(), flat, frac)
        np.add.at(inv.ravel(), flat, frac * revs[sel])
        np.add.at(pos_sum.ravel(), flat, frac * ppos[sel])
        np.add.at(unc_sum.ravel(), flat, frac * n_frac_node[ranks[sel]])

    with np.errstate(invalid="ignore", divide="ignore"):
        mean_inv = np.where(depth > 0, inv / depth, 0.0)
        mean_pos = np.where(depth > 0, pos_sum / depth, 0.0)
        mean_unc = np.where(depth > 0, unc_sum / depth, 0.0)
    mean_depth = depth / bin_width

    covered = depth > 0
    first_bin = np.where(
        covered.any(axis=1), covered.argmax(axis=1), 0
    ).astype(np.int64)
    last_bin = np.where(
        covered.any(axis=1),
        num_bins - 1 - covered[:, ::-1].argmax(axis=1),
        0,
    ).astype(np.int64)
    return PathBins(
        mean_depth, mean_inv, mean_pos, mean_unc, first_bin, last_bin
    )


# simple categorical palette for paths (spectral-ish)
_PATH_COLORS = np.array(
    [
        (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97),
        (254, 224, 139), (230, 245, 152), (171, 221, 164), (102, 194, 165),
        (50, 136, 189), (94, 79, 162), (140, 81, 10), (1, 102, 94),
    ],
    dtype=np.uint8,
)


def _text_mask(text: str, height: int) -> np.ndarray:
    """bool[h, w] raster of `text` for the path-name labels: PIL's default
    font (``font.py``), cropped to its ink, and cut down by nearest rows
    to `height`."""
    arr = text_raster(text)
    rows = np.nonzero(arr.any(axis=1))[0]
    cols = np.nonzero(arr.any(axis=0))[0]
    if len(rows) == 0:
        return np.zeros((height, 1), bool)
    arr = arr[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]
    if arr.shape[0] > height:
        # nearest-neighbor downscale to the row height
        yi = (np.arange(height) * arr.shape[0] // height).clip(0, arr.shape[0] - 1)
        arr = arr[yi]
    return arr


def _prefix_of(name: str, delim: str) -> str:
    i = name.find(delim)
    return name[:i] if i >= 0 else name


def render_viz(
    g: GraphTensors,
    width: int = 1500,
    path_height: int = 10,
    color_by: str = "path",  # path|strand|depth|gray|inversion|uncalled|prefix
    link_band: int = 40,
    paths: Optional[Sequence[int]] = None,
    prefix_delim: str = "#",
    path_colors: Optional[dict] = None,     # name -> (r, g, b) (-c FILE)
    colorbrewer_scheme: Optional[str] = None,  # SCHEME:N for depth mode (-B)
    no_grey_depth: bool = False,
    pack_paths: bool = False,               # -R
    merge_prefixes: Optional[Sequence[str]] = None,  # -M FILE
    ignore_prefix: Optional[str] = None,    # -I
    show_path_names: bool = True,           # not -H
    color_path_names_background: bool = False,  # -C
    max_name_chars: int = 32,
    path_borders: bool = True,              # not -n
    black_path_borders: bool = False,       # -b
    change_darkness: bool = False,          # -d gradient mode
    highlight_nodes: Optional[Sequence[int]] = None,  # -m node-id file
) -> np.ndarray:
    """Render the binned 1D visualization; returns RGB uint8 image.

    Layout and color modes mirror the reference (viz_main.cpp:56-160
    flags; :583-605 binning; :616-676 prefix grouping; :1025-1560
    rasterizers): a top band with node marks and inter-bin link arcs,
    then one row (or packed rows, -R) per display path.
    """
    sel = list(range(g.num_paths)) if paths is None else list(paths)
    if ignore_prefix:
        sel = [p for p in sel if not g.path_names[p].startswith(ignore_prefix)]

    # prefix merging (-M): each display row covers a group of paths
    groups: list = []
    labels: list = []
    if merge_prefixes:
        used = set()
        for pref in merge_prefixes:
            members = [
                p for p in sel
                if g.path_names[p].startswith(pref) and p not in used
            ]
            if members:
                groups.append(members)
                labels.append(pref)
                used.update(members)
        for p in sel:
            if p not in used:
                groups.append([p])
                labels.append(g.path_names[p])
    else:
        groups = [[p] for p in sel]
        labels = [g.path_names[p] for p in sel]

    bins = bin_paths(g, width)

    # merge group bin stats (coverage-weighted)
    G = len(groups)
    depth = np.zeros((G, width))
    inv = np.zeros((G, width))
    unc = np.zeros((G, width))
    pos = np.zeros((G, width))
    for gi, members in enumerate(groups):
        d = bins.mean_depth[members].sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            wsum = np.maximum(bins.mean_depth[members].sum(axis=0), 1e-30)
            inv[gi] = (bins.mean_inv[members] * bins.mean_depth[members]).sum(0) / wsum
            unc[gi] = (bins.mean_uncalled[members] * bins.mean_depth[members]).sum(0) / wsum
            pos[gi] = (bins.mean_pos[members] * bins.mean_depth[members]).sum(0) / wsum
        depth[gi] = d
    covered = depth > 0
    fb = np.where(covered.any(1), covered.argmax(1), 0)
    lb = np.where(covered.any(1), width - 1 - covered[:, ::-1].argmax(1), 0)

    # row packing (-R): first-fit by [first_bin, last_bin] intervals
    if pack_paths:
        row_of = np.zeros(G, dtype=np.int64)
        row_last = []  # last occupied bin per row
        order = np.argsort(fb, kind="stable")
        for gi in order:
            placed = False
            for ri, last in enumerate(row_last):
                if fb[gi] > last + 1:
                    row_of[gi] = ri
                    row_last[ri] = lb[gi]
                    placed = True
                    break
            if not placed:
                row_of[gi] = len(row_last)
                row_last.append(lb[gi])
        n_rows = max(len(row_last), 1)
    else:
        row_of = np.arange(G, dtype=np.int64)
        n_rows = G

    label_w = 0
    if show_path_names and not pack_paths and G:
        label_w = min(max(len(l) for l in labels), max_name_chars) * 6 + 4

    H = link_band + 4 + n_rows * path_height
    W = label_w + width
    img = np.full((H, W, 3), 255, dtype=np.uint8)

    # top band: node extent marks
    total = max(1, g.total_length)
    bw = total / width
    node_b0 = np.minimum((g.node_offset / bw).astype(np.int64), width - 1)
    img[link_band : link_band + 2, label_w:, :] = 230
    img[link_band : link_band + 2, label_w + node_b0, :] = 60
    if highlight_nodes is not None:
        hi = np.asarray(
            [g.id_to_rank[i] for i in highlight_nodes if i in g.id_to_rank],
            dtype=np.int64,
        )
        img[link_band : link_band + 2, label_w:, :] = 180
        if len(hi):
            img[link_band : link_band + 2, label_w + node_b0[hi], :] = (
                np.array([220, 30, 30], np.uint8)
            )

    # link arcs: edges whose endpoints land in non-adjacent bins
    ef_rank = handle_rank(g.edge_from)
    et_rank = handle_rank(g.edge_to)
    fbb = node_b0[ef_rank]
    tbb = node_b0[et_rank]
    lo_b = np.minimum(fbb, tbb)
    hi_b = np.maximum(fbb, tbb)
    nonadj = hi_b - lo_b > 1
    for a, b in zip(lo_b[nonadj], hi_b[nonadj]):
        h = min(link_band - 1, max(2, int((b - a) / width * link_band * 2)))
        y = link_band - 1 - h
        img[y : link_band, label_w + a, :] = 120
        img[y : link_band, label_w + b, :] = 120
        img[y, label_w + a : label_w + b + 1, :] = 120

    # group base colors
    cb = parse_scheme_spec(colorbrewer_scheme) if colorbrewer_scheme else None
    prefixes = [_prefix_of(l, prefix_delim) for l in labels]
    uniq_prefixes = sorted(set(prefixes))
    prefix_idx = {q: i for i, q in enumerate(uniq_prefixes)}

    def base_color(gi: int) -> np.ndarray:
        name = labels[gi]
        if path_colors and name in path_colors:
            return np.asarray(path_colors[name], np.uint8)
        if color_by == "prefix":
            return _PATH_COLORS[prefix_idx[prefixes[gi]] % len(_PATH_COLORS)]
        return _PATH_COLORS[gi % len(_PATH_COLORS)]

    # path rows
    border = (
        np.array([0, 0, 0], np.uint8)
        if black_path_borders
        else np.array([255, 255, 255], np.uint8)
    )
    for gi in range(G):
        y0 = link_band + 4 + int(row_of[gi]) * path_height
        y1 = y0 + path_height - (1 if path_borders else 0)
        cv = covered[gi]
        if color_by == "strand":
            col = np.where(
                inv[gi][:, None] > 0.5,
                np.array([220, 30, 30], np.uint8),
                np.array([40, 40, 40], np.uint8),
            )
        elif color_by == "inversion":
            # black (forward) -> red by mean inversion rate (viz -z)
            t = np.clip(inv[gi], 0, 1)[:, None]
            black = np.array([40, 40, 40], np.float64)
            red = np.array([220, 30, 30], np.float64)
            col = (black + (red - black) * t).astype(np.uint8)
        elif color_by == "uncalled":
            # green (called) -> red by uncalled fraction (viz -N)
            t = np.clip(unc[gi], 0, 1)[:, None]
            ok = np.array([50, 160, 60], np.float64)
            bad = np.array([220, 30, 30], np.float64)
            col = (ok + (bad - ok) * t).astype(np.uint8)
        elif color_by == "depth":
            d = depth[gi]
            if cb is not None:
                # colorbrewer bucketing (viz -B/-m mean depth mode);
                # without no_grey_depth, <0.5x and ~1x stay grey
                dmax = d.max() if d.max() > 0 else 1.0
                ncol = len(cb)
                ci = np.minimum(
                    (d / dmax * ncol).astype(np.int64), ncol - 1
                )
                col = np.asarray(cb, np.uint8)[ci]
                if not no_grey_depth:
                    grey = np.array([128, 128, 128], np.uint8)
                    col = np.where(
                        ((d < 0.5) | (np.abs(d - 1.0) < 0.1))[:, None],
                        grey,
                        col,
                    )
            else:
                dmax = d.max() if d.max() > 0 else 1.0
                t = np.clip(d / dmax, 0, 1)[:, None]
                cold = np.array([225, 240, 255], np.float64)
                hot = np.array([8, 48, 107], np.float64)
                col = (cold + (hot - cold) * t).astype(np.uint8)
        elif color_by == "gray":
            col = np.tile(np.array([70, 70, 70], np.uint8), (width, 1))
        else:  # per-path / per-prefix categorical (or -c custom colors)
            col = np.tile(base_color(gi), (width, 1))
        if change_darkness:
            # darkness by mean nucleotide position in the path (viz -d)
            plen = max(float(max(g.path_length[p] for p in groups[gi])), 1.0)
            t = np.clip(pos[gi] / plen, 0, 1)[:, None]
            col = (col.astype(np.float64) * (1.0 - 0.8 * t)).astype(np.uint8)
        rowimg = np.full((width, 3), 255, np.uint8)
        rowimg[cv] = col[cv]
        img[y0:y1, label_w:, :] = rowimg[None, :, :]
        if path_borders:
            img[y1 : y1 + 1, label_w:, :] = border

        # label text in the left margin
        if label_w:
            if color_path_names_background:
                img[y0:y1, :label_w, :] = base_color(gi)
            text = labels[gi][:max_name_chars]
            mask = _text_mask(text, max(path_height - 2, 5))
            mh, mw = mask.shape
            mw = min(mw, label_w - 2)
            yoff = y0 + max((path_height - mh) // 2, 0)
            region = img[yoff : yoff + mh, 1 : 1 + mw, :]
            region[mask[:, :mw][: region.shape[0]]] = 0
    return img


def save_viz_png(
    g: GraphTensors, out_path: str, width: int = 1500, **kwargs
) -> None:
    """Render and write a PNG (the `odgi viz -o` entry point)."""
    png.write(render_viz(g, width=width, **kwargs), out_path)
