"""2D layout pictures: the ``odgi draw`` model, the counterpart of
``odgi_tpu/algorithms/draw.py``, drawn without PIL.

One line segment a node, between its two layout endpoints.  `draw_svg`
writes one ``<line>`` each; `draw_png` rasterizes every segment at once as
Pillow's ``ImageDraw.line`` does one at a time (the coordinates truncated
to integers; at width 1 Bresenham's line with its end point, wider a
four-vertex polygon filled scanline by scanline), the segment of the
highest node rank winning a pixel that several set, as ``odgi_tpu``'s
drawing order does, and writes the PNG through ``io/png.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.graph import GraphTensors, handle_rank
from ..io import png
from .viz import _PATH_COLORS


def _round_up(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP: half away from zero, the half added in `v`'s own
    precision (float32 for the scanline crossings, float64 otherwise)."""
    h = v.dtype.type(0.5)
    return np.where(v >= 0, np.floor(v + h), -np.floor(np.abs(v) + h)).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN: half toward zero, in `v`'s own precision."""
    h = v.dtype.type(0.5)
    return np.where(v >= 0, np.ceil(v - h), -np.ceil(np.abs(v) - h)).astype(np.int64)


def _thin_pixels(x0, y0, x1, y1):
    """(segment, x, y) of every pixel ``ImageDraw.line(width=1)`` sets:
    the major axis stepped max(|dx|, |dy|) times with the error term
    2 * minor - major (in closed form: the minor offset after i steps is
    (2 * minor * i + major) // (2 * major)), then the end point."""
    dx, dy = x1 - x0, y1 - y0
    adx, ady = np.abs(dx), np.abs(dy)
    n = np.maximum(adx, ady)
    seg = np.repeat(np.arange(len(n), dtype=np.int64), n)
    i = np.arange(len(seg), dtype=np.int64) - np.repeat(np.cumsum(n) - n, n)
    major, minor = n[seg], np.minimum(adx, ady)[seg]
    off = (2 * minor * i + major) // (2 * major)   # major > 0 wherever a step is drawn
    x_major = (adx > ady)[seg]
    sx, sy = np.sign(dx)[seg], np.sign(dy)[seg]
    px = x0[seg] + sx * np.where(x_major, i, off)
    py = y0[seg] + sy * np.where(x_major, off, i)
    return (np.concatenate([seg, np.arange(len(n), dtype=np.int64)]),
            np.concatenate([px, x1]), np.concatenate([py, y1]))


def _wide_spans(x0, y0, x1, y1, height: int, line_width: int):
    """(segment, y, xa, xb) of every horizontal run Pillow's wide line
    (ImagingDrawWideLine, then its polygon fill) hands its row filler, for
    segments of nonzero length: the quadrilateral x0 - dxmin, y0 + dymax /
    x1 - dxmin, y1 + dymax / x1 + dxmax, y1 - dymin / x0 + dxmax, y0 -
    dymin, its horizontal edges drawn whole, then each row from the
    polygon's top (at most height - 1, at least 0) to its bottom (at most
    height) crossed by its other edges in float32, x = (y - ey0) * dx +
    ex0, an edge's bottom row counted twice above the polygon's bottom,
    the crossings sorted and paired as runs ROUND_UP(left) ..
    ROUND_DOWN(right)."""
    n = len(x0)
    dx, dy = (x1 - x0).astype(np.float64), (y1 - y0).astype(np.float64)
    small = np.float64((line_width - 1) / 2.0)
    big = np.hypot(dx, dy)
    r_max, r_min = _round_up(small) / big, _round_down(small) / big
    dxmin, dxmax = _round_down(r_min * dy), _round_down(r_max * dy)
    dymin, dymax = _round_down(r_min * dx), _round_down(r_max * dx)
    vx = np.stack([x0 - dxmin, x1 - dxmin, x1 + dxmax, x0 + dxmax], axis=1)
    vy = np.stack([y0 + dymax, y1 + dymax, y1 - dymin, y0 - dymin], axis=1)
    ex0, ey0 = vx, vy
    ex1, ey1 = np.roll(vx, -1, axis=1), np.roll(vy, -1, axis=1)
    eymin, eymax = np.minimum(ey0, ey1), np.maximum(ey0, ey1)
    flat = eymin == eymax
    with np.errstate(divide="ignore", invalid="ignore"):
        edx = np.where(flat, np.float32(0),
                       (ex1 - ex0).astype(np.float32) / (ey1 - ey0).astype(np.float32))
    # the horizontal edges, each one run
    fs, fk = np.nonzero(flat)
    runs = [(fs, eymin[fs, fk], np.minimum(ex0, ex1)[fs, fk], np.maximum(ex0, ex1)[fs, fk])]
    # the scanlines
    top = np.maximum(np.minimum(height - 1, eymin.min(axis=1)), 0)
    bottom = np.minimum(np.maximum(0, eymax.max(axis=1)), height)
    rows = np.maximum(np.minimum(bottom, height - 1) - top + 1, 0)
    seg = np.repeat(np.arange(n, dtype=np.int64), rows)
    y = top[seg] + np.arange(len(seg), dtype=np.int64) - np.repeat(np.cumsum(rows) - rows, rows)
    xx = np.full((len(seg), 8), np.inf, dtype=np.float32)
    count = np.zeros(len(seg), dtype=np.int64)
    for k in range(4):
        lo, hi = eymin[seg, k], eymax[seg, k]
        on = ~flat[seg, k] & (lo <= y) & (y <= hi)
        x = (y - ey0[seg, k]).astype(np.float32) * edx[seg, k] + ex0[seg, k].astype(np.float32)
        twice = on & (y == hi) & (y < bottom[seg])
        xx[on, 2 * k] = x[on]
        xx[twice, 2 * k + 1] = x[twice]
        count += on.astype(np.int64) + twice
    xx.sort(axis=1)
    for p in range(4):
        ok = 2 * p + 1 < count
        runs.append((seg[ok], y[ok], _round_up(xx[ok, 2 * p]), _round_down(xx[ok, 2 * p + 1])))
    return tuple(np.concatenate(c) for c in zip(*runs))


def _run_pixels(seg, y, xa, xb, width: int):
    """(segment, x, y) of every pixel of the runs, as Pillow's row filler
    sets them: the ends swapped when reversed, then clipped to the row."""
    lo, hi = np.minimum(xa, xb), np.maximum(xa, xb)
    keep = (lo < width) & (hi >= 0)
    seg, y = seg[keep], y[keep]
    lo, hi = np.maximum(lo[keep], 0), np.minimum(hi[keep], width - 1)
    n = hi - lo + 1
    start = np.repeat(np.cumsum(n) - n, n)
    seg_px = np.repeat(seg, n)
    return seg_px, np.repeat(lo, n) + np.arange(len(seg_px), dtype=np.int64) - start, np.repeat(y, n)


def raster_segments(x0, y0, x1, y1, width: int, height: int,
                    line_width: int = 1) -> np.ndarray:
    """i64[height, width]: at each pixel the index of the last segment
    (x0, y0) - (x1, y1) that sets it, -1 where none does.  Pixel for pixel
    Pillow's ``ImageDraw.line(width=line_width)`` of each segment in index
    order, the end points truncated toward zero: at width 1 or less
    `_thin_pixels`; wider, `_wide_spans`' runs, and a zero-length segment
    is its one point."""
    x0, y0, x1, y1 = (np.trunc(np.asarray(v, dtype=np.float64)).astype(np.int64)
                      for v in (x0, y0, x1, y1))
    if line_width <= 1:
        seg, px, py = _thin_pixels(x0, y0, x1, y1)
    else:
        point = (x0 == x1) & (y0 == y1)
        idx = np.nonzero(~point)[0]
        spans = _wide_spans(x0[idx], y0[idx], x1[idx], y1[idx], height, line_width)
        seg, px, py = _run_pixels(idx[spans[0]], *spans[1:], width)
        pts = np.nonzero(point)[0]
        seg, px, py = (np.concatenate([seg, pts]), np.concatenate([px, x0[pts]]),
                       np.concatenate([py, y0[pts]]))
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    canvas = np.full(height * width, -1, dtype=np.int64)
    np.maximum.at(canvas, py[inside] * width + px[inside], seg[inside])
    return canvas.reshape(height, width)


def render_png(
    g: GraphTensors,
    coords: np.ndarray,
    width: int = 1000,
    color_by: str = "node",  # node | path
    border: float = 0.02,
    line_width: int = 1,
) -> np.ndarray:
    """The RGB uint8[H, width, 3] picture `draw_png` writes.

    coords: (2N, 2) endpoint array (layout.py / io.lay).
    """
    n = g.num_nodes
    xy = np.asarray(coords, dtype=np.float64)
    mn = xy.min(axis=0)
    mx = xy.max(axis=0)
    span = np.maximum(mx - mn, 1e-9)
    aspect = span[1] / span[0]
    height = max(16, int(width * aspect))
    pad = border * width
    scale = (width - 2 * pad) / span[0]
    scale_y = (height - 2 * pad) / span[1]
    s = min(scale, scale_y)
    pts = (xy - mn) * s + pad

    if color_by == "path":
        # color nodes by the first path that visits them
        node_color = np.full((n, 3), 70, dtype=np.uint8)
        ranks = handle_rank(g.step_handle)
        for p in range(g.num_paths - 1, -1, -1):
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            node_color[ranks[lo:hi]] = _PATH_COLORS[p % len(_PATH_COLORS)]
        colors = node_color
    else:
        colors = np.full((n, 3), 70, dtype=np.uint8)

    a = pts[0::2]
    b = pts[1::2]
    owner = raster_segments(a[:, 0], a[:, 1], b[:, 0], b[:, 1], width, height, line_width)
    img = np.full((height, width, 3), 255, dtype=np.uint8)
    hit = owner >= 0
    img[hit] = colors[owner[hit]]
    return img


def draw_png(
    g: GraphTensors,
    coords: np.ndarray,
    out_path: str,
    width: int = 1000,
    line_width: int = 1,
    color_by: str = "node",  # node | path
    border: float = 0.02,
) -> None:
    """Render the 2D layout to a PNG."""
    png.write(render_png(g, coords, width, color_by, border, line_width), out_path)


def draw_svg(
    g: GraphTensors,
    coords: np.ndarray,
    out,
    scale: float = 0.01,
    border: float = 100.0,
    line_width: float = 10.0,
    node_colors: Optional[np.ndarray] = None,   # uint8[N,3] or None
    node_labels: Optional[dict] = None,         # rank -> list[str]
    sparsification_factor: float = 0.0,
) -> None:
    """SVG rendering: one <line> per node between its layout endpoints,
    highlighted (colored) nodes drawn after the black base layer, plus
    optional text labels (reference: src/algorithms/draw.cpp:200-443
    draw_svg; viewBox from the scaled layout range plus border)."""
    close = False
    if isinstance(out, str):
        out = open(out, "w")
        close = True
    try:
        xy = np.asarray(coords, dtype=np.float64) * scale
        pad = border * scale
        mn = xy.min(axis=0) - pad
        mx = xy.max(axis=0) + pad
        w = mx[0] - mn[0]
        h = mx[1] - mn[1]
        out.write(
            f'<svg width="{w:.10g}" height="{h:.10g}" '
            f'viewBox="{mn[0]:.10g} {mn[1]:.10g} {w:.10g} {h:.10g}" '
            'xmlns="http://www.w3.org/2000/svg">\n'
        )
        n = g.num_nodes
        keep = np.ones(n, dtype=bool)
        if sparsification_factor > 0:
            rng = np.random.default_rng(9399220)
            keep = rng.random(n) >= sparsification_factor
            if node_labels:
                for r in node_labels:
                    keep[r] = True
        black = node_colors is None
        highlights = []
        for r in range(n):
            if not keep[r]:
                continue
            x1, y1 = xy[2 * r]
            x2, y2 = xy[2 * r + 1]
            if black or tuple(node_colors[r]) in ((0, 0, 0), (211, 211, 211)):
                color = (
                    "#000000"
                    if black or tuple(node_colors[r]) == (0, 0, 0)
                    else "#d3d3d3"
                )
                out.write(
                    f'<line x1="{x1:.10g}" x2="{x2:.10g}" y1="{y1:.10g}" '
                    f'y2="{y2:.10g}" stroke="{color}" '
                    f'stroke-width="{line_width * scale:.10g}"/>\n'
                )
            else:
                highlights.append(r)
        # colored nodes go on top of the black base (draw.cpp:285-300)
        for r in highlights:
            x1, y1 = xy[2 * r]
            x2, y2 = xy[2 * r + 1]
            c = node_colors[r]
            out.write(
                f'<line x1="{x1:.10g}" x2="{x2:.10g}" y1="{y1:.10g}" '
                f'y2="{y2:.10g}" stroke="#{c[0]:02x}{c[1]:02x}{c[2]:02x}" '
                f'stroke-width="{line_width * scale:.10g}"/>\n'
            )
        if node_labels:
            fs = max(w, h) / 50.0
            for r, texts in sorted(node_labels.items()):
                x, y = xy[2 * r]
                for k, t in enumerate(texts):
                    out.write(
                        f'<text x="{x:.10g}" y="{y + k * fs:.10g}" '
                        f'font-size="{fs:.10g}" font-family="monospace">'
                        f"{t}</text>\n"
                    )
        out.write("</svg>\n")
    finally:
        if close:
            out.close()


def bed_node_colors(g: GraphTensors, bed_path: str) -> Optional[np.ndarray]:
    """uint8[N,3] node colors from BED intervals over paths (reference:
    draw_main.cpp -b: nodes inside an interval take the interval's color;
    column 4 names pick categorical colors, column 9 itemRgb wins)."""
    colors = np.zeros((g.num_nodes, 3), dtype=np.uint8)  # black base
    name_color = {}
    hit = False
    with open(bed_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            vals = line.split("\t")
            try:
                p = g.path_names.index(vals[0])
            except ValueError:
                continue
            start = int(vals[1]) if len(vals) > 1 else 0
            end = int(vals[2]) if len(vals) > 2 else int(g.path_length[p])
            if len(vals) > 8 and vals[8]:
                rgb = tuple(int(v) for v in vals[8].split(",")[:3])
            else:
                name = vals[3] if len(vals) > 3 else vals[0]
                if name not in name_color:
                    name_color[name] = tuple(
                        int(v) for v in _PATH_COLORS[len(name_color) % len(_PATH_COLORS)]
                    )
                rgb = name_color[name]
            lo, hi = int(g.path_offset[p]), int(g.path_offset[p + 1])
            offs = g.step_pos[lo:hi]
            ranks = handle_rank(g.step_handle[lo:hi])
            lens = g.node_len[ranks]
            inside = (offs < end) & (offs + lens > start)
            colors[ranks[inside]] = rgb
            hit = True
    return colors if hit else None
