"""2D layout pictures: the ``odgi draw`` model, the counterpart of
``odgi_tpu/algorithms/draw.py``, drawn without PIL.

One line segment a node, between its two layout endpoints.  `draw_svg`
writes one ``<line>`` each; `draw_png` rasterizes every segment at once as
Pillow's ``ImageDraw.line(width=1)`` does one at a time (the coordinates
truncated to integers, Bresenham's line with its end point), the segment
of the highest node rank winning a pixel that several set, as
``odgi_tpu``'s drawing order does, and writes the PNG through
``io/png.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.graph import GraphTensors, handle_rank
from ..io import png
from .viz import _PATH_COLORS


def raster_segments(x0, y0, x1, y1, width: int, height: int) -> np.ndarray:
    """i64[height, width]: at each pixel the index of the last segment
    (x0, y0) - (x1, y1) that sets it, -1 where none does.  Pixel for pixel
    Pillow's ``ImageDraw.line(width=1)`` of each segment in index order:
    the end points truncated toward zero, the major axis stepped
    max(|dx|, |dy|) times with the error term 2 * minor - major (in closed
    form: the minor offset after i steps is (2 * minor * i + major) //
    (2 * major)), then the end point."""
    x0, y0, x1, y1 = (np.trunc(np.asarray(v, dtype=np.float64)).astype(np.int64)
                      for v in (x0, y0, x1, y1))
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
    px = np.concatenate([px, x1])
    py = np.concatenate([py, y1])
    seg = np.concatenate([seg, np.arange(len(n), dtype=np.int64)])
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
    owner = raster_segments(a[:, 0], a[:, 1], b[:, 0], b[:, 1], width, height)
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
    """Render the 2D layout to a PNG (1-pixel lines only)."""
    if line_width > 1:
        raise NotImplementedError("draw_png draws 1-pixel lines only")
    png.write(render_png(g, coords, width, color_by, border), out_path)


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
