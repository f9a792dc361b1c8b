"""The legacy stress-SGD layout of ``odgi layout0``, the counterpart of
``odgi_tpu/algorithms/layout0.py``.

Graph-distance SGD (Zheng, Pawar and Goodman, "Graph Drawing by
Stochastic Gradient Descent"): the terms are (i, j, d_ij) with d_ij the
unweighted BFS distance between nodes (all pairs, or from a pivot
subset), weights w = d^-2, and a learning rate that falls geometrically
from 1 / w_min to eps / w_max.  Each weak component is laid out on its own
and the components are packed along x with padding.

Host code over numpy, with ``odgi_tpu``'s random stream
(``np.random.default_rng(seed)``), chunks (``np.array_split``) and
accumulation order (``np.add.at``): the coordinates equal its own bit for
bit, and so do the SVG's bytes.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, TextIO, Tuple

import numpy as np

from ..core.graph import GraphTensors
from .components import weak_components


def _bfs_dists(adj_nodes: List[np.ndarray], src: int, n: int) -> np.ndarray:
    d = np.full(n, -1, dtype=np.int64)
    d[src] = 0
    q = deque([src])
    while q:
        u = q.popleft()
        for v in adj_nodes[u]:
            if d[v] < 0:
                d[v] = d[u] + 1
                q.append(v)
    return d


def _component_terms(
    adj_nodes: List[np.ndarray], members: np.ndarray, pivots: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(I, J, D) term arrays in local node indexing."""
    n = len(members)
    local = {int(m): i for i, m in enumerate(members)}
    ladj = [
        np.asarray([local[int(v)] for v in adj_nodes[int(m)] if int(v) in local])
        for m in members
    ]
    srcs = range(n)
    if pivots and pivots < n:
        # max-min pivot sampling (sgd2 sparse layout)
        chosen = [0]
        dist_to_p = _bfs_dists(ladj, 0, n)
        for _ in range(pivots - 1):
            nxt = int(np.argmax(dist_to_p))
            chosen.append(nxt)
            dist_to_p = np.minimum(dist_to_p, _bfs_dists(ladj, nxt, n))
        srcs = chosen
    I, J, D = [], [], []
    for s in srcs:
        d = _bfs_dists(ladj, int(s), n)
        for j in range(n):
            if j == s or d[j] <= 0:
                continue
            if pivots == 0 and j <= s:
                continue  # all-pairs: each unordered pair once
            I.append(int(s))
            J.append(j)
            D.append(int(d[j]))
    return (
        np.asarray(I, dtype=np.int64),
        np.asarray(J, dtype=np.int64),
        np.asarray(D, dtype=np.float64),
    )


def sgd_layout(
    g: GraphTensors,
    pivots: int = 0,
    t_max: int = 30,
    eps: float = 0.01,
    x_padding: float = 10.0,
    seed: Optional[int] = 42,
) -> np.ndarray:
    """Returns (N, 2) node-center coordinates."""
    n = g.num_nodes
    layout = np.zeros((n, 2), dtype=np.float64)
    rng = np.random.default_rng(seed)
    # node-level adjacency (ignore orientation)
    adj_nodes: List[np.ndarray] = [np.empty(0, np.int64)] * n
    if g.num_edges:
        a = (g.edge_from >> 1).astype(np.int64)
        b = (g.edge_to >> 1).astype(np.int64)
        src = np.concatenate([a, b])
        dst = np.concatenate([b, a])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=n)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        adj_nodes = [dst[offs[i] : offs[i + 1]] for i in range(n)]

    max_x = 0.0
    for members in weak_components(g):
        members = np.sort(members)
        cn = len(members)
        X = rng.random((cn, 2))
        I, J, D = _component_terms(adj_nodes, members, pivots)
        if len(I):
            w = 1.0 / (D * D)
            w_min, w_max = float(w.min()), float(w.max())
            eta_max = 1.0 / w_min
            eta_min = eps / w_max
            lam = np.log(eta_max / eta_min) / max(1, t_max - 1)
            for t in range(t_max):
                eta = eta_max * np.exp(-lam * t)
                perm = rng.permutation(len(I))
                # conflict-free-ish batched updates: apply in chunks with
                # scatter-add of deltas (mean merge keeps it stable)
                for chunk in np.array_split(perm, max(1, len(perm) // 4096)):
                    i, j, d = I[chunk], J[chunk], D[chunk]
                    mu = np.minimum(w[chunk] * eta, 1.0)
                    dxy = X[i] - X[j]
                    mag = np.maximum(np.sqrt((dxy * dxy).sum(1)), 1e-9)
                    r = (mu * (mag - d) / (2.0 * mag))[:, None] * dxy
                    accum = np.zeros_like(X)
                    cnt = np.zeros(cn)
                    np.add.at(accum, i, -r)
                    np.add.at(accum, j, r)
                    np.add.at(cnt, i, 1.0)
                    np.add.at(cnt, j, 1.0)
                    X += accum / np.maximum(cnt, 1.0)[:, None]
        X[:, 0] -= X[:, 0].min() if cn else 0.0
        layout[members, 0] = X[:, 0] + max_x
        layout[members, 1] = X[:, 1]
        max_x = max(max_x, float((X[:, 0] + max_x).max()) if cn else max_x)
        max_x += x_padding
    return layout


def draw_svg(
    out: TextIO, layout: np.ndarray, g: GraphTensors, scale: float = 5.0
) -> None:
    """Minimal SVG: one line segment per edge between node centers."""
    xy = np.asarray(layout, dtype=np.float64) * scale
    if len(xy) == 0:
        out.write('<svg xmlns="http://www.w3.org/2000/svg"/>\n')
        return
    mn = xy.min(0) - 10.0
    mx = xy.max(0) + 10.0
    w, h = mx - mn
    out.write(
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'viewBox="{mn[0]:.2f} {mn[1]:.2f} {w:.2f} {h:.2f}">\n'
    )
    out.write('<g stroke="#000" stroke-width="1" stroke-linecap="round">\n')
    for a, b in zip(g.edge_from >> 1, g.edge_to >> 1):
        x1, y1 = xy[int(a)]
        x2, y2 = xy[int(b)]
        out.write(
            f'<line x1="{x1:.2f}" y1="{y1:.2f}" x2="{x2:.2f}" y2="{y2:.2f}"/>\n'
        )
    out.write("</g>\n</svg>\n")
