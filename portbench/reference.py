"""The plain reference of the benchmark's jobs (numpy and plain PyTorch).

It imports nothing of the program.  From the graph's fields and a job's
seed it works out the whole job again:

- ``layout``: ``odgi layout`` at its defaults: the initial coordinates
  (X the cumulative bp of each endpoint, Y gaussian of sd sqrt(2N) from
  ``default_rng(seed)``), 2D path-guided SGD, and the weakly connected
  components stacked with a border of 1000;
- ``sort_ygs``: ``odgi sort -p Ygs``: 1D path-guided SGD from the node
  offsets, the order by (component, X, rank), groom (re-orient nodes to
  the strand a walk from the heads first meets) and the topological order
  from the heads.

The SGD is the strata scheme, plainly: step slots hold replica
coordinates in f32 (``base`` at the last merge, ``drift`` since); a merge
group runs its chunks (``plan.py``), one conflict level at a time, each
chunk's pairs reading both windows, then adding into the A window, then
into the B window; the group ends in a consensus merge that sums each
endpoint's drift in ascending slot order, scales it by 1/R (R the node's
visits) and adds it into the node coordinates, then into every slot's base.
``acc_dtype`` is the precision of the sums and node coordinates: float64
as the configuration states, float32 for the control.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from . import plan as pl
from .graphgen import reorder as apply_ordering

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The chunk phase
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _coin_bits(gl: torch.Tensor) -> tuple:
    """Bit 0 of each pair's two coin words, (chunks, CHUNK) each, for the
    global chunk indices `gl`: a splitmix-style hash of the pair index and
    the chunk key gl * 1000003 (mod 2**32)."""
    i = torch.arange(pl.CHUNK, dtype=torch.int64, device=gl.device)
    key = _mul32(_mul32(gl & M32, 1000003), 0xBB67AE85)
    h0 = (_mul32(i, 0x9E3779B9)[None, :] + key[:, None]) & M32
    out = []
    for sel in (0, 1):
        h = (h0 + sel * 0x6A09E667) & M32
        h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
        h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
        out.append(((h ^ (h >> 16)) & 1) == 0)
    return out[0], out[1]


class Strata:
    """One strata run's state on `device`: graph planes, base and drift,
    the merge's slot lists and the node coordinates."""

    def __init__(self, f: dict, p: dict, one_d: bool, device, acc_dtype):
        self.p, self.one_d, self.dev, self.acc = p, one_d, device, acc_dtype
        S, L = len(f["step_handle"]), p["L"]
        handle = f["step_handle"].astype(np.int64)
        node = handle >> 1
        n = len(f["node_len"])
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
        pos = np.zeros(L, np.int64)
        pos[:S] = f["step_pos"]
        path = np.full(L, -1, np.int64)
        path[:S] = np.repeat(np.arange(len(f["path_offset"]) - 1), np.diff(f["path_offset"]))
        self.pos0, self.path = t(pos, torch.int32), t(path, torch.int32)
        if not one_d:
            pos1 = np.zeros(L, np.int64)
            pos1[:S] = f["step_pos"] + f["node_len"][node]
            self.pos1 = t(pos1, torch.int32)
        self.o = t(p["o"], torch.int64) * pl.LANE
        self.d = t(p["d"], torch.int64)
        self.eta = t(p["eta"], torch.float32)
        self.lvl = pl.levels(p)
        # The merge: each endpoint's slots in ascending order, padded to the
        # longest list.
        key = node if one_d else handle
        E = n if one_d else 2 * n
        count = np.bincount(key, minlength=E)
        order = np.argsort(key, kind="stable")
        start = np.zeros(E + 1, np.int64)
        np.cumsum(count, out=start[1:])
        rows = key[order]
        lists = np.full((E, max(int(count.max()), 1)), L - 1, np.int64)  # L - 1: a pad slot
        lists[rows, np.arange(S) - start[rows]] = order
        self.lists, self.count = t(lists, torch.int64), t(count, torch.int64)
        visits = np.bincount(node, minlength=n).astype(np.float64)
        if not one_d:
            visits = np.repeat(visits, 2)
        self.recip = t(np.where(visits > 0, 1.0 / np.maximum(visits, 1), 0.0), acc_dtype)
        ep = np.full(L, E, np.int64)
        ep[:S] = key
        self.ep = t(ep, torch.int64)
        self.E = E

    def start(self, init: np.ndarray, node: np.ndarray) -> None:
        """Base and node coordinates from `init`: (2N, 2) f64 for 2D, (N,)
        f32 positions for 1D."""
        L, S = self.p["L"], len(node)
        if self.one_d:
            x32 = np.asarray(init, np.float32)
            base = np.zeros((1, L), np.float32)
            base[0, :S] = x32[node]
            coords = x32.astype(np.float64)[None, :]
        else:
            c = np.asarray(init, np.float64)
            c32 = c.astype(np.float32)
            ep = self.ep[:S].cpu().numpy()
            base = np.zeros((4, L), np.float32)
            base[0, :S], base[1, :S] = c32[ep, 0], c32[ep ^ 1, 0]
            base[2, :S], base[3, :S] = c32[ep, 1], c32[ep ^ 1, 1]
            coords = c.T
        self.base = torch.as_tensor(base, device=self.dev)
        self.drift = torch.zeros_like(self.base)
        self.coords = torch.as_tensor(np.ascontiguousarray(coords), device=self.dev).to(self.acc)

    def chunks_2d(self, gl: torch.Tensor) -> None:
        """One conflict level's chunks `gl`, in place on drift."""
        L = self.p["L"]
        a = self.o[gl][:, None] + torch.arange(pl.CHUNK, device=self.dev)
        b = a + self.d[gl][:, None]
        caf, cbf = _coin_bits(gl)
        lr = self.eta[gl // self.p["cpi"]][:, None]
        va = self.base[:, a] + self.drift[:, a]
        vb = self.base[:, b] + self.drift[:, b]
        pos_a = torch.where(caf, self.pos0[a], self.pos1[a])
        pos_b = torch.where(cbf, self.pos0[b], self.pos1[b])
        xa, ya = torch.where(caf, va[0], va[1]), torch.where(caf, va[2], va[3])
        xb, yb = torch.where(cbf, vb[0], vb[1]), torch.where(cbf, vb[2], vb[3])
        valid = (self.path[a] == self.path[b]) & (self.path[a] >= 0)
        term = torch.clamp_min((pos_a - pos_b).abs().to(torch.float32), 1e-9)
        mu = torch.clamp_max(lr / term, 1.0)
        dx = xa - xb
        dx = torch.where(dx == 0.0, 1e-9, dx)
        dy = ya - yb
        mag = torch.sqrt((dx * dx + dy * dy).to(torch.float64)).to(torch.float32)
        delta = mu * (mag - term) * 0.5
        r = torch.where(valid, delta / mag, 0.0)
        rx, ry = r * dx, r * dy
        flat = self.drift.view(-1)
        side_a, side_b = (~caf).long(), (~cbf).long()
        flat.index_add_(0, (side_a * L + a).view(-1), (-rx).view(-1))
        flat.index_add_(0, ((side_a + 2) * L + a).view(-1), (-ry).view(-1))
        flat.index_add_(0, (side_b * L + b).view(-1), rx.view(-1))
        flat.index_add_(0, ((side_b + 2) * L + b).view(-1), ry.view(-1))

    def chunks_1d(self, gl: torch.Tensor) -> None:
        a = self.o[gl][:, None] + torch.arange(pl.CHUNK, device=self.dev)
        b = a + self.d[gl][:, None]
        lr = self.eta[gl // self.p["cpi"]][:, None]
        d0, b0 = self.drift[0], self.base[0]
        xa, xb = b0[a] + d0[a], b0[b] + d0[b]
        di = self.pos0[a] - self.pos0[b]
        valid = (self.path[a] == self.path[b]) & (self.path[a] >= 0) & (di != 0)
        term = di.abs().to(torch.float32)
        w = torch.ones_like(term) / torch.clamp_min(term, 1e-30)
        mu = torch.clamp_max(lr * w, 1.0)
        dx = xa - xb
        dx = torch.where(dx == 0.0, 1e-9, dx)
        mag = dx.abs()
        delta = mu * (mag - term) * 0.5
        rr = torch.where(valid, delta / mag * dx, 0.0)
        d0.index_add_(0, a.view(-1), (-rr).view(-1))
        d0.index_add_(0, b.view(-1), rr.view(-1))

    def _sums(self, planes: torch.Tensor, flip: int) -> torch.Tensor:
        """Per endpoint e, the slot list of endpoint e ^ flip summed in
        order, in acc_dtype, for each of the planes (k, L) f32."""
        rows = torch.arange(self.E, device=self.dev) ^ flip
        vals = planes[:, self.lists[rows]].to(self.acc)   # (k, E, width)
        n = self.count[rows]
        acc = torch.zeros(vals.shape[:2], dtype=self.acc, device=self.dev)
        for k in range(vals.shape[2]):
            acc = torch.where(n > k, acc + vals[:, :, k], acc)
        return acc

    def merge(self) -> None:
        if self.one_d:
            acc = self._sums(self.drift, 0)
        else:
            acc = self._sums(self.drift[0::2], 0) + self._sums(self.drift[1::2], 1)
        upd = acc * self.recip
        self.coords += upd
        up = torch.cat([upd, torch.zeros((upd.shape[0], 2), dtype=self.acc, device=self.dev)], 1)
        if self.one_d:
            self.base[0] += up[0][self.ep].to(torch.float32)
        else:
            epr = self.ep ^ 1   # pad slots: E ^ 1 = E + 1, also 0
            self.base[0] += up[0][self.ep].to(torch.float32)
            self.base[1] += up[0][epr].to(torch.float32)
            self.base[2] += up[1][self.ep].to(torch.float32)
            self.base[3] += up[1][epr].to(torch.float32)
        self.drift.zero_()

    def run(self) -> torch.Tensor:
        p = self.p
        chunks = self.chunks_1d if self.one_d else self.chunks_2d
        for g in range(p["groups"]):
            lv = self.lvl[g]
            order = np.argsort(lv, kind="stable")
            bounds = np.searchsorted(lv[order], np.arange(1, int(lv.max()) + 2))
            gl = torch.as_tensor(order + g * p["cgs"], device=self.dev)
            for i in range(len(bounds) - 1):
                chunks(gl[bounds[i]:bounds[i + 1]])
            self.merge()
        return self.coords


# ---------------------------------------------------------------------------
# Graph passes (numpy)
# ---------------------------------------------------------------------------


def components(f: dict) -> np.ndarray:
    """Weakly connected component of every node, numbered by the mean
    external id of their nodes (union-find by min label, pointer jumping)."""
    n = len(f["node_len"])
    u, v = f["edge_from"] >> 1, f["edge_to"] >> 1
    lab = np.arange(n, dtype=np.int64)
    while True:
        lu, lv = lab[u], lab[v]
        lo, hi = np.minimum(lu, lv), np.maximum(lu, lv)
        if not (lo != hi).any():
            break
        np.minimum.at(lab, hi, lo)
        while True:
            nxt = lab[lab]
            if np.array_equal(nxt, lab):
                break
            lab = nxt
    roots, comp = np.unique(lab, return_inverse=True)
    mean = np.bincount(comp, weights=f["node_id"].astype(np.float64)) / np.bincount(comp)
    rank = np.empty(len(roots), np.int64)
    rank[np.argsort(mean, kind="stable")] = np.arange(len(roots))
    return rank[comp]


def init_layout(f: dict, seed: int) -> np.ndarray:
    n = len(f["node_len"])
    rng = np.random.default_rng(seed)
    c = np.zeros((2 * n, 2), np.float64)
    starts = f["seq_offset"][:-1].astype(np.float64)
    c[0::2, 0] = starts
    c[1::2, 0] = starts + f["node_len"]
    c[:, 1] = rng.normal(0, np.sqrt(2.0 * n), 2 * n)
    return c


def pack(f: dict, coords: np.ndarray, border: float = 1000.0) -> np.ndarray:
    """Components stacked vertically, each moved to x = border."""
    comp = np.repeat(components(f), 2)
    k = int(comp.max()) + 1
    lo = np.full((k, 2), np.inf)
    hi = np.full(k, -np.inf)
    np.minimum.at(lo, comp, coords)
    np.maximum.at(hi, comp, coords[:, 1])
    shift = np.empty(k)
    y = border
    for c in range(k):
        shift[c] = y - lo[c, 1]
        y += (hi[c] - lo[c, 1]) + border
    out = np.array(coords, np.float64)
    out[:, 0] -= (lo[:, 0] - border)[comp]
    out[:, 1] += shift[comp]
    return out


def _adjacency(f: dict) -> tuple:
    n2 = 2 * len(f["node_len"])
    src = np.concatenate([f["edge_from"], f["edge_to"] ^ 1])
    dst = np.concatenate([f["edge_to"], f["edge_from"] ^ 1])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    off = np.zeros(n2 + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n2), out=off[1:])
    return off, dst[np.argsort(src, kind="stable")]


def groom(f: dict) -> dict:
    """Flip every node first reached on its reverse strand by a depth-first
    walk from the head nodes (then from the lowest unvisited node)."""
    n = len(f["node_len"])
    off, tgt = _adjacency(f)
    heads = np.nonzero(np.diff(off)[1::2] == 0)[0]
    seen = np.zeros(n, bool)
    flip = np.zeros(n, bool)
    stack = [int(r) << 1 for r in heads[::-1]]
    while True:
        while stack:
            h = stack.pop()
            if seen[h >> 1]:
                continue
            seen[h >> 1] = True
            flip[h >> 1] = bool(h & 1)
            for nb in tgt[off[h]:off[h + 1]]:
                if not seen[nb >> 1]:
                    stack.append(int(nb))
        rest = np.nonzero(~seen)[0]
        if not len(rest):
            break
        stack = [int(rest[0]) << 1]
    if not flip.any():
        return f
    seq = f["seq"].copy()
    comp = np.zeros(256, np.uint8)
    comp[:] = np.arange(256)
    for x, y in (b"AT", b"TA", b"CG", b"GC", b"at", b"ta", b"cg", b"gc"):
        comp[x] = y
    for r in np.nonzero(flip)[0]:
        lo, hi = f["seq_offset"][r], f["seq_offset"][r + 1]
        seq[lo:hi] = comp[f["seq"][lo:hi][::-1]]
    re = lambda h: np.where(flip[h >> 1], h ^ 1, h)
    return dict(f, seq=seq, edge_from=re(f["edge_from"]), edge_to=re(f["edge_to"]),
                step_handle=re(f["step_handle"]))


def topological_order(f: dict) -> np.ndarray:
    """Kahn's order from the head nodes over the bidirected graph, edges
    into visited nodes masked, the lowest rank first at every choice."""
    n = len(f["node_len"])
    off, tgt = _adjacency(f)
    nbrs = lambda h: tgt[off[h]:off[h + 1]]
    key = lambda a, b: min((a, b), (b ^ 1, a ^ 1))
    heads = np.nonzero(np.diff(off)[1::2] == 0)[0]
    ready, seeds, unvisited = [], [], set(range(n))
    in_ready, in_seeds = set(), set()

    def push(heap, members, x):
        if x not in members:
            members.add(x)
            heapq.heappush(heap, x)

    def pop(heap, members):
        while True:
            x = heapq.heappop(heap)
            if x in members:
                members.remove(x)
                return x

    for r in heads:
        push(ready, in_ready, int(r))
    unvisited -= in_ready
    unv_heap = sorted(unvisited)
    masked, out = set(), []
    while unvisited or in_ready:
        while not in_ready and in_seeds:
            s = pop(seeds, in_seeds)
            if s in unvisited:
                push(ready, in_ready, s)
                unvisited.discard(s)
        if not in_ready:
            while unv_heap[0] not in unvisited:
                heapq.heappop(unv_heap)
            r = heapq.heappop(unv_heap)
            unvisited.discard(r)
            push(ready, in_ready, r)
        while in_ready:
            i = pop(ready, in_ready)
            h = i << 1
            out.append(i)
            for nb in nbrs(h ^ 1):
                prev = int(nb) ^ 1
                if (prev >> 1) not in unvisited:
                    masked.add(key(prev, h))
            for nxt in nbrs(h):
                nxt = int(nxt)
                k = key(h, nxt)
                if k in masked:
                    continue
                masked.add(k)
                nr = nxt >> 1
                if nr in unvisited:
                    if not any(key(int(pb) ^ 1, nxt) not in masked for pb in nbrs(nxt ^ 1)):
                        push(ready, in_ready, nr)
                        unvisited.discard(nr)
                    else:
                        push(seeds, in_seeds, nr)
    return np.asarray(out, np.int64)


# ---------------------------------------------------------------------------
# The jobs
# ---------------------------------------------------------------------------


def sgd(f: dict, cfg: pl.Config, init: np.ndarray, one_d: bool, device,
        acc_dtype=torch.float64) -> np.ndarray:
    """Path-guided SGD from `init`: (2N, 2) f64 coordinates for 2D, (N,)
    f64 positions for 1D."""
    st = Strata(f, pl.plan(f, cfg, one_d), one_d, device, acc_dtype)
    st.start(init, f["step_handle"].astype(np.int64) >> 1)
    c = st.run().to(torch.float64).cpu().numpy()
    return c[0] if one_d else np.ascontiguousarray(c.T)


def layout(f: dict, seed: int, device, acc_dtype=torch.float64) -> np.ndarray:
    c = sgd(f, pl.derive_2d(f, seed), init_layout(f, seed), False, device, acc_dtype)
    return pack(f, c)


def sort_ygs(f: dict, seed: int, device, acc_dtype=torch.float64) -> dict:
    """The sorted graph's fields; its "x" is the 1D positions of Y."""
    x0 = f["seq_offset"][:-1].astype(np.float32)
    x = sgd(f, pl.derive_1d(f, seed), x0, True, device, acc_dtype)
    order = np.lexsort((np.arange(len(x)), x, components(f)))
    g = groom(apply_ordering(f, order))
    out = apply_ordering(g, topological_order(g))
    out["x"] = x
    return out
