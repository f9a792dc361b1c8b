#!/usr/bin/env python3
"""The leveled chunk phase's designs, timed on chip_smoke.py's graphs.

    python3 tools/levels_variants.py [--reps 3] [--groups 3] [--graphs smoke,xl,big]

On chip_smoke.py's smoke, XL and 1M-node graphs (as generated, node ids
shuffled; a plan depends on the paths' steps, not on the node order), 1D and
2D, at the main path's default schedules, this measures on the card:
  - ``groups``: the first --groups merge groups of the full plan, each from
    a zero drift, through
      ``levels``: strata_chunks_*_levels as the package builds it (2D:
        clusters of 4 blocks of 1024 threads; 1D: 1 block of 1024);
      ``c<C>_t<T>``: the same kernel compiled here at cluster sizes C and
        block widths T (VARIANTS);
    in alternating rounds, each launch behind chip_smoke.py's spin kernel;
    every variant must give the drift of ``levels`` bit for bit;
  - ``width``: one level of N slot-disjoint chunks of the plan (picked in
    order, N = 37, 49, 132, 137, 264 where the planes hold that many), one
    chunk's latency against the level's width, through ``levels`` and the
    variants;
  - ``bytes``: what a chunk reads, as 32-byte sectors (2D: the coin picks
    one of two planes a pair, so a warp pulls both planes' sectors of pos /
    pos_end, base and drift) and as the words its pairs use.
With ``--host-parent DIR`` (a checkout of an earlier commit of this repo)
it also times, on this machine's CPU, that checkout's host level build
(``chunk_levels`` of DIR/odgi_tpu_torch/ops/strata_levels.py) against
``chunk_schedule`` (levels and predecessors, in C++) and
``chunk_schedule_numpy`` on each graph's 1D and 2D
plans and on the XL graph's 4-device stacked plan (the sharded path's), in
turns (old, new, numpy, numpy, new, old): one ``host_schedule`` line a
plan, the builds' perm and level offsets held equal.
Prints one JSON line a graph and dimension (every time in ms), then the
card's name and power limit; exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import odgi_tpu_torch as ot  # noqa: E402
from odgi_tpu_torch.ops import kernels, strata_levels, strata_plan, strata_sgd  # noqa: E402
from odgi_tpu_torch.ops.sgd import derive_config_1d, derive_config_2d  # noqa: E402

# (C, T): cluster size and block width of the leveled kernel's variants.
SHAPES = ((1, 1024), (2, 512), (2, 1024), (4, 256), (4, 1024))
WIDTHS = (37, 49, 132, 137, 264)

VARIANTS = r"""
#include "strata_levels.cu"

#define VARIANT(I, C, T)                                                                    \
  extern "C" int levels_variant_##C##_##T(int one_d, void* drift, const void* base,         \
                                          const void* planes, long long L, const void* od,  \
                                          const void* eta, int cpi, const void* perm,       \
                                          const void* lvl_off, int nlev,                    \
                                          const void* pred_off, const void* pred,           \
                                          void* flow, unsigned epoch, void* stream) {       \
    const void* fn = one_d ? (const void*)strata_chunks_1d_levels_kernel<C, T, false>      \
                           : (const void*)strata_chunks_2d_levels_kernel<C, T, false>;     \
    return launch_clusters(fn, C, T, 4 + 2 * I + one_d, drift, base, planes, L, od, eta,    \
                           cpi, perm, lvl_off, nlev, pred_off, pred, flow, epoch, nullptr,  \
                           stream);                                                         \
  }                                                                                         \
  extern "C" int levels_variant_clusters_##C##_##T(int one_d) {                             \
    const void* fn = one_d ? (const void*)strata_chunks_1d_levels_kernel<C, T, false>      \
                           : (const void*)strata_chunks_2d_levels_kernel<C, T, false>;     \
    int n = 0;                                                                              \
    return max_clusters(fn, C, T, 4 + 2 * I + one_d, &n) == 0 ? n : 0;                      \
  }
"""

P, I = ctypes.c_void_p, ctypes.c_int


def variants_source() -> str:
    return VARIANTS + "".join(f"VARIANT({i}, {c}, {t})\n" for i, (c, t) in enumerate(SHAPES))


def build_variants(out_dir: str) -> subprocess.Popen:
    """Start nvcc on the variants (csrc/strata_levels.cu included, its flags);
    `load_variants` waits for it."""
    src = os.path.join(out_dir, "levels_variants.cu")
    with open(src, "w") as f:
        f.write(variants_source())
    so = os.path.join(out_dir, "levels_variants.so")
    return subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                             "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def load_variants(proc: subprocess.Popen, out_dir: str):
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc levels_variants.cu ({proc.returncode}):\n{err}")
    lib = ctypes.CDLL(os.path.join(out_dir, "levels_variants.so"))
    for c, t in SHAPES:
        fn = getattr(lib, f"levels_variant_{c}_{t}")
        fn.argtypes = [I, *kernels.SIGNATURES["strata_chunks_2d_levels"][:-2], P]
        fn.restype = I
        q = getattr(lib, f"levels_variant_clusters_{c}_{t}")
        q.argtypes = [I]
        q.restype = I
    lib.ptxas = out + err
    return lib


def variant(lib, c: int, t: int):
    """A launcher of variant (c, t) with the leveled wrapper's arguments."""
    fn = getattr(lib, f"levels_variant_{c}_{t}")

    def run(st, drift, perm, row, pred_off, pred):
        flow, epoch = kernels._flow(drift.device, st.od.shape[0])
        err = fn(int(st.one_d), kernels._ptr(drift), kernels._ptr(st.base),
                 kernels._ptr(st.planes), drift.shape[1], kernels._ptr(st.od),
                 kernels._ptr(st.eta), int(st.plan["cpi"]), kernels._ptr(perm),
                 kernels._ptr(row), int(row.shape[0] - 1), kernels._ptr(pred_off),
                 kernels._ptr(pred), kernels._ptr(flow), epoch, kernels._stream(drift.device))
        if err != 0:
            raise RuntimeError(f"levels_variant_{c}_{t}: CUDA error {err}")
    return run


def designs(lib, st) -> dict:
    """name -> fn(st, drift, perm, row, pred_off, pred)."""
    new = getattr(kernels, cs.LEVELS[st.one_d])
    p = st.plan
    out = {
        "levels": lambda st, d, perm, row, po, pr: new(d, st.base, st.planes, st.od, st.eta,
                                                       p["cpi"], perm, row, po, pr),
    }
    for c, t in SHAPES:
        out[f"c{c}_t{t}"] = variant(lib, c, t)
    return out


def disjoint_chunks(p: dict, n: int):
    """Global indices of n chunks of plan `p` whose footprints share no
    128-slot block, picked in index order; None if the planes hold fewer."""
    L_blocks = p["data"].num_slots // strata_plan.LANE
    used = np.zeros(L_blocks + 2 * strata_plan.RC + 2, bool)
    fps = strata_levels._footprints(p["o_blk"].astype(np.int64), p["d_arr"].astype(np.int64))
    picked = []
    for j, fp in enumerate(fps):
        if not used[fp].any():
            used[fp] = True
            picked.append(j)
            if len(picked) == n:
                return np.asarray(picked, np.int64)
    return None


def chunk_bytes(one_d: bool) -> dict:
    """Bytes one chunk reads: 32-byte sectors pulled (whole warps) and the
    words its pairs use; and the bytes it writes (sectors)."""
    slots = 2 * strata_plan.CHUNK
    if one_d:  # pos, path, base, drift: one word each, all used
        return dict(sector_bytes=slots * 16, used_bytes=slots * 16, write_sector_bytes=slots * 4)
    # pos and pos_end (coin), path, base and drift (4 planes, coin picks 2)
    return dict(sector_bytes=slots * 44, used_bytes=slots * 24, write_sector_bytes=slots * 16)


def time_rounds(runs: dict, reps: int) -> dict:
    """Each design's launches, alternating rounds (forward, then back)."""
    names = list(runs)
    ms = {k: [] for k in names}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            ms[k].append(runs[k]())
    return {k: dict(mean=sum(v) / len(v), min=min(v), ms=v) for k, v in ms.items()}


def measure(lib, st, label: str, n_groups: int, reps: int) -> dict:
    dev = st.drift.device
    zero = torch.zeros_like(st.drift)
    ds = designs(lib, st)
    work = {k: torch.empty_like(zero) for k in ds}
    out = dict(graph=label, dim="1d" if st.one_d else "2d", cgs=int(st.plan["cgs"]),
               groups_timed=n_groups, bytes=chunk_bytes(st.one_d),
               clusters={f"c{c}_t{t}": int(getattr(lib, f"levels_variant_clusters_{c}_{t}")(
                   int(st.one_d))) for c, t in SHAPES},
               levels_clusters=kernels.levels_clusters(st.one_d))

    def launcher(k, perm, row, po, pr):
        def run():
            work[k].copy_(zero)
            return cs.timed(ds[k], st, work[k], perm, row, po, pr)
        return run

    groups = []
    for gid in range(n_groups):
        row = st.lvl_rows[gid]
        runs = {k: launcher(k, st.perm, row, st.pred_off, st.pred) for k in ds}
        t = time_rounds(runs, reps)
        ref = torch.empty_like(zero)
        ref.copy_(zero)
        ds["levels"](st, ref, st.perm, row, st.pred_off, st.pred)
        for k in ds:
            work[k].copy_(zero)
            ds[k](st, work[k], st.perm, row, st.pred_off, st.pred)
            if not torch.equal(work[k], ref):
                raise SystemExit(f"{label} {out['dim']} group {gid}: {k} differs from levels")
        groups.append(dict(group=gid, n_levels=int(row.shape[0] - 1), **{
            k: v["mean"] for k, v in t.items()}, all=t))
    out["groups"] = groups

    width = []
    empty_off = torch.zeros(st.od.shape[0] + 1, dtype=torch.int32, device=dev)
    empty = torch.zeros(1, dtype=torch.int32, device=dev)
    for n in WIDTHS:
        pick = disjoint_chunks(st.plan, n)
        if pick is None:
            width.append(dict(n=n, skipped="the planes hold fewer disjoint chunks"))
            continue
        rest = np.setdiff1d(np.arange(st.od.shape[0]), pick)
        perm = torch.as_tensor(np.concatenate([pick, rest]), dtype=torch.int32, device=dev)
        row = torch.as_tensor([0, n], dtype=torch.int32, device=dev)
        runs = {k: launcher(k, perm, row, empty_off, empty) for k in ds}
        t = time_rounds(runs, reps)
        d_lt = int((st.plan["d_arr"][pick] < strata_plan.CHUNK).sum())
        width.append(dict(n=n, d_below_chunk=d_lt, **{k: v["mean"] for k, v in t.items()}))
    out["width"] = width
    return out


GRAPHS = {"smoke": (cs.SMOKE_STEPS, cs.SMOKE_NODES, cs.SMOKE_PATH_STEPS, "resident"),
          "xl": (cs.XL_STEPS, cs.XL_NODES, cs.XL_PATH_STEPS, "xl"),
          "big": (cs.BIG_STEPS, cs.BIG_NODES, cs.BIG_PATH_STEPS, "xxl")}


def host_schedule(parent_dir: str, labels) -> None:
    """Print the host_schedule lines (see the module docstring)."""
    import importlib.util
    import time

    from odgi_tpu_torch.parallel import sharded_strata

    path = os.path.join(parent_dir, "odgi_tpu_torch", "ops", "strata_levels.py")
    spec = importlib.util.spec_from_file_location("odgi_tpu_torch.ops._parent_levels", path)
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    for label in labels:
        steps, nodes, path_steps, _ = GRAPHS[label]
        g = cs.shuffled_graph(steps, nodes, path_steps)
        plans = {"1d": strata_plan.plan_run(g, derive_config_1d(g), one_d=True),
                 "2d": strata_plan.plan_run(g, derive_config_2d(g), one_d=False)}
        if label == "xl":
            plans["2d_sharded_4"] = sharded_strata.stacked_plan(g, derive_config_2d(g), 4)
        for tag, p in plans.items():
            fns = {"old": old.chunk_levels, "new": strata_levels.chunk_schedule,
                   "numpy": strata_levels.chunk_schedule_numpy}
            secs = {k: [] for k in fns}
            for k in ("old", "new", "numpy", "numpy", "new", "old"):
                t0 = time.perf_counter()
                out = fns[k](p)
                secs[k].append(time.perf_counter() - t0)
                if k == "old":
                    ref = out
                elif not all(np.array_equal(a, b) for a, b in zip(out[:2], ref)):
                    raise SystemExit(f"{label} {tag}: {k}'s levels differ from the parent's "
                                     "chunk_levels")
            print(json.dumps(dict(host_schedule=label, plan=tag, groups=int(p["groups"]),
                                  cgs=int(p["cgs"]), **{f"{k}_s": v for k, v in secs.items()})),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--graphs", default="smoke,xl,big")
    ap.add_argument("--host-parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("levels_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        proc = build_variants(tmp)
        kernels.build()
        lib = load_variants(proc, tmp)
        print(json.dumps(dict(ptxas=[ln.strip() for ln in lib.ptxas.splitlines()
                                     if "Compiling entry" in ln or "Used" in ln])), flush=True)
        for label in args.graphs.split(","):
            steps, nodes, path_steps, route = GRAPHS[label]
            g = cs.shuffled_graph(steps, nodes, path_steps)
            for one_d in (True, False):
                if one_d:
                    cfg, init = derive_config_1d(g), g.node_offset.astype(np.float32)
                else:
                    cfg, init = derive_config_2d(g), ot.init_layout(g, "d")
                st = strata_sgd.StrataState.build(g, cfg, init, one_d, dev, route)
                print(json.dumps(measure(lib, st, label, args.groups, args.reps)), flush=True)
                del st
                torch.cuda.empty_cache()
    if args.host_parent:
        host_schedule(args.host_parent, args.graphs.split(","))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
