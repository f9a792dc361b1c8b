#!/usr/bin/env python3
"""Smoke run of odgi_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line or more:
  1. device: the card's name, the device count, nvidia-smi's name and
     power limit;
  2. build: compile csrc/strata_sgd.cu and print ptxas's registers, shared
     memory and spills per kernel;
  3. kernels against their plain PyTorch versions on the card, group by
     group over an iter_max=2 plan of the smoke graph (1D and 2D), with the
     stated tolerances;
  4. the main path at the default schedules through the entry points:
     synthetic GFA (1,500,000 steps = 30 paths x 50,000 steps over 10,000
     nodes) -> parse_gfa -> sort_pipeline("Ygs") -> layout_graph ->
     save_layout/load_layout (.lay) -> sum_of_path_node_distances, with the
     quality and plan gates.
The line before the card line is one JSON object with every kernel's
launches, error, times and bound; the last line is the ok/device object.
Any failed phase exits non-zero and prints no ok line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import odgi_tpu_torch as ot
from odgi_tpu_torch.algorithms import groom, topological
from odgi_tpu_torch.ops import kernels, strata_plan, strata_sgd
from odgi_tpu_torch.ops.sgd import derive_config_1d, derive_config_2d

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
F64_OPS_PER_S = 34e12       # H100 SXM f64 outside the tensor cores

# Calibration of the gates: odgi_tpu's CPU twins on this exact graph,
# through the same pipeline (GFA write + parse, twin 1D, groom, topological
# order, init_layout("d"), twin 2D).
TWIN = dict(nt_before=1556.97, nt_after=0.6777, stress_before=97.73,
            stress_after=1.5394)
PLAN_GATES = {"1d": dict(cpi=456, total_valid=149_597_691),
              "2d": dict(cpi=4560, total_valid=451_020_875)}
PLANE_ROWS = 12_288
NT_AFTER_MAX = 0.75
STRESS_AFTER_MAX = 1.62      # the twin's 1.5394 plus 5%
CHUNK_TOL = 1e-6             # max |drift delta| / scale, chunk phases
MERGE_TOL = 1e-12            # max |delta| / scale, f64 merges
LAY_TOL = 1e-9               # .lay round trip, relative to the scale

SMOKE_STEPS, SMOKE_NODES, SMOKE_PATH_STEPS = 1_500_000, 10_000, 50_000

REPLACES = {
    "strata_chunks_2d": "odgi_tpu/ops/pallas_sgd.py:1105",
    "strata_chunks_1d": "odgi_tpu/ops/pallas_sgd.py:1158",
    "strata_merge_sum": "odgi_tpu/ops/pallas_sgd.py:922",
    "strata_merge_bcast": "odgi_tpu/ops/pallas_sgd.py:922",
}
SOURCE = "odgi_tpu_torch/csrc/strata_sgd.cu"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


# ---------------------------------------------------------------------------
# The synthetic graph (the generator of tools/bigscale_bench.py, as arrays)
# ---------------------------------------------------------------------------


def synth_graph(num_steps: int, num_nodes: int, path_steps: int, seed: int = 11):
    """Deep-coverage synthetic graph: P paths of `path_steps` steps each
    random-walking over `num_nodes` 1 bp nodes with mixed orientations."""
    rng = np.random.default_rng(seed)
    P = -(-num_steps // path_steps)
    S = P * path_steps
    adv = num_nodes / path_steps
    base = int(adv)
    frac = adv - base
    steps = base + (rng.random(S) < frac).astype(np.int64)
    noise = rng.choice([0, 1, -1], size=S, p=[0.95, 0.025, 0.025])
    steps = (steps + noise).reshape(P, path_steps)
    steps[:, 0] = 0
    node = np.clip(np.cumsum(steps, axis=1), 0, num_nodes - 1).reshape(-1)
    orient = rng.integers(0, 2, S)
    step_handle = (node << 1) | orient
    a = step_handle[:-1].copy()
    b = step_handle[1:].copy()
    keep = (np.arange(1, S) % path_steps) != 0
    a, b = a[keep], b[keep]
    e = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)], 1), axis=0)
    return ot.graph_from_arrays(dict(
        node_len=np.ones(num_nodes, np.int64),
        seq_offset=np.arange(num_nodes + 1, dtype=np.int64),
        seq=np.full(num_nodes, ord("A"), np.uint8),
        node_id=np.arange(1, num_nodes + 1, dtype=np.int64),
        edge_from=e[:, 0], edge_to=e[:, 1],
        path_names=tuple(f"p{i}" for i in range(P)),
        path_circular=np.zeros(P, bool),
        path_offset=np.arange(P + 1, dtype=np.int64) * path_steps,
        step_handle=step_handle,
        step_pos=np.tile(np.arange(path_steps, dtype=np.int64), P),
    ))


def write_smoke_gfa(path: str, steps: int, nodes: int, path_steps: int) -> None:
    g = synth_graph(steps, nodes, path_steps)
    g = g.apply_ordering(np.random.default_rng(5).permutation(g.num_nodes))
    ot.write_gfa(g, path)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """CUDA-event timing of device work (milliseconds)."""

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def stop(self) -> "Timer":
        self.end.record()
        return self

    def ms(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


def sync_wall(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Bounds: the least bytes each launch must move, over the HBM rate
# ---------------------------------------------------------------------------


def touched_slots(od: np.ndarray, g0: int, cgs: int) -> int:
    """Distinct step slots the chunks g0..g0+cgs-1 read or write: the union
    of their A windows [128*o, 128*o+4096) and B windows (shifted by D)."""
    o = od[g0:g0 + cgs, 0].astype(np.int64) * strata_plan.LANE
    d = od[g0:g0 + cgs, 1].astype(np.int64)
    lo = np.sort(np.concatenate([o, o + d]))
    hi = lo + strata_plan.CHUNK
    run_hi = np.maximum.accumulate(hi)
    gaps = np.maximum(lo[1:] - run_hi[:-1], 0)
    return int(run_hi[-1] - lo[0] - gaps.sum())


def chunk_bound(p: dict, gid: int, one_d: bool) -> dict:
    """Bytes: per touched slot, the i32 planes read (2D: pos, pos_end, path;
    1D: pos, path), the f32 base read, the f32 drift read and written; plus
    (o, D) per chunk.  Operations: about 25 f32 operations per pair."""
    od = np.stack([p["o_blk"], p["d_arr"]], axis=1)
    n = touched_slots(od, gid * p["cgs"], p["cgs"])
    per_slot = 20 if one_d else 60
    return dict(bytes=n * per_slot + 8 * p["cgs"],
                ops=25 * p["cgs"] * strata_plan.CHUNK, ops_rate=F32_OPS_PER_S)


def merge_sum_bound(g, one_d: bool) -> dict:
    """Drift of every real slot and every plane, the CSR, 1/R, the node
    coordinates read and written and the update written; one f64 add per
    slot and plane."""
    S = g.num_steps
    nc, planes = (1, 1) if one_d else (2, 4)
    E = g.num_nodes if one_d else 2 * g.num_nodes
    nbytes = S * planes * 4 + S * 4 + (E + 1) * 4 + E * 8 + nc * E * 8 * 3
    return dict(bytes=nbytes, ops=S * planes + 2 * nc * E, ops_rate=F64_OPS_PER_S)


def merge_bcast_bound(g, p: dict, one_d: bool) -> dict:
    """Every slot's endpoint, base read and written, drift written, the
    update table read once."""
    L = p["data"].num_slots
    nc, planes = (1, 1) if one_d else (2, 4)
    ecap = g.num_nodes + 1 if one_d else 2 * g.num_nodes + 2
    nbytes = L * 4 + L * planes * 4 * 3 + nc * ecap * 8
    return dict(bytes=nbytes, ops=L * planes, ops_rate=F32_OPS_PER_S)


def bound_ms(b: dict):
    t_bytes = b["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = b["ops"] / b["ops_rate"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version, group by group
# ---------------------------------------------------------------------------


def library_merge_sum(st) -> float:
    """One f64 index_add_ over both replica lists: the same consensus sums
    as strata_merge_sum, by a PyTorch call the port never makes."""
    dv = st.drift.to(torch.float64)
    nc = st.coords.shape[0]
    ep = st.mi.ep.to(torch.int64)
    if nc == 1:
        idx, src = ep, dv[0][:, None]
    else:
        idx = torch.cat([ep, ep ^ 1])
        src = torch.cat([dv[0::2].T, dv[1::2].T])
    acc = torch.zeros((st.mi.ecap, nc), dtype=torch.float64, device=dv.device)
    acc.index_add_(0, idx, src)  # warm-up
    acc.zero_()
    t = Timer()
    acc.index_add_(0, idx, src)
    return t.stop().ms()


def compare_group(st, gid: int, rec: dict, tag: str) -> None:
    """Run group `gid` through each kernel and its plain version on the same
    inputs, check them, and continue from the kernel's state."""
    p = st.plan
    args = (st.base, st.planes, st.od, st.eta, p["cpi"], gid * p["cgs"], p["cgs"])
    scale = float(st.base.abs().max()) + 1.0
    chunks = kernels.strata_chunks_1d if st.one_d else kernels.strata_chunks_2d
    plain = strata_sgd.chunks_1d_plain if st.one_d else strata_sgd.chunks_2d_plain
    name = "strata_chunks_1d" if st.one_d else "strata_chunks_2d"

    d_k, d_p = st.drift.clone(), st.drift.clone()
    t = Timer()
    chunks(d_k, *args)
    k_ms = t.stop().ms()
    t = Timer()
    plain(d_p, *args)
    p_ms = t.stop().ms()
    err = float((d_k - d_p).abs().max())
    rec[name]["err"].append(err)
    rec[name]["plain_ms"][tag].append(p_ms)
    if not err / scale <= CHUNK_TOL:
        fail(f"{name} group {gid}: max|drift delta|/scale {err / scale:.3e} > {CHUNK_TOL}")

    st.drift = d_k
    c_k, u_k = st.coords.clone(), st.upd.clone()
    c_p, u_p = st.coords.clone(), st.upd.clone()
    t = Timer()
    kernels.strata_merge_sum(d_k, st.mi, c_k, u_k)
    s_ms = t.stop().ms()
    t = Timer()
    strata_sgd.merge_sum_plain(d_k, st.mi, c_p, u_p)
    sp_ms = t.stop().ms()
    cscale = float(c_p.abs().max()) + 1.0
    err = max(float((c_k - c_p).abs().max()), float((u_k - u_p).abs().max()))
    rec["strata_merge_sum"]["err"].append(err)
    rec["strata_merge_sum"]["plain_ms"][tag].append(sp_ms)
    rec["strata_merge_sum"]["library_ms"][tag].append(library_merge_sum(st))
    if not err / cscale <= MERGE_TOL:
        fail(f"strata_merge_sum group {gid}: max|delta|/scale {err / cscale:.3e} > {MERGE_TOL}")

    b_k, b_p = st.base.clone(), st.base.clone()
    d_k2, d_p2 = d_k.clone(), d_k.clone()
    t = Timer()
    kernels.strata_merge_bcast(d_k2, b_k, st.mi, u_k)
    b_ms = t.stop().ms()
    t = Timer()
    strata_sgd.merge_bcast_plain(d_p2, b_p, st.mi, u_k)
    bp_ms = t.stop().ms()
    err = max(float((b_k - b_p).abs().max()), float(d_k2.abs().max()))
    rec["strata_merge_bcast"]["err"].append(err)
    rec["strata_merge_bcast"]["plain_ms"][tag].append(bp_ms)
    if not err / scale <= MERGE_TOL:
        fail(f"strata_merge_bcast group {gid}: max|delta|/scale {err / scale:.3e} > {MERGE_TOL}")

    st.drift, st.base, st.coords, st.upd = d_k2, b_k, c_k, u_k
    say("kernel_vs_plain", dim=tag, group=gid, chunk_ms=k_ms, chunk_plain_ms=p_ms,
        sum_ms=s_ms, sum_plain_ms=sp_ms, bcast_ms=b_ms, bcast_plain_ms=bp_ms)


def warm_up(st) -> None:
    """One untimed call of every kernel and plain version on copies, so
    that no timed call pays for module loading or first-use set-up."""
    p = st.plan
    args = (st.base, st.planes, st.od, st.eta, p["cpi"], 0, 1)
    chunks = kernels.strata_chunks_1d if st.one_d else kernels.strata_chunks_2d
    plain = strata_sgd.chunks_1d_plain if st.one_d else strata_sgd.chunks_2d_plain
    chunks(st.drift.clone(), *args)
    plain(st.drift.clone(), *args)
    for merge in (kernels.strata_merge_sum, strata_sgd.merge_sum_plain):
        merge(st.drift, st.mi, st.coords.clone(), st.upd.clone())
    for bcast in (kernels.strata_merge_bcast, strata_sgd.merge_bcast_plain):
        bcast(st.drift.clone(), st.base.clone(), st.mi, st.upd)
    torch.cuda.synchronize()


def phase_kernels(g, dev) -> dict:
    rec = {n: dict(err=[], plain_ms={"1d": [], "2d": []},
                   library_ms={"1d": [], "2d": []}) for n in kernels.NAMES}
    st1 = strata_sgd.StrataState.build(
        g, derive_config_1d(g, iter_max=2), g.node_offset.astype(np.float32), True, dev)
    st2 = strata_sgd.StrataState.build(
        g, derive_config_2d(g, iter_max=2), ot.init_layout(g, "d"), False, dev)
    for st, tag in ((st1, "1d"), (st2, "2d")):
        warm_up(st)
        for gid in range(st.plan["groups"]):
            compare_group(st, gid, rec, tag)
        if not bool(torch.isfinite(st.coords).all()):
            fail(f"{tag} coordinates not finite after the comparison run")
    torch.cuda.synchronize()
    say("kernels_vs_plain", **{n: dict(max_abs_err=max(r["err"]))
                               for n, r in rec.items()})
    return rec


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


class KernelTimes:
    """Wraps the kernel wrappers the strata runs call with CUDA events, per
    kernel and per 1D/2D shape; the launch counts stay the wrappers' own."""

    def __init__(self):
        self.events = {n: {"1d": [], "2d": []} for n in kernels.NAMES}
        self.orig = {n: getattr(kernels, n) for n in kernels.NAMES}

    def install(self) -> None:
        def wrap(name, fn, shape_of):
            def timed(*a):
                t = Timer()
                fn(*a)
                self.events[name][shape_of(a)].append(t.stop())
            return timed

        dim = {
            "strata_chunks_2d": lambda a: "2d",
            "strata_chunks_1d": lambda a: "1d",
            "strata_merge_sum": lambda a: "1d" if a[2].shape[0] == 1 else "2d",
            "strata_merge_bcast": lambda a: "1d" if a[3].shape[0] == 1 else "2d",
        }
        for n in kernels.NAMES:
            setattr(kernels, n, wrap(n, self.orig[n], dim[n]))

    def uninstall(self) -> None:
        for n, fn in self.orig.items():
            setattr(kernels, n, fn)

    def ms(self, name: str, tag: str):
        return [t.ms() for t in self.events[name][tag]]


def check_plan(g, tag: str, cfg, one_d: bool, host_s: dict) -> dict:
    t0 = time.perf_counter()
    p = strata_plan.plan_run(g, cfg, one_d=one_d)
    host_s[f"plan_run_{tag}"] = time.perf_counter() - t0
    want = PLAN_GATES[tag]
    got = dict(cpi=p["cpi"], total_valid=p["total_valid"])
    rows = p["data"].num_slots // strata_plan.LANE
    say("plan", dim=tag, cpi=p["cpi"], cgs=p["cgs"], groups=p["groups"],
        total_valid=p["total_valid"], rows=rows, twin=want)
    if got != want or rows != PLANE_ROWS:
        fail(f"{tag} plan {got} rows {rows} != twin {want} rows {PLANE_ROWS}")
    return p


def phase_main(gfa_path: str, tmp: str, dev) -> dict:
    out = {}
    host_s = {}
    times = KernelTimes()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times.install()
    try:
        t0 = time.perf_counter()
        g = ot.parse_gfa(gfa_path, device=dev)
        out["parse_s"] = sync_wall(t0)
        nt0 = ot.sum_of_path_node_distances(g, device=dev).all_nt_space
        p1 = check_plan(g, "1d", derive_config_1d(g), True, host_s)

        t0 = time.perf_counter()
        g2 = ot.sort_pipeline(g, "Ygs", device=dev)
        out["sort_Ygs_s"] = sync_wall(t0)
        nt1 = ot.sum_of_path_node_distances(g2, device=dev).all_nt_space
        p2 = check_plan(g2, "2d", derive_config_2d(g2), False, host_s)

        c0 = ot.init_layout(g2, "d")
        s0 = ot.sum_of_path_node_distances(
            g2, (c0[:, 0], c0[:, 1]), device=dev).all_2d_by_nucleotides
        t0 = time.perf_counter()
        coords = ot.layout_graph(g2, device=dev)
        out["layout_s"] = sync_wall(t0)

        lay = os.path.join(tmp, "smoke.lay")
        t0 = time.perf_counter()
        ot.save_layout(coords, lay, device=dev)
        back = ot.load_layout(lay)
        out["lay_roundtrip_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        s1 = ot.sum_of_path_node_distances(
            g2, (coords[:, 0], coords[:, 1]), device=dev).all_2d_by_nucleotides
        out["stress_s"] = sync_wall(t0)
    finally:
        times.uninstall()
    out["launches"] = dict(kernels.LAUNCHES)
    # Host steps of the sort outside the SGD, timed alone on the sorted
    # graph (the same size as the graph the pipeline grooms and orders).
    for name, fn in (("groom", groom.apply_groom),
                     ("topological_order", topological.topological_order)):
        t0 = time.perf_counter()
        fn(g2)
        host_s[name] = time.perf_counter() - t0
    out["host_s"] = host_s
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out.update(nt_before=nt0, nt_after=nt1, stress_before=s0, stress_after=s1)

    ev = {n: {tag: times.ms(n, tag) for tag in ("1d", "2d")} for n in kernels.NAMES}
    sgd_ms = {tag: sum(sum(ev[n][tag]) for n in kernels.NAMES) for tag in ("1d", "2d")}
    out["kernel_ms"] = ev
    out["sgd_device_s"] = {tag: ms / 1e3 for tag, ms in sgd_ms.items()}
    out["valid_pair_updates_per_s_device"] = {
        "1d": p1["total_valid"] / (sgd_ms["1d"] / 1e3),
        "2d": p2["total_valid"] / (sgd_ms["2d"] / 1e3),
    }
    out["valid_pair_updates_per_s_wall"] = {
        "1d_sort_Ygs": p1["total_valid"] / out["sort_Ygs_s"],
        "2d_layout": p2["total_valid"] / out["layout_s"],
    }
    say("main_path", **{k: v for k, v in out.items() if k not in ("kernel_ms",)},
        twin=TWIN, kernel_ms_sum={n: {t: sum(v) for t, v in d.items()} for n, d in ev.items()})

    if not np.isfinite(coords).all():
        fail("layout coordinates not finite")
    for n in kernels.NAMES:
        if out["launches"][n] <= 0:
            fail(f"{n} was not launched on the main path")
    scale = float(np.abs(coords).max())
    lay_err = float(np.abs(back - coords).max())
    say("lay_roundtrip", max_abs_err=lay_err, scale=scale)
    if back.shape != coords.shape or not lay_err <= LAY_TOL * scale:
        fail(f".lay round trip error {lay_err} > {LAY_TOL} x {scale}")
    if not nt1 <= NT_AFTER_MAX:
        fail(f"nt-distance after Ygs {nt1} > {NT_AFTER_MAX}")
    if not s1 <= STRESS_AFTER_MAX:
        fail(f"stress after layout {s1} > {STRESS_AFTER_MAX}")
    out["bounds"] = {
        "strata_chunks_1d": {"1d": [chunk_bound(p1, i, True) for i in range(p1["groups"])]},
        "strata_chunks_2d": {"2d": [chunk_bound(p2, i, False) for i in range(p2["groups"])]},
        "strata_merge_sum": {"1d": [merge_sum_bound(g, True)],
                             "2d": [merge_sum_bound(g2, False)]},
        "strata_merge_bcast": {"1d": [merge_bcast_bound(g, p1, True)],
                               "2d": [merge_bcast_bound(g2, p2, False)]},
    }
    return out


def kernel_line(rec: dict, main: dict) -> dict:
    """One record per kernel: main-path launches and mean time per launch,
    the bound of those launches, and the plain version's and the library
    call's time per call, weighted by the main path's 1D/2D launch mix."""
    bounds = main["bounds"]
    out = []
    for n in kernels.NAMES:
        ev = main["kernel_ms"][n]
        counts = {tag: len(ev[tag]) for tag in ("1d", "2d")}
        launches = main["launches"][n]
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
        w = lambda per_tag: sum(counts[t] * per_tag[t] for t in counts) / launches
        ms = sum(sum(v) for v in ev.values()) / launches
        b_ms, b_by = {}, {}
        for tag, bl in bounds[n].items():
            vals = [bound_ms(b) for b in bl]
            b_ms[tag] = mean([v for v, _ in vals])
            b_by[tag] = max(vals)[1]
        by = b_by["2d"] if "2d" in b_by else b_by["1d"]
        plain = {t: mean(rec[n]["plain_ms"][t]) for t in ("1d", "2d")}
        lib = {t: mean(rec[n]["library_ms"][t]) for t in ("1d", "2d")}
        out.append(dict(
            name=n, route="cuda", source=SOURCE, replaces=REPLACES[n],
            launches=launches, max_abs_err=max(rec[n]["err"]), ms=ms,
            plain_ms=w(plain),
            bound_ms=w({t: b_ms.get(t, 0.0) for t in counts}), bound_by=by,
            library_ms=w(lib) if n == "strata_merge_sum" else None,
            per_shape={t: dict(launches=counts[t], ms=mean(ev[t]), plain_ms=plain[t],
                               bound_ms=b_ms.get(t)) for t in counts if counts[t]},
        ))
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", name=name, count=count, nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    report = [ln.strip() for ln in kernels.ptxas_report().splitlines()
              if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    say("build", seconds=build_s, ptxas=report)

    with tempfile.TemporaryDirectory() as tmp:
        gfa = os.path.join(tmp, "smoke.gfa")
        t0 = time.perf_counter()
        write_smoke_gfa(gfa, SMOKE_STEPS, SMOKE_NODES, SMOKE_PATH_STEPS)
        say("gfa", seconds=time.perf_counter() - t0, bytes=os.path.getsize(gfa))

        g = ot.parse_gfa(gfa, device=dev)
        rec = phase_kernels(g, dev)
        main_out = phase_main(gfa, tmp, dev)

    print(json.dumps(kernel_line(rec, main_out)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
