"""The program's spans (``odgi_tpu_torch/utils/metrics.py``) on the card:
what they cost, off and on, and whether they share the kernels' clock.

    python3 tools/span_check.py [--seed N] [--out DIR] [--device cpu --tiny]

1. Off: the cost of ``with span(name)`` and of a call through a function
   that ``@span`` wraps, with no profiler recording, beside a shared
   ``nullcontext``, a bare call and ``record_function`` (which costs its
   own work even when nothing records).
2. On: the cost of a span while ``torch.profiler`` records CPU and CUDA
   activities.
3. One traced job of each benchmark cell (``portbench/configs``, the
   cell's job, inside a ``portbench.job`` span as the benchmark runs it,
   after one warm-up job): the program spans a job, the share of
   ``strata.build`` its parts cover (relabel, plan, chunk schedule, merge
   index, block schedule, upload), and the shared clock: every strata
   kernel of the job starts after the start of its ``strata.run`` span,
   and no kernel starts inside ``strata.plan`` or
   ``strata.chunk_schedule``.
4. The two clocks over a long trace: once a second, a one-element add
   launched inside a span right after a synchronize; its start on the
   device minus the span's start on the host, second by second.

Prints one JSON line; the traces go into DIR (default ``span_check_out``
at the root of the checkout).  ``--device cpu --tiny`` rehearses it on the
CPU at a tiny size (no kernels, so the clock checks hold vacuously).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from odgi_tpu_torch.algorithms.layout import layout_graph  # noqa: E402
from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline  # noqa: E402
from odgi_tpu_torch.convert import graph_from_arrays  # noqa: E402
from odgi_tpu_torch.ops.sgd import LAST_RUN, derive_config_2d  # noqa: E402
from odgi_tpu_torch.utils import metrics  # noqa: E402
from portbench import graphgen  # noqa: E402
from portbench.trace import JOB, Trace  # noqa: E402

PARTS = ("strata.relabel", "strata.plan", "strata.chunk_schedule", "strata.merge_index",
         "strata.block_schedule", "strata.upload")
CELLS = (("locus-90hap.layout", "locus-90hap", "layout"),
         ("locus-90hap.sort-Ygs", "locus-90hap", "sort"),
         ("chrom-90hap.layout", "chrom-90hap", "layout"))
TINY = {"locus-90hap": dict(haplotypes=8, nodes=600),
        "chrom-90hap": dict(haplotypes=2, nodes=20000)}


def per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def costs_off(n: int) -> dict:
    shared = contextlib.nullcontext()
    span = metrics.span

    def bare():
        return None

    wrapped = span("cost.probe")(bare)

    def with_span():
        with span("cost.probe"):
            pass

    def with_null():
        with shared:
            pass

    def with_record_function():
        with torch.profiler.record_function("cost.probe"):
            pass

    return dict(span_us=per_call_us(with_span, n), nullcontext_us=per_call_us(with_null, n),
                flag_us=per_call_us(metrics._recording, n),
                decorated_call_us=per_call_us(wrapped, n), bare_call_us=per_call_us(bare, n),
                record_function_us=per_call_us(with_record_function, n // 10))


def costs_on(n: int, cuda: bool) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def with_span():
        with metrics.span("cost.probe"):
            pass

    with torch.profiler.profile(activities=acts):
        on = per_call_us(with_span, n)
    return dict(span_us=on)


def clock_offsets(seconds: int, device, out: Path) -> list:
    """[seconds into the trace, device start - host span start in us] of a
    probe launched once a second into an idle device."""
    x = torch.zeros(1, device=device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(seconds + 1):
            torch.cuda.synchronize()
            with torch.profiler.record_function("clock.probe"):
                x.add_(1)
            torch.cuda.synchronize()
            time.sleep(1.0)
    path = out / "clock.trace.json"
    prof.export_chrome_trace(str(path))
    tr = Trace(str(path))
    path.unlink()
    probes = [s for s in tr.spans if s[2] == "clock.probe"]
    adds = [k for k in tr.kernels if "spin" not in k[2].lower()]
    if len(probes) != len(adds):
        return [["probes", len(probes), "kernels", len(adds)]]
    return [[(s[0] - probes[0][0]) / 1e6, k[0] - s[0]] for s, k in zip(probes, adds)]


def job_fn(kind: str, device):
    if kind == "layout":
        return lambda g, s: layout_graph(g, derive_config_2d(g, seed=s), seed=s, device=device)
    return lambda g, s: sort_pipeline(g, "Ygs", sgd_overrides={"seed": s}, device=device)


def check_job(tr: Trace) -> dict:
    """Spans, parts and the shared clock of the one traced job."""
    program = [s for s in tr.spans if s[2] != JOB and tr.lo <= s[0] < tr.hi]
    names = collections.Counter(s[2] for s in program)
    builds = [s for s in program if s[2] == "strata.build"]
    runs = [s for s in program if s[2] == "strata.run"]
    covered = sum(d for _, d, n in program if n in PARTS)
    build = sum(d for _, d, _ in builds)
    strata = [k for k in tr.inside() if re.search(r"::strata_\w+?_kernel[<(]", k[2])]
    quiet = [s for s in program if s[2] in ("strata.plan", "strata.chunk_schedule")]
    in_quiet = [k for k in tr.inside() for s in quiet if s[0] <= k[0] < s[0] + s[1]]
    first_run = min((s[0] for s in runs), default=None)
    return dict(
        job_s=tr.window_s, program_spans=len(program), spans=dict(names),
        build_s=build / 1e6, parts_s={n: sum(d for _, d, m in program if m == n) / 1e6
                                     for n in PARTS if names[n]},
        parts_share_of_build=covered / build if build else None,
        build_self_share=1 - covered / build if build else None,
        strata_kernels=len(strata), kernels=len(tr.inside()),
        strata_kernels_before_run=sum(k[0] < first_run for k in strata) if runs else None,
        first_kernel_after_run_start_us=(min(k[0] for k in strata) - first_run
                                         if strata and runs else None),
        kernels_in_plan_or_schedule=len(in_quiet),
        clock_ok=bool(runs) and all(k[0] >= first_run for k in strata) and not in_quiet)


def traced_job(cell: str, config: str, kind: str, args, device, cuda: bool, out: Path) -> dict:
    conf = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    if args.tiny:
        conf.update(TINY[config])
    g = graph_from_arrays(graphgen.graph_arrays(conf, args.seed))
    run = job_fn(kind, device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run(dataclasses.replace(g, _cache={}), args.seed + 1)     # warm-up
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(JOB):
            run(dataclasses.replace(g, _cache={}), args.seed + 2)
            sync()
    path = out / f"{cell}.trace.json"
    prof.export_chrome_trace(str(path))
    res = dict(cell=cell, route=LAST_RUN.get("route"), steps=int(g.num_steps),
               trace_bytes=os.path.getsize(path), **check_job(Trace(str(path))))
    if cell != "locus-90hap.layout":
        path.unlink()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2**31 + 20)
    ap.add_argument("--out", default=str(ROOT / "span_check_out"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--calls", type=int, default=200_000)
    ap.add_argument("--drift-seconds", type=int, default=15)
    args = ap.parse_args()
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = dict(card="", off=costs_off(args.calls), on=costs_on(args.calls // 10, cuda))
    if cuda:
        res["card"] = torch.cuda.get_device_name(0)
    res["jobs"] = [traced_job(*c, args, device, cuda, out) for c in CELLS]
    if cuda:
        res["clock_offsets_us"] = clock_offsets(args.drift_seconds, device, out)
    for j in res["jobs"]:
        j["span_cost_on_ms_a_job"] = res["on"]["span_us"] * j["program_spans"] / 1e3
    res["totals"] = metrics.TOTALS
    res["ok"] = all(j["clock_ok"] for j in res["jobs"] if j["cell"] == "locus-90hap.layout")
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
