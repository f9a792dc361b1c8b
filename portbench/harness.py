"""The benchmark of odgi_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``: the graph's sizes, and the graph source
``graphs/<graph>.py`` where it names a ``"graph"``; ``graphgen.py``
otherwise), a traffic mix (``traffic/<mix>.json``: which job, with what
parameters; a built-in kind of ``jobs.py``, else the class ``JOB`` of
``kinds/<job>.py``) and the limits of its correctness check
(``limits/<cell>.json``).  Each per-layer metric is read by
``metrics/<metric>.py``, or where that file is missing by the reader of its
base name (the part before the first '.': ``kernels_roofline.sort`` is read
by ``metrics/kernels_roofline.py``).  Everything is found by the names in
``BENCHMARK.json``, so a new cell, configuration, graph source, mix, job
kind or metric is new files and entries; a name with no file stops the run
with the path it looked for.

A run: set-up makes the graph from ``--seed``, lets a kind with a
``prepare`` hook write its input files into a temporary directory (removed
after the check), and runs one job to warm up (the first run of a checkout
also builds the program's kernels).  Then a closed loop of one user's jobs,
back to back: job k takes the PG-SGD seed drawn from (seed, k); a job
starts while less than ``--seconds`` has passed, and the window ends when
the last started job ends.  The end-to-end metric is the window over the
jobs it completed.  With ``--trace 1`` the window runs under
``torch.profiler`` with the benchmark's spans (``spans.py``) and reports
the per-layer metrics instead.  After the window one job, drawn from the
seed, is worked out again by the plain reference (``reference.py``) and
compared; the numbers and their limits close standard error and the
result's line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "odgi_tpu")
CACHE = ".portbench_cache"


def process_start() -> float:
    """The process's start on the perf_counter clock (Linux's /proc; the
    module's import where that is missing)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        age = float(Path("/proc/uptime").read_text().split()[0]) - int(fields[19]) / ticks
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def job_seed(seed: int, k: int) -> int:
    """The PG-SGD seed of job k (0: the warm-up) of a run with `seed`."""
    return int(np.random.default_rng([seed % 2**64, k]).integers(1, 2**31 - 1))


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries and files, by the names in BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    bench_dir = root / "portbench"
    return dict(
        cell=cell,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e,
        per_layer=per_layer,
        metric_dir=bench_dir / "metrics",
        kind_dir=bench_dir / "kinds",
        graph_dir=bench_dir / "graphs",
    )


def load_file(path: Path, what: str):
    """The module in `path`, a file found by a name in the benchmark's files."""
    if not path.is_file():
        raise SystemExit(f"portbench: no {what} {path.stem!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric_dir: Path, name: str):
    path = metric_dir / f"{name}.py"
    if not path.exists():
        path = metric_dir / f"{name.split('.')[0]}.py"
    return load_file(path, "metric")


def graph_fields(config: dict, seed: int, graph_dir: Path = HERE / "graphs") -> dict:
    """The graph's fields: ``graphs/<graph>.py``'s ``graph_arrays`` where
    the configuration names a ``"graph"``, ``graphgen``'s otherwise."""
    if "graph" in config:
        return load_file(Path(graph_dir) / f"{config['graph']}.py",
                         "graph source").graph_arrays(config, seed)
    from . import graphgen

    return graphgen.graph_arrays(config, seed)


def prepare(job, g):
    """A temporary directory holding the input files that `job`'s
    ``prepare`` hook writes for graph `g`, or None for a kind without one.
    The caller removes it (on an error it goes when the object is collected
    or the process exits)."""
    if not hasattr(job, "prepare"):
        return None
    workdir = tempfile.TemporaryDirectory(prefix="portbench-")
    job.prepare(g, Path(workdir.name))
    return workdir


class Run:
    """What a per-layer metric reader sees of a traced window."""

    def __init__(self, f, job, device, spans, trace, launches, seeds):
        self.f, self.one_d, self.device = f, job.one_d, device
        self.spans, self.trace, self.launches = spans, trace, launches
        self.job_seeds = seeds
        self.jobs = len(seeds)
        self._counter = None

    def least_s(self, seed: int) -> float:
        """The least time the job with PG-SGD seed `seed` needs (count.py)."""
        from .count import Counter

        if self._counter is None:
            self._counter = Counter(self.f, self.device)
        return self._counter.least_s(seed, self.one_d)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, config=None) -> dict:
    """One run of `workload` on `device`; `config`'s keys are laid over the
    configuration file's (the CPU tests shrink the graph with it)."""
    import torch

    from odgi_tpu_torch.convert import graph_from_arrays
    from odgi_tpu_torch.ops import kernels
    from odgi_tpu_torch.ops.sgd import LAST_RUN

    from . import jobs, spans as sp, trace as tr

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    c = load_cell(root, workload)
    job = jobs.make(c["traffic"], c["kind_dir"])
    parts = dict(to_graph=time.perf_counter() - t_start)
    f = graph_fields({**c["config"], **(config or {})}, seed, c["graph_dir"])
    g = graph_from_arrays(f)
    fresh = lambda: dataclasses.replace(g, _cache={})
    parts["graph"] = time.perf_counter() - t_start - parts["to_graph"]
    workdir = prepare(job, fresh())
    job.install()
    job.run(fresh(), job_seed(seed, 0), device)
    sync()
    setup_s = time.perf_counter() - t_start
    parts["warm_up"] = setup_s - parts["graph"] - parts["to_graph"]

    readers = {m["name"]: load_reader(c["metric_dir"], m["name"]) for m in c["per_layer"]} \
        if trace else {}
    spans = prof = None
    if trace:
        points = dict(sp.STANDARD)
        for r in readers.values():
            points.update(getattr(r, "SPANS", {}))
        spans = sp.Spans(points, device)
        spans.install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    kernels.reset_launch_counts()
    draw = np.random.default_rng([seed % 2**64, 2**32])
    seeds, job_s, routes, kept = [], [], [], None
    w0 = time.perf_counter()
    while not seeds or time.perf_counter() - w0 < seconds:
        s = job_seed(seed, len(seeds) + 1)
        if spans:
            spans.job = len(seeds)
        t = time.perf_counter()
        with torch.profiler.record_function(tr.JOB):
            out = job.run(fresh(), s, device)
            sync()
        job_s.append(time.perf_counter() - t)
        seeds.append(s)
        routes.append(LAST_RUN.get("route"))
        if draw.random() * len(seeds) < 1:   # a uniform sample of one job
            kept = (s, job.keep(out))
        del out
    window_s = time.perf_counter() - w0
    launches = dict(kernels.LAUNCHES)
    trace_obj = None
    if trace:
        prof.__exit__(None, None, None)
        spans.uninstall()
        if cuda:
            tmp = tempfile.mkdtemp()
            try:
                prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
                trace_obj = tr.Trace(os.path.join(tmp, "trace.json"))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        del prof
    job.uninstall()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    for base, tracked in kernels.TRACKED.items():
        launches[base] = launches.get(base, 0) + launches.pop(tracked, 0)
    metrics, device_info = {}, dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=1, memory_peak_bytes=int(peak))
    result = dict(correct=False, attempted=len(seeds), failed=0, metrics=metrics,
                  device=device_info)
    if not trace:
        values = {job.metric: window_s / len(seeds), "setup_s": setup_s}
        for m in c["end_to_end"]:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        run = Run(f, job, device, spans, trace_obj, launches, seeds)
        for m in c["per_layer"]:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        if trace_obj is not None:
            device_info.update(busy_s=trace_obj.busy_s(), window_s=trace_obj.window_s)
            result["breakdown"] = dict(device_ops=trace_obj.device_ops(),
                                       idle_gaps=trace_obj.idle_gaps())
    result["info"] = dict(workload=workload, seed=seed, window_s=window_s, setup_s=setup_s,
                          setup_parts=parts,
                          job_s=job_s, routes=sorted(set(routes)),
                          launches={k: v for k, v in launches.items() if v},
                          card=power_limit() if cuda else "")

    # The check: the sampled job again on the plain reference, once the
    # program's state is freed.
    del g, fresh
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = job.reference(f, kept[0], device, torch.float64)
    gaps = job.compare(kept[1], ref)
    result["info"].update(checked_seed=kept[0], reference_s=time.perf_counter() - t,
                          stress=dict(program=job.quality(f, kept[1]),
                                      reference=job.quality(f, ref)))
    checks = {k: dict(value=v, limit=float(c["limits"][k]["limit"])) for k, v in gaps.items()}
    result["correct"] = all(ch["value"] <= ch["limit"] for ch in checks.values())
    result["checks"] = checks
    if workdir is not None:
        workdir.cleanup()
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / CACHE / sub)
    import torch

    cell = load_cell(ROOT, args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result["info"]), flush=True)
    del result["info"]
    report(result)
    return 0


def report(result: dict) -> None:
    """The compared numbers and limits as the last lines of standard error,
    then the result's line (its checks last) on standard output."""
    checks = result.pop("checks")
    for k, ch in checks.items():
        print(f"check {k} {ch['value']!r} limit {ch['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
