"""A chromosome-shaped ``odgi sort -p Ygs`` on the CPU, at a small size.

- ``sort_pipeline`` on a graph of the benchmark's ``chrom-90hap`` shape
  with more than 32,767 nodes takes the 1D xxl route and equals the plain
  reference (``portbench/reference.py`` ``sort_ygs``) exactly: the sorted
  graph and the Y pass's positions, compared as the benchmark's sort job
  compares them; the reference in float32 reads above the cell's limit.
- Each PG-SGD run counts its route (``strata.route.<route>``), and groom
  and the topological order count their structural work (``groom.*``,
  ``topological_order.*``), equal to the same counts taken from the
  reference's own loops.
- The Y pass's span ``sort.path_sgd`` holds the strata run and the order,
  and the benchmark's readers ``sort_sgd_s`` and ``apply_ordering_s`` sum
  their spans over the jobs of a trace.
"""

import collections
import inspect
import json
import sys
import types

import numpy as np
import pytest
import torch

from odgi_tpu_torch.algorithms import groom as groom_mod
from odgi_tpu_torch.algorithms import topological
from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline
from odgi_tpu_torch.convert import graph_from_arrays
from odgi_tpu_torch.ops import sgd
from odgi_tpu_torch.utils import metrics
from portbench import graphgen, harness, jobs, reference
from portbench import trace as bench_trace

# The chrom-90hap shape cut to 2 haplotypes: past 32,767 nodes a 1D run
# goes xxl.
CHROM = dict(haplotypes=2, nodes=34000)
LOCUS = dict(haplotypes=8, nodes=600)
JOBS = 2


def _runs(name):
    return metrics.TOTALS.get(name, {}).get("runs", 0)


@pytest.mark.parametrize("graph_seed", [2**31 + 11, 7])
@pytest.mark.parametrize("sgd_seed", [2**31 - 2, 77])
def test_chrom_shaped_sort_equals_the_reference(graph_seed, sgd_seed):
    f = graphgen.graph_arrays(CHROM, graph_seed)
    job = jobs.make({"job": "sort", "pipeline": "Ygs"})
    job.install()
    try:
        before = _runs("strata.route.xxl")
        got = job.keep(job.run(graph_from_arrays(f), sgd_seed, "cpu"))
    finally:
        job.uninstall()
    assert sgd.LAST_RUN["route"] == "xxl"
    assert _runs("strata.route.xxl") == before + 1
    gaps = job.compare(got, reference.sort_ygs(f, sgd_seed, "cpu"))
    assert gaps == {"graph_mismatch": 0.0, "x_gap": 0.0}


def test_locus_shaped_sort_counts_the_resident_route():
    g = graph_from_arrays(graphgen.graph_arrays(LOCUS, 3))
    before = {r: _runs(f"strata.route.{r}") for r in ("resident", "xl", "xxl", "batched")}
    sort_pipeline(g, "Ygs", sgd_overrides=dict(iter_max=2, seed=5), device="cpu")
    assert sgd.LAST_RUN["route"] == "resident"
    after = {r: _runs(f"strata.route.{r}") for r in before}
    assert {r: after[r] - before[r] for r in before} == dict(resident=1, xl=0, xxl=0, batched=0)


def test_count_adds_an_amount():
    before = _runs("test.amount")
    metrics.count("test.amount", 5)
    metrics.count("test.amount")
    metrics.count("test.amount", 0)
    assert _runs("test.amount") == before + 6
    metrics.TOTALS.pop("test.amount")


# ---------------------------------------------------------------------------
# The counters of groom and the topological order
# ---------------------------------------------------------------------------


def _with_cycle(f):
    """`f` with a component no head reaches: three nodes in a cycle, one
    entered on its reverse strand, walked by one more path."""
    n = len(f["node_len"])
    steps = np.array([n << 1, ((n + 1) << 1) | 1, (n + 2) << 1, n << 1], np.int64)
    a, b = steps[:-1], steps[1:]
    ra, rb = b ^ 1, a ^ 1
    first = (a < ra) | ((a == ra) & (b <= rb))
    ef, et = np.where(first, a, ra), np.where(first, b, rb)
    bp = int(f["node_len"][0])
    return dict(
        f,
        node_len=np.concatenate([f["node_len"], np.full(3, bp, np.int64)]),
        seq_offset=np.arange(n + 4, dtype=np.int64) * bp,
        seq=np.concatenate([f["seq"], np.full(3 * bp, ord("C"), np.uint8)]),
        node_id=np.arange(1, n + 4, dtype=np.int64),
        edge_from=np.concatenate([f["edge_from"], ef]),
        edge_to=np.concatenate([f["edge_to"], et]),
        path_names=tuple(f["path_names"]) + ("cycle",),
        path_circular=np.concatenate([f["path_circular"], [False]]),
        path_offset=np.concatenate([f["path_offset"], [f["path_offset"][-1] + len(steps)]]),
        step_handle=np.concatenate([f["step_handle"], steps]),
        step_pos=np.concatenate([f["step_pos"], np.arange(len(steps), dtype=np.int64) * bp]),
    )


def _line_counts(fn, lines, *args):
    """Run `fn(*args)`, counting how often each source line in `lines` (by
    its stripped text) runs in `fn`'s own frame; (result, counts, the
    frame's locals at its return)."""
    code = fn.__code__
    src, first = inspect.getsourcelines(fn)
    at = {first + i: s.strip() for i, s in enumerate(src) if s.strip() in lines}
    assert sorted(set(at.values())) == sorted(lines)
    counts = collections.Counter()
    out = {}

    def local(frame, event, arg):
        if event == "line" and frame.f_lineno in at:
            counts[at[frame.f_lineno]] += 1
        elif event == "return":
            out.update(frame.f_locals)
        return local

    def tracer(frame, event, arg):
        return local if frame.f_code is code else None

    prev = sys.gettrace()
    sys.settrace(tracer)
    try:
        result = fn(*args)
    finally:
        sys.settrace(prev)
    return result, counts, out


def test_gs_counters_equal_the_reference_loops():
    f = _with_cycle(graphgen.graph_arrays(dict(haplotypes=6, nodes=400), 2**31 + 3))
    g = graph_from_arrays(f)
    names = ("groom.flipped", "groom.restarts", "topological_order.seeded",
             "topological_order.restarts")
    before = {k: _runs(k) for k in names}
    flip = groom_mod.groom(g)
    order = topological.topological_order(g, use_heads=True)
    got = {k: _runs(k) - before[k] for k in names}

    restart = "stack = [int(rest[0]) << 1]"
    _, gc, gl = _line_counts(reference.groom, [restart], f)
    seeded, picked = "push(ready, in_ready, s)", "r = heapq.heappop(unv_heap)"
    ref_order, tc, _ = _line_counts(reference.topological_order, [seeded, picked], f)
    assert np.array_equal(flip, gl["flip"]) and np.array_equal(order, ref_order)
    want = {"groom.flipped": int(gl["flip"].sum()), "groom.restarts": gc[restart],
            "topological_order.seeded": tc[seeded], "topological_order.restarts": tc[picked]}
    assert got == want
    # the head-less cycle restarts both walks; its reverse node is flipped;
    # tandem repeats (self-loops) send nodes through the seed set
    assert all(v > 0 for v in want.values()), want


# ---------------------------------------------------------------------------
# The Y pass's span and the readers of the new metrics
# ---------------------------------------------------------------------------


def _spans(path):
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in ev if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _innermost(span, spans):
    ts, end, _ = span
    held = [s for s in spans if s is not span and s[0] <= ts and end <= s[1]
            and (s[1] - s[0]) > (end - ts)]
    return min(held, key=lambda s: s[1] - s[0])[2] if held else None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """JOBS short sort jobs of the chrom-shaped graph under torch.profiler
    (CPU), each inside a ``portbench.job`` span."""
    g = graph_from_arrays(graphgen.graph_arrays(CHROM, 5))
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(JOBS):
            with torch.profiler.record_function(bench_trace.JOB):
                sort_pipeline(g, "Ygs", sgd_overrides=dict(iter_max=2, seed=k + 1),
                              device="cpu")
            assert sgd.LAST_RUN["route"] == "xxl"
    prof.export_chrome_trace(str(path))
    return path


def test_path_sgd_span_under_the_job_holds_the_run(traced):
    spans = _spans(traced)
    ys = [s for s in spans if s[2] == "sort.path_sgd"]
    assert len(ys) == JOBS
    for y in ys:
        assert _innermost(y, spans) == bench_trace.JOB
        inside = {s[2] for s in spans if y[0] <= s[0] and s[1] <= y[1] and s is not y}
        assert {"strata.build", "strata.relabel", "strata.run", "sort.order"} <= inside
        assert not inside & {"sort.groom", "sort.topological_order"}
    for s in spans:
        if s[2] in ("strata.build", "strata.run", "sort.order"):
            assert _innermost(s, spans) == "sort.path_sgd", s[2]
    # the renumberings: the relabel's inside the Y pass, then after Y and after s
    ao = [s for s in spans if s[2] == "graph.apply_ordering"]
    assert collections.Counter(_innermost(s, spans) for s in ao) == {
        "strata.relabel": JOBS, bench_trace.JOB: 2 * JOBS}
    for lo, hi, _ in [s for s in spans if s[2] == bench_trace.JOB]:
        inside = [s for s in spans if s[2] != bench_trace.JOB and lo <= s[0] < hi]
        assert 0 < len(inside) <= 16


READERS = {"sort_sgd_s.sort": ("sort.path_sgd",),
           "apply_ordering_s.sort": ("graph.apply_ordering",)}


def _reader(name):
    return harness.load_reader(harness.HERE / "metrics", name)


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_readers_sum_spans_over_jobs(traced, name):
    spans = _spans(traced)
    want = sum(e - s for s, e, n in spans if n in READERS[name]) / 1e6 / JOBS
    run = types.SimpleNamespace(trace=bench_trace.Trace(str(traced)), jobs=JOBS)
    got = _reader(name).read(run)
    assert got is not None and got > 0
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_readers_read_none_without_their_spans(traced, name, tmp_path):
    reader = _reader(name)
    assert reader.read(types.SimpleNamespace(trace=None, jobs=JOBS)) is None
    # fewer spans than jobs (a job lost its span) reads nothing, never less time
    lost = 1 + sum(n in READERS[name] for _, _, n in _spans(traced))
    run = types.SimpleNamespace(trace=bench_trace.Trace(str(traced)), jobs=lost)
    assert reader.read(run) is None
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": bench_trace.JOB, "ts": 0, "dur": 10}]}))
    assert reader.read(types.SimpleNamespace(trace=bench_trace.Trace(str(path)), jobs=1)) is None


def test_control_breaks_the_cell_limit():
    """The reference in float32, one step below the configuration's
    float64, reads above the cell's x_gap limit (its graph unmoved)."""
    limits = json.loads((harness.HERE / "limits" / "chrom-90hap.sort-Ygs.json").read_text())
    f = graphgen.graph_arrays(CHROM, 2**31 + 11)
    job = jobs.make({"job": "sort", "pipeline": "Ygs"})
    gaps = job.compare(reference.sort_ygs(f, 77, "cpu", torch.float32),
                       reference.sort_ygs(f, 77, "cpu", torch.float64))
    assert gaps["graph_mismatch"] == 0
    assert gaps["x_gap"] > 5 * float(limits["x_gap"]["limit"])
