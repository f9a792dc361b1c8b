"""The program's own spans and once-a-process timers
(``odgi_tpu_torch/utils/metrics.py``) and the benchmark's readers of them
(``portbench/metrics/``).

- Off: with no profiler, ``span`` hands out one shared no-op a name and
  never reaches ``record_function``.
- On, on the CPU: a small layout on the resident and the xxl route and a
  small ``sort_pipeline(..., "Ygs")`` under ``torch.profiler``, each job
  inside a ``portbench.job`` span as the benchmark runs it: every span of
  the layer table lands in the Chrome trace under its parent, one
  ``strata.run`` a run, at most 16 program spans a job.
- The readers: span seconds over the jobs from that trace, and None where
  the trace or a span is missing.
- The once-a-process totals, with the native g++ library in a temporary
  build directory, and with the kernels' build already in place.
"""

import collections
import json
import types

import pytest
import torch

from odgi_tpu_torch import native
from odgi_tpu_torch.algorithms.layout import layout_graph
from odgi_tpu_torch.algorithms.path_sgd_sort import sort_pipeline
from odgi_tpu_torch.convert import graph_from_arrays
from odgi_tpu_torch.ops import kernels, sgd, strata_route
from odgi_tpu_torch.utils import metrics
from portbench import graphgen, harness
from portbench import trace as bench_trace

JOBS = 2
STRATA = ["strata.build", "strata.plan", "strata.chunk_schedule", "strata.merge_index",
          "strata.upload", "strata.run"]
# case -> the spans each job holds, by name
EXPECT = {
    "resident": STRATA + ["layout.init", "layout.pack"],
    "xxl": STRATA + ["strata.relabel", "strata.block_schedule", "graph.apply_ordering",
                     "layout.init", "layout.pack"],
    "Ygs": STRATA + ["sort.path_sgd", "sort.order", "sort.groom", "sort.topological_order",
                     "graph.apply_ordering"],
}
# span -> its innermost program parent
PARENT = {"strata.relabel": "strata.build", "strata.plan": "strata.build",
          "strata.chunk_schedule": "strata.build", "strata.merge_index": "strata.build",
          "strata.block_schedule": "strata.build", "strata.upload": "strata.build",
          "strata.build": None, "strata.run": None, "layout.init": None, "layout.pack": None,
          "sort.order": None, "sort.groom": None, "sort.topological_order": None}
# in a sort, the Y pass's span holds its strata run and its order
PARENT_SORT = dict(PARENT, **{"sort.path_sgd": None, "strata.build": "sort.path_sgd",
                              "strata.run": "sort.path_sgd", "sort.order": "sort.path_sgd"})
# the readers of each case's cell and the spans each sums
READERS = {
    "strata_relabel_s": ("strata.relabel",),
    "strata_plan_s.layout": ("strata.plan",),
    "strata_plan_s.sort": ("strata.plan",),
    "strata_index_s.layout": ("strata.chunk_schedule", "strata.merge_index",
                              "strata.block_schedule"),
    "strata_index_s.sort": ("strata.chunk_schedule", "strata.merge_index"),
    "strata_upload_s.layout": ("strata.upload",),
    "strata_upload_s.sort": ("strata.upload",),
}
CASE_READERS = {
    "resident": ["strata_plan_s.layout", "strata_index_s.layout", "strata_upload_s.layout"],
    "xxl": ["strata_relabel_s", "strata_plan_s.layout", "strata_index_s.layout",
            "strata_upload_s.layout"],
    "Ygs": ["strata_plan_s.sort", "strata_index_s.sort", "strata_upload_s.sort"],
}


@pytest.fixture(scope="module")
def graph():
    """A 600-node, 8-haplotype graph of the benchmark's generator."""
    return graph_from_arrays(graphgen.graph_arrays(dict(haplotypes=8, nodes=600), 2**31 + 7))


def _run_jobs(g, case, path, monkeypatch):
    """JOBS jobs of `case` under torch.profiler (CPU), each inside a
    ``portbench.job`` span; the Chrome trace written to `path`."""
    if case != "Ygs":
        monkeypatch.setattr(strata_route, "graph_route", lambda g, cfg, one_d: case)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(JOBS):
            with torch.profiler.record_function(bench_trace.JOB):
                if case == "Ygs":
                    sort_pipeline(g, "Ygs", sgd_overrides=dict(iter_max=2, seed=k + 1),
                                  device="cpu")
                else:
                    layout_graph(g, sgd.derive_config_2d(g, iter_max=2, seed=k + 1),
                                 seed=k + 1, device="cpu")
            assert sgd.LAST_RUN["route"] == ("resident" if case == "Ygs" else case)
    prof.export_chrome_trace(str(path))


@pytest.fixture(scope="module", params=sorted(EXPECT))
def traced(request, graph, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        path = tmp_path_factory.mktemp("trace") / "trace.json"
        _run_jobs(graph, request.param, path, mp)
    finally:
        mp.undo()
    return request.param, path


def _spans(path):
    """(ts, end, name) of every user_annotation span, by start."""
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in ev if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _program(name):
    return name != bench_trace.JOB


def _parent(span, spans):
    """The innermost program span that holds `span`, or None."""
    ts, end, name = span
    held = [s for s in spans if s is not span and _program(s[2])
            and s[0] <= ts and end <= s[1] and (s[1] - s[0]) > (end - ts)]
    return min(held, key=lambda s: s[1] - s[0])[2] if held else None


# ---------------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------------


def test_span_off_is_one_shared_noop(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert not metrics._recording()
    s = metrics.span("test.off")
    assert s is metrics.span("test.off")
    with s as got:
        assert got is None

    @metrics.span("test.off")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    # the program's spans too: a whole job runs without record_function
    g = graph_from_arrays(graphgen.graph_arrays(dict(haplotypes=4, nodes=400), 3))
    assert sort_pipeline(g, "Ygs", sgd_overrides=dict(iter_max=1), device="cpu").num_nodes == 400


def test_span_on_records_and_nests(tmp_path):
    @metrics.span("test.outer")
    def outer():
        with metrics.span("test.inner"):
            return torch.zeros(3)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert metrics._recording()
        outer()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = _spans(tmp_path / "t.json")
    assert [s[2] for s in spans] == ["test.outer", "test.inner"]
    assert _parent(spans[1], spans) == "test.outer"


# ---------------------------------------------------------------------------
# On: the program's spans in a CPU trace
# ---------------------------------------------------------------------------


def test_every_span_under_its_parent(traced):
    case, path = traced
    spans = _spans(path)
    names = collections.Counter(s[2] for s in spans)
    assert names[bench_trace.JOB] == JOBS
    for name in EXPECT[case]:
        assert names[name] >= JOBS, (case, name, names)
    parent = PARENT_SORT if case == "Ygs" else PARENT
    for s in spans:
        if s[2] in parent:
            assert _parent(s, spans) == parent[s[2]], (case, s[2])
        if s[2] == "graph.apply_ordering" and case == "xxl":
            assert _parent(s, spans) == "strata.relabel"
    unexpected = set(names) - set(EXPECT[case]) - {bench_trace.JOB}
    assert not unexpected, unexpected


def test_one_strata_run_span_a_run(traced):
    case, path = traced
    names = collections.Counter(s[2] for s in _spans(path))
    assert names["strata.run"] == names["strata.build"] == JOBS


def test_at_most_16_program_spans_a_job(traced):
    _, path = traced
    spans = _spans(path)
    for lo, hi, _ in [s for s in spans if s[2] == bench_trace.JOB]:
        inside = [s for s in spans if _program(s[2]) and lo <= s[0] < hi]
        assert 0 < len(inside) <= 16


def test_build_parts_cover_the_build(traced):
    """The build's parts are separate steps inside it: they never overlap,
    and each lies inside its build."""
    _, path = traced
    spans = _spans(path)
    for b in [s for s in spans if s[2] == "strata.build"]:
        parts = sorted(s for s in spans if PARENT.get(s[2]) == "strata.build"
                       and b[0] <= s[0] and s[1] <= b[1])
        assert len(parts) >= 4
        assert all(a[1] <= c[0] for a, c in zip(parts, parts[1:]))


# ---------------------------------------------------------------------------
# The readers
# ---------------------------------------------------------------------------


def _reader(name):
    return harness.load_reader(harness.HERE / "metrics", name)


def _stand_in(path, jobs=JOBS):
    return types.SimpleNamespace(trace=bench_trace.Trace(str(path)), jobs=jobs)


def test_readers_sum_spans_over_jobs(traced):
    case, path = traced
    run = _stand_in(path)
    spans = _spans(path)
    for name in CASE_READERS[case]:
        want = sum(e - s for s, e, n in spans if n in READERS[name]) / 1e6 / JOBS
        got = _reader(name).read(run)
        assert got is not None and got > 0, name
        assert got == pytest.approx(want, rel=1e-6), name


def test_readers_read_none_without_their_spans(traced):
    case, path = traced
    for name in READERS:
        assert _reader(name).read(types.SimpleNamespace(trace=None, jobs=JOBS)) is None
        # a span that some job lost reads nothing, never less time
        assert _reader(name).read(_stand_in(path, jobs=JOBS + 1)) is None
    if case != "xxl":
        assert _reader("strata_relabel_s").read(_stand_in(path)) is None


def test_readers_read_none_on_an_empty_trace(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": bench_trace.JOB, "ts": 0, "dur": 10}]}))
    run = types.SimpleNamespace(trace=bench_trace.Trace(str(path)), jobs=1)
    for name in READERS:
        assert _reader(name).read(run) is None


# ---------------------------------------------------------------------------
# Once-a-process totals
# ---------------------------------------------------------------------------


def _total(name):
    return dict(metrics.TOTALS.get(name, dict(seconds=0.0, runs=0, compiles=0)))


def test_native_build_total_counts_gxx_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    before = _total("native.build")
    so = native.build(native.SCHEDULE_SRC)
    first = _total("native.build")
    assert so.parent == tmp_path and so.exists()
    assert first["runs"] == before["runs"] + 1
    assert first["compiles"] == before["compiles"] + 1
    assert first["seconds"] > before["seconds"]
    native.build(native.SCHEDULE_SRC)           # built: a run, no g++
    again = _total("native.build")
    assert (again["runs"], again["compiles"]) == (first["runs"] + 1, first["compiles"])


def test_native_load_counts_once_with_its_build(tmp_path, monkeypatch):
    """schedule_lib's first call builds inside its load: one run, one g++
    run, and one ``native.build`` span in the trace."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_schedule", dict(lib=None, tried=False, error=None))
    before = _total("native.build")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert native.schedule_lib() is not None
        native.schedule_lib()                   # loaded: not timed again
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    after = _total("native.build")
    assert after["runs"] == before["runs"] + 1
    assert after["compiles"] == before["compiles"] + 1
    assert [s[2] for s in _spans(tmp_path / "t.json")] == ["native.build"]
    got = _reader("native_build_s").read(None)
    assert got == pytest.approx(after["seconds"] + _total("kernels.build")["seconds"])


def test_kernels_build_total_with_the_libraries_in_place(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    for so in kernels.library_paths():
        so.touch()
    before = _total("kernels.build")
    assert kernels.build() == kernels.library_paths()
    after = _total("kernels.build")
    assert after["runs"] == before["runs"] + 1 and after["compiles"] == before["compiles"]
    assert after["seconds"] > before["seconds"]


def test_timed_nested_in_itself_counts_once():
    before = _total("test.once")
    with metrics.timed("test.once") as total:
        with metrics.timed("test.once") as inner:
            assert inner is total
            total["compiles"] += 2
    after = _total("test.once")
    assert after["runs"] == before["runs"] + 1 and after["compiles"] == before["compiles"] + 2
    with pytest.raises(RuntimeError):
        with metrics.timed("test.once"):
            raise RuntimeError("a failed build still counts its time")
    assert _total("test.once")["runs"] == after["runs"] + 1
    metrics.TOTALS.pop("test.once")
