"""Structured run metrics, profiler traces and the program's own spans.

The counterpart of ``odgi_tpu/utils/metrics.py``:

- `--metrics FILE`: JSONL records, one an iteration {kind, iter, wall_s,
  delta_max} (layout: the per-iteration callback takes the run onto the
  batched path, as `-u` does) and a final run-summary line.
  ``StepMetrics`` writes the same records with the same keys as
  ``odgi_tpu``'s.
- `--profile DIR`: wraps the optimization in ``torch.profiler.profile``
  (CPU activities, and CUDA ones when the run is on the card) and writes
  its Chrome trace (``*.pt.trace.json``) into DIR, where ``odgi_tpu``
  writes a ``jax.profiler`` trace.  The trace holds the program's spans.

Spans.  ``span(name)`` marks a layer of the program (``strata.build``,
``strata.plan``, ``sort.groom``, ...; PERF.md §3 lists them), as a
context manager or a decorator.  While a ``torch.profiler`` records, it
enters ``torch.profiler.record_function(name)``: the span lands in the
trace as a ``user_annotation`` event on the kernels' clock, nested in its
parent span.  Otherwise it costs the profiler's enabled-flag check and
hands out one shared no-op a name.  Spans time the host and never
synchronize the device; they mark layers, never a merge group or a launch.
``timed(name)`` wraps a step that runs once a process (the kernels' and
the native libraries' build and load, ``kernels.build`` /
``native.build``): it is a span too, and always adds its host seconds and
a run to ``TOTALS[name]``, since those steps run before any profiler
starts; the step adds its compiler runs to the total's ``compiles``.
``count(name, n=1)`` adds `n` runs alone, once a call of the step it
counts, never inside a per-node loop: which path a step took
(``strata.steps_native`` / ``strata.steps_numpy``, a pass over a strata
run's step table in C++ or in numpy; ``strata.route.<route>``, the route
of a PG-SGD run) or how much structural work a host pass did
(``groom.flipped`` / ``groom.restarts``, ``topological_order.seeded`` /
``topological_order.restarts``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from typing import Optional

import numpy as np
import torch


class StepMetrics:
    """Collects per-iteration (or run-summary) records and writes JSONL."""

    def __init__(self, path: str, kind: str):
        self.path = path
        self.kind = kind
        self.t0 = time.time()
        self.records: list = []
        self._last = None

    def record_iteration(self, it: int, coords):
        """`coords`: the host array the run's per-iteration callback gets."""
        c = np.asarray(coords, dtype=float)
        dmax = (
            float(np.abs(c - self._last).max()) if self._last is not None else None
        )
        self._last = c
        rec = {
            "kind": self.kind,
            "iter": int(it),
            "wall_s": round(time.time() - self.t0, 4),
        }
        if dmax is not None:
            rec["delta_max"] = round(dmax, 6)
        self.records.append(rec)

    def record_summary(self, **fields):
        rec = {"kind": f"{self.kind}_summary",
               "wall_s": round(time.time() - self.t0, 4)}
        rec.update(fields)
        self.records.append(rec)

    def write(self):
        with open(self.path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], device: torch.device):
    """torch.profiler over the block when `trace_dir` is given (CUDA
    activities too when `device` is the card), its Chrome trace, with the
    program's spans, written into `trace_dir` on exit; else a no-op."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


# The profiler's enabled flag: true exactly while a torch.profiler (or the
# autograd profiler) records.
_recording = torch._C._autograd._profiler_enabled


class _Span:
    """One name's span while no profiler records: a no-op context, the
    one `span` hands out for that name, and a decorator whose wrapper
    checks the flag at every call and opens the span only when on."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned


class _Recorded(_Span):
    """`span(name)` while a profiler records: record_function(name)."""

    __slots__ = ("_rf",)

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        return self._rf.__enter__()

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)


_OFF: dict = {}


def span(name: str) -> _Span:
    """The program's span `name`: ``with span(name):`` or ``@span(name)``
    (see the module docstring)."""
    if _recording():
        return _Recorded(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Span(name)
    return off


# name -> {"seconds", "runs", "compiles"} of each once-a-process step, and
# the runs of each counted step (`count`)
TOTALS: dict = {}
_held = threading.local()


def count(name: str, n: int = 1) -> None:
    """`n` runs of the counted step `name` in ``TOTALS[name]`` (no time)."""
    TOTALS.setdefault(name, dict(seconds=0.0, runs=0, compiles=0))["runs"] += int(n)


@contextlib.contextmanager
def timed(name: str):
    """A step that runs once a process, inside `span(name)`: its host
    seconds and one run are added to ``TOTALS[name]``, which it yields
    (the step adds its compiler runs to ``["compiles"]``).  Inside itself
    (a build inside the load that calls it) it counts once, outermost."""
    total = TOTALS.setdefault(name, dict(seconds=0.0, runs=0, compiles=0))
    held = _held.__dict__.setdefault("names", set())
    if name in held:
        yield total
        return
    held.add(name)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield total
    finally:
        held.discard(name)
        total["seconds"] += time.perf_counter() - t0
        total["runs"] += 1
