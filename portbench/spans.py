"""Host spans around the program's layers, recorded from the benchmark's
own files (the program has no spans of its own yet).

``Spans.install`` wraps module or class attributes of the program: each
call runs inside ``torch.profiler.record_function(name)`` (so the trace
holds it on the kernels' clock) and is timed on the host clock, with a
``torch.cuda.synchronize()`` before the clock stops, so that a span holds
the device work it queued.  Only traced runs install them.

A span point is "module:attribute" or "module:Class.attribute".
"""

from __future__ import annotations

import functools
import importlib
import time

import torch

# The spans the breakdown labels idle gaps with; a metric reader may add
# its own (its SPANS list).
STANDARD = {
    "init_layout": "odgi_tpu_torch.algorithms.layout:init_layout",
    "pack_components": "odgi_tpu_torch.algorithms.layout:pack_components",
    "StrataState.build": "odgi_tpu_torch.ops.strata_sgd:StrataState.build",
    "StrataState.run": "odgi_tpu_torch.ops.strata_sgd:StrataState.run",
    "apply_groom": "odgi_tpu_torch.algorithms.path_sgd_sort:apply_groom",
    "topological_order": "odgi_tpu_torch.algorithms.path_sgd_sort:topological_order",
    "apply_ordering": "odgi_tpu_torch.core.graph:GraphTensors.apply_ordering",
}


class Spans:
    def __init__(self, points: dict, device):
        self.points = points
        self.sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        self.job = -1
        self.records = []      # (name, job, seconds)
        self._undo = []

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.sync()
                    self.records.append((name, self.job, time.perf_counter() - t0))
        return wrapper

    def install(self) -> None:
        for name, point in self.points.items():
            mod, attr = point.split(":")
            owner = importlib.import_module(mod)
            *path, leaf = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            raw = owner.__dict__[leaf] if isinstance(owner, type) else getattr(owner, leaf)
            if isinstance(raw, staticmethod):
                new = staticmethod(self._wrap(name, raw.__func__))
            else:
                new = self._wrap(name, raw)
            setattr(owner, leaf, new)
            self._undo.append((owner, leaf, raw))

    def uninstall(self) -> None:
        for owner, leaf, raw in reversed(self._undo):
            setattr(owner, leaf, raw)
        self._undo.clear()

    def per_job(self, jobs: int, *names) -> list:
        """Seconds in the named spans in each of the window's `jobs` jobs
        (names that never run inside one another)."""
        out = [0.0] * jobs
        for name, j, s in self.records:
            if name in names and j >= 0:
                out[j] += s
        return out
