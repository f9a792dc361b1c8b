"""Structured run metrics and profiler traces for `sort` and `layout`.

The counterpart of ``odgi_tpu/utils/metrics.py``:

- `--metrics FILE`: JSONL records, one an iteration {kind, iter, wall_s,
  delta_max} (layout: the per-iteration callback takes the run onto the
  batched path, as `-u` does) and a final run-summary line.
  ``StepMetrics`` writes the same records with the same keys as
  ``odgi_tpu``'s.
- `--profile DIR`: wraps the optimization in ``torch.profiler.profile``
  (CPU activities, and CUDA ones when the run is on the card) and writes
  its Chrome trace (``*.pt.trace.json``) into DIR, where ``odgi_tpu``
  writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
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
    activities too when `device` is the card), its Chrome trace written
    into `trace_dir` on exit; else a no-op."""
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
