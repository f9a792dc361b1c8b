"""Reading a ``torch.profiler`` trace of the window: kernel intervals, the
device's busy time, the benchmark's spans, and the breakdown.

``busy`` is the copy of ``chip_smoke.py``'s ``trace_busy``: the union of the
CUDA kernel intervals over a span, and a completeness check of the trace
against the program's launch counter (``ops.kernels.LAUNCHES``): when the
trace holds fewer launches of a strata kernel than the wrappers counted,
CUPTI dropped records and no busy share stands.
"""

from __future__ import annotations

import collections
import json
import re

JOB = "portbench.job"


class Trace:
    def __init__(self, path: str):
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        self.kernels = sorted((float(e["ts"]), float(e["dur"]), e.get("name", ""))
                              for e in events if e.get("cat") == "kernel")
        self.spans = sorted((float(e["ts"]), float(e["dur"]), e.get("name", ""))
                            for e in events if e.get("cat") == "user_annotation")
        jobs = [s for s in self.spans if s[2] == JOB]
        self.lo = jobs[0][0] if jobs else 0.0
        self.hi = max((t + d for t, d, _ in jobs), default=0.0)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def inside(self) -> list:
        """The kernels that start in the traced jobs' span."""
        return [k for k in self.kernels if self.lo <= k[0] < self.hi]

    def kernel_s(self) -> float:
        """Summed kernel time in the traced jobs, every kernel alike."""
        return sum(d for _, d, _ in self.inside()) / 1e6

    def busy_intervals(self) -> list:
        """The union of the kernel intervals, clipped to the jobs' span."""
        out = []
        for ts, dur, _ in self.inside():
            lo, hi = ts, min(ts + dur, self.hi)
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def complete(self, launches: dict) -> bool:
        """Whether the trace holds every strata kernel launch the program's
        wrappers counted in the window."""
        traced = collections.Counter()
        for _, _, name in self.inside():
            m = re.search(r"::(strata_\w+?)_kernel[<(]", name)
            if m:
                traced[m.group(1)] += 1
        return all(traced.get(n, 0) >= c for n, c in launches.items() if c)

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for _, dur, name in self.inside():
            by[_short(name)] += dur / 1e6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time between kernels, summed by what the host was doing: the
        innermost benchmark span (with its parents) over each stretch of a
        gap."""
        gaps, end = [], self.lo
        for lo, hi in self.busy_intervals():
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
        if self.hi > end:
            gaps.append((end, self.hi))
        spans = [s for s in self.spans if s[2] != JOB and s[0] < self.hi and s[0] + s[1] > self.lo]
        cuts = sorted({self.lo, self.hi} | {min(max(t, self.lo), self.hi)
                                            for s in spans for t in (s[0], s[0] + s[1])})
        by = collections.Counter()
        g = 0
        for a, b in zip(cuts[:-1], cuts[1:]):
            held = [s for s in spans if s[0] <= a and s[0] + s[1] >= b]
            label = ">".join(s[2] for s in sorted(held, key=lambda s: -s[1])) or "between spans"
            while g < len(gaps) and gaps[g][1] <= a:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < b:
                by[label] += (min(b, gaps[k][1]) - max(a, gaps[k][0])) / 1e6
                k += 1
        return [[n, s] for n, s in by.most_common(top)]


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template and argument lists."""
    bare = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.sub(r"[<(].*", "", bare)[:96] or name[:96]
