"""The shared part of the readers of the program's own spans
(``odgi_tpu_torch/utils/metrics.py`` ``span``): seconds a traced job spends
in some of them, read from the trace."""


def per_job(run, names, every_job=None):
    """The summed durations of the trace's spans named in `names` that
    start inside the traced jobs, over the jobs, in seconds.  None without
    a trace, or where a span of `every_job` (default: each of `names`)
    appears fewer times than there are jobs: a lost span never reads as a
    gain."""
    t = run.trace
    if t is None or run.jobs < 1:
        return None
    found = [(name, dur) for ts, dur, name in t.spans if name in names and t.lo <= ts < t.hi]
    for name in names if every_job is None else every_job:
        if sum(n == name for n, _ in found) < run.jobs:
            return None
    return sum(dur for _, dur in found) / 1e6 / run.jobs
