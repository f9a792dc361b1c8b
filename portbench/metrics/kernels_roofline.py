"""The share of the jobs' summed kernel time that their PG-SGD needs at
least (``count.json``, from the benchmark's own plan of each job), in %.
Every kernel in the traced jobs counts, whatever its name; nothing is read
where the trace lost kernel records."""


def read(run):
    t = run.trace
    if t is None or not t.complete(run.launches):
        return None
    k = t.kernel_s()
    if k <= 0:
        return None
    return 100.0 * sum(run.least_s(s) for s in run.job_seeds) / k
