"""The share of the traced jobs' span in which no CUDA kernel ran, in %:
1 - (the union of the kernel intervals) / (the span from the first job's
start to the last job's end).  Nothing is read where the trace lost kernel
records."""


def read(run):
    t = run.trace
    if t is None or not t.complete(run.launches) or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
