"""Seconds a sort job spends in its Y pass: the program's span
``sort.path_sgd`` (``sort_pipeline``: the 1D PG-SGD run with its strata
set-up and its relabel on the xxl route, the copy of the positions to the
host and the order by them), from the trace."""

from portbench.metrics._program_spans import per_job


def read(run):
    return per_job(run, ("sort.path_sgd",))
