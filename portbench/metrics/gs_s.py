"""Seconds a sort job spends in the host graph passes of `gs`: groom and
the topological order (the benchmark's spans around
``path_sgd_sort.apply_groom`` and ``path_sgd_sort.topological_order``)."""


def read(run):
    per = run.spans.per_job(run.jobs, "apply_groom", "topological_order")
    return sum(per) / len(per)
