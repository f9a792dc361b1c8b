"""Seconds a job spends planning its strata run: the program's span
``strata.plan`` (``ops/strata_plan.py`` ``plan_run``: the slot count, the
chunk scalars and the valid-pair counts; the slot planes are filled on the
card in ``strata.upload``), from the trace."""

from portbench.metrics._program_spans import per_job


def read(run):
    return per_job(run, ("strata.plan",))
