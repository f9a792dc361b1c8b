"""Seconds a job spends filling its strata run's slot arrays and copying
the run's state to the card: the program's span ``strata.upload``, from
the trace."""

from portbench.metrics._program_spans import per_job


def read(run):
    return per_job(run, ("strata.upload",))
