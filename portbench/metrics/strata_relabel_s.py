"""Seconds a job spends relabelling its graph by first visit before an xxl
strata run: the program's span ``strata.relabel`` (``locality_order``,
``apply_ordering``, ``relabel_coords``), from the trace."""

from portbench.metrics._program_spans import per_job


def read(run):
    return per_job(run, ("strata.relabel",))
