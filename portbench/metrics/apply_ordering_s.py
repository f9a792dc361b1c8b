"""Seconds a job spends renumbering its graph: the program's spans
``graph.apply_ordering`` (``GraphTensors.apply_ordering``), from the trace.
A sort renumbers after its Y pass and after its topological order; on the
xxl route the relabel before the strata run renumbers too, inside
``strata.relabel``."""

from portbench.metrics._program_spans import per_job


def read(run):
    return per_job(run, ("graph.apply_ordering",))
