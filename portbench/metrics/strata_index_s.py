"""Seconds a job spends on the host indexes of its strata run: the
program's spans ``strata.chunk_schedule`` (the conflict levels and
predecessors), ``strata.merge_index`` (the merge CSR) and, on the xxl
route only, ``strata.block_schedule``, from the trace."""

from portbench.metrics._program_spans import per_job


def read(run):
    return per_job(run, ("strata.chunk_schedule", "strata.merge_index", "strata.block_schedule"),
                   every_job=("strata.chunk_schedule", "strata.merge_index"))
