"""Seconds a job spends in the host set-up of its strata run,
``StrataState.build`` (relabel, plan, merge index, chunk schedule, block
schedule, copies to the card), up to a synchronize of the device."""


def read(run):
    per = run.spans.per_job(run.jobs, "StrataState.build")
    return sum(per) / len(per)
