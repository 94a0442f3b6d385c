"""syncs_per_step.train: synchronising runtime calls a step (a count)
that began inside the port's span avt.train.step (harness/spans.py
SYNC_CALLS and the blocking copies)."""
from portbench.harness import spans


def read(run):
    return spans.syncs_per_unit(run, "avt.train.step")
