"""host_dispatch_ms.train: host ms a step inside the port's span
avt.train.step, less the union of the synchronising runtime calls inside
it (harness/spans.py SYNC_CALLS): the host's time spent queuing the step."""
from portbench.harness import spans


def read(run):
    return spans.unsynced_ms(run, "avt.train.step")
