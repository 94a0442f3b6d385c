"""request_p95_ms: the 95th percentile (nearest rank) of every request's
latency in the window, from the call to the logits on the host."""
from portbench.harness.traffic import p95


def read(run):
    return 1e3 * p95(run.window["latencies"])
