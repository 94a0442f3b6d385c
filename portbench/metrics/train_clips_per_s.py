"""train_clips_per_s: clips trained in the window over its time (host clock)."""
from portbench.harness import readers


def read(run):
    return readers.clips_per_s(run)
