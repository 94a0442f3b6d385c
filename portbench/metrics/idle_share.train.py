"""idle_share.train: % of the window's mean step time in which the device ran
nothing, its busy time a step from the profile pass."""
from portbench.harness import readers


def read(run):
    return readers.idle_share(run)
