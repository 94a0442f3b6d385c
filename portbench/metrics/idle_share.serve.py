"""idle_share.serve: % of the window's mean request time in which the device
ran nothing, its busy time a request from the profile pass."""
from portbench.harness import readers


def read(run):
    return readers.idle_share(run)
