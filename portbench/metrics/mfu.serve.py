"""mfu.serve: % of the dtype's peak of the forward FLOPs of every view of every
clip served in the window, over its time."""
from portbench.harness import readers


def read(run):
    return readers.mfu(run)
