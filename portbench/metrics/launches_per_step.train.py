"""launches_per_step.train: device kernels a step in the profile pass (a count;
copies and fills left out)."""
from portbench.harness import readers


def read(run):
    return readers.launches_per_unit(run)
