"""optimizer_ms.train: device ms a step of the kernels under the
portbench.optimizer range around the optimizer's step."""
from portbench.harness import readers


def read(run):
    return readers.range_ms(run, 'portbench.optimizer')
