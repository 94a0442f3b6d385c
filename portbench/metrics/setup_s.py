"""setup_s: from the process's start to the window: imports, the kernels' load
(their build in a fresh checkout), weights, inputs, the check steps and the
warm-up."""


def read(run):
    return run.setup_s
