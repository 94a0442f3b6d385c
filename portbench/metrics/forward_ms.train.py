"""forward_ms.train: device ms a step of the activities launched under the
port's span avt.train.forward (the model, its losses and their weighted sum)."""
from portbench.harness import spans


def read(run):
    return spans.device_ms(run, "avt.train.forward")
