"""backward_ms.train: device ms a step of the activities launched under the
port's span avt.train.backward (zero_grad and the backward, whose kernels
autograd's device thread launches while the span is open)."""
from portbench.harness import spans


def read(run):
    return spans.device_ms(run, "avt.train.backward")
