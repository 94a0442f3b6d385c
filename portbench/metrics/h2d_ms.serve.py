"""h2d_ms.serve: host ms a request inside the port's span
avt.preprocess.upload: the frames' copy from the host to the card."""
from portbench.harness import spans


def read(run):
    return spans.host_ms(run, "avt.preprocess.upload")
