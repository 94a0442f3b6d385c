"""preprocess_ms.serve: device ms a request of the activities launched
under the port's span avt.preprocess.eval (VideoPreprocessor.eval_fn, the
frames' upload included)."""
from portbench.harness import spans


def read(run):
    return spans.device_ms(run, "avt.preprocess.eval")
