"""preprocess_ms.train: device ms a step of the activities launched under
the port's span avt.preprocess.train (VideoPreprocessor.train_fn)."""
from portbench.harness import spans


def read(run):
    return spans.device_ms(run, "avt.preprocess.train")
