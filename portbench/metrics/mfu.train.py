"""mfu.train: % of the dtype's peak (bf16 989, f32 495 TFLOP/s TF32) of the
model FLOPs of the window's train steps (3 forwards a clip) over its time."""
from portbench.harness import readers


def read(run):
    return readers.mfu(run)
