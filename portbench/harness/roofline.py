"""The chip's published peaks and the roofline arithmetic.

One NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16 on the tensor
cores, 495 TFLOP/s TF32, 3.35 TB/s of HBM. An f32 configuration is held
to the TF32 peak: the port's own f32 kernels run their products on the
tensor cores (three TF32 products each), so a share of the 67 TFLOP/s FMA
peak could pass 100%.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory rate and operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
