"""Attention ops: dispatch (attention.py) and the packed CUDA kernel
(flash_attention.py, csrc/)."""
from avt_tpu_torch.ops.attention import (
    dot_product_attention,
    fused_qkv_attention,
    packed_attention,
)

__all__ = ["dot_product_attention", "fused_qkv_attention", "packed_attention"]
