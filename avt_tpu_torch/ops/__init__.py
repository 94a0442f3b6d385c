"""Attention ops: dispatch (attention.py) and the CUDA kernels, packed and
flash (flash_attention.py, csrc/)."""
from avt_tpu_torch.ops.attention import (
    dot_product_attention,
    fused_qkv_attention,
    multi_head_attention,
    packed_attention,
)

__all__ = ["multi_head_attention", "dot_product_attention", "fused_qkv_attention",
           "packed_attention"]
