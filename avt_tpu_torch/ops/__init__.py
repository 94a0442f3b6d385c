"""Attention ops: dispatch (attention.py) and the CUDA kernels, packed and
flash (flash_attention.py, csrc/); the f32 dense layers' kernel (dense.py).
Importing the package registers every custom op."""
from avt_tpu_torch.ops.attention import (
    dot_product_attention,
    fused_qkv_attention,
    multi_head_attention,
    packed_attention,
)
from avt_tpu_torch.ops.dense import dense_f32

__all__ = ["multi_head_attention", "dot_product_attention", "fused_qkv_attention",
           "packed_attention", "dense_f32"]
