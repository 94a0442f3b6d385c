"""Attention dispatch: the hand-written CUDA kernels where the JAX package
picks Pallas, plain tensor math elsewhere.

Counterpart of avt_tpu/ops/attention.py, with "CUDA" in place of "TPU". The
ViT backbone (frames x 197 tokens) goes through the packed kernel
(ops/flash_attention.py). AVT-h attends over one token per observed
feature: at 128 tokens or more without a mask it goes through the blocked
flash kernel (`flash_attention`), as the JAX package takes `_flash_kernel`;
the shipped 10-token contexts, which the JAX package leaves to XLA, run
plain tensor code mirroring `jax.nn.dot_product_attention` (f32 logits and
softmax).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from avt_tpu_torch.ops import flash_attention as fa

# Below this many query tokens the plain path runs (the JAX package's
# _PALLAS_MIN_SEQ).
KERNEL_MIN_SEQ = 128


def _plain_attention(q, k, v, causal: bool, mask: Optional[torch.Tensor]):
    """(B, T, H, D) attention as jax.nn.dot_product_attention computes it:
    logits and softmax in f32, probabilities cast to the value type."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    if causal or mask is not None:
        keep = torch.ones(logits.shape[-2:], dtype=torch.bool, device=q.device)
        if causal:
            keep = keep.tril()
        if mask is not None:
            keep = keep & mask
        logits = logits.masked_fill(~keep, -0.7 * torch.finfo(torch.float32).max)
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over (B, T, H, D) tensors.

    mask: optional boolean mask broadcastable to (B, H, Tq, Tk); True=keep.
    use_kernel: the counterpart of `use_pallas`. None selects the flash
    kernel on CUDA for 128 or more query tokens and no mask; True runs
    `flash_attention` on any device (its plain version on the CPU, as the
    JAX package interprets its kernel off the TPU), and takes no mask.
    """
    if use_kernel is None:
        use_kernel = q.device.type == "cuda" and q.shape[1] >= KERNEL_MIN_SEQ and mask is None
    if use_kernel:
        if mask is not None:
            raise ValueError("the flash-attention kernel takes no mask")
        return fa.flash_attention(q, k, v, causal)
    return _plain_attention(q, k, v, causal, mask)


def packed_attention(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    causal: bool = False,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Attention straight off a fused qkv projection (N, T, 3*C) -> (N, T, C).

    On CUDA with T >= 64 (or use_kernel=True) it runs the packed kernel,
    which reads the array in place; otherwise plain attention on split
    tensors."""
    N, T, C3 = qkv.shape
    C = C3 // 3
    head_dim = C // num_heads
    if use_kernel is None:
        use_kernel = qkv.device.type == "cuda" and T >= 64
    if use_kernel:
        return fa.packed_short_attention(qkv, num_heads, causal)
    q, k, v = (x.reshape(N, T, num_heads, head_dim) for x in qkv.split(C, dim=-1))
    return _plain_attention(q, k, v, causal, None).reshape(N, T, C)


def fused_qkv_attention(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    *,
    causal: bool = False,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """qkv projection + attention: x (N, T, C) @ kernel (C, 3C) + bias, then
    multi-head attention; returns (N, T, C). The projection is rounded to
    x's type before the bias add, as flax's Dense does.

    use_kernel=True is the counterpart of `use_pallas=True`, the kernel with
    the projection inside it, which is not ported yet. On CUDA, for T >= 64
    and head-pair geometry (head dim 64, even head count), the bias add goes
    into the packed kernel's loads."""
    if use_kernel:
        raise NotImplementedError(
            "the fused projection+attention kernel (avt_tpu "
            "_fused_qkv_attn_fwd_kernel) is not ported yet")
    N, T, C = x.shape
    head_dim = C // num_heads
    qkv = torch.matmul(x, kernel.to(x.dtype))
    packed = (
        x.device.type == "cuda" and T >= 64 and head_dim == 64 and num_heads % 2 == 0
    )
    if packed:
        return fa.packed_qkv_bias_attention(qkv, bias, num_heads, causal)
    return packed_attention(qkv + bias.to(x.dtype), num_heads, causal=causal)
