"""Attention dispatch: the hand-written CUDA kernels where the JAX package
picks Pallas, plain tensor math elsewhere.

Counterpart of avt_tpu/ops/attention.py, with "CUDA" in place of "TPU". The
ViT backbone (frames x 197 tokens) goes through the packed kernel
(ops/flash_attention.py), or, asked for with use_kernel=True, the kernel
that also computes the qkv projection. AVT-h attends over one token per observed
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
    """qkv projection + attention: x (N, T, C) @ kernel (C, 3C') + bias, then
    multi-head attention over num_heads heads of C'/num_heads; returns (N,
    T, C'). C' is C but for a tensor-parallel rank's local heads. The
    projection is rounded to x's type before the bias add, as flax's Dense
    does.

    use_kernel=True is the counterpart of `use_pallas=True`: the fused
    kernel, with the projection inside it (its plain version on the CPU).
    As in the JAX package it exists for head dim 64 and an even head count
    only; any other geometry takes the split path. None (the default, as in
    JAX) is the split path: on CUDA, for T >= 64 and head-pair geometry, the
    bias add goes into the packed kernel's loads."""
    N, T, C = x.shape
    head_dim = kernel.shape[-1] // 3 // num_heads
    if use_kernel and head_dim == fa.FUSED_HEAD_DIM and num_heads % 2 == 0:
        return fa.fused_qkv_attention(x, kernel, bias, num_heads, causal)
    qkv = torch.matmul(x, kernel.to(x.dtype))
    packed = (
        x.device.type == "cuda" and T >= 64 and head_dim == 64 and num_heads % 2 == 0
    )
    if packed:
        return fa.packed_qkv_bias_attention(qkv, bias, num_heads, causal)
    return packed_attention(qkv + bias.to(x.dtype), num_heads, causal=causal)


def multi_head_attention(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    num_heads: int,
    *,
    bq: Optional[torch.Tensor] = None,
    bk: Optional[torch.Tensor] = None,
    bv: Optional[torch.Tensor] = None,
    bo: Optional[torch.Tensor] = None,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Functional MHA: projections + attention + output projection.

    x_q (B, Tq, C) attends over x_kv (B, Tk, C); Tq and Tk may differ (a
    causal mask keeps key j for query i when j <= i, as the JAX package's).
    Weights wq/wk/wv (C, C'), wo (C', C), applied as x @ w; returns (B, Tq,
    C). The attention goes through `dot_product_attention`, so on CUDA, for
    128 or more query tokens and no mask, through the flash kernels (and
    their backward under autograd)."""
    B, T, _ = x_q.shape
    head_dim = wq.shape[1] // num_heads

    def linear(x, w, b):
        y = x @ w
        return y if b is None else y + b

    def heads(x, w, b):
        return linear(x, w, b).reshape(x.shape[0], x.shape[1], num_heads, head_dim)

    out = dot_product_attention(heads(x_q, wq, bq), heads(x_kv, wk, bk), heads(x_kv, wv, bv),
                                causal=causal, mask=mask)
    return linear(out.reshape(B, T, num_heads * head_dim), wo, bo)
