"""Packed short-sequence attention, forward: the ViT hot path.

Counterpart of avt_tpu/ops/flash_attention.py's packed kernels
(`_short_fwd_kernel_paired`, `_short_fwd_kernel`, launched by
`_short_attention_fwd_call`). Attention runs straight off the fused qkv
projection (N, T, 3C) -> (N, T, C), reading it in place, one whole sequence
per frame and head.

On a CUDA tensor the wrappers launch the hand-written Hopper kernel
`csrc/short_attention_fwd.cu` (bf16 or f32 storage, head dim 32, 64 or 128)
or raise; on a CPU tensor they run `packed_short_attention_reference`, the
plain PyTorch version with the same arithmetic order. There is no fallback
from one to the other. The backward kernels come with training.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from avt_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
NEG_INF = -1e30
KERNEL = "short_attention_fwd"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


@functools.lru_cache(maxsize=None)
def _storage_scale(head_dim: int, dtype: torch.dtype) -> float:
    """sm_scale*log2(e) rounded to the storage type: the TPU kernel multiplies
    q by a weakly typed Python float, which takes q's dtype."""
    return float(torch.tensor((1.0 / math.sqrt(head_dim)) * LOG2E, dtype=dtype))


def _split_heads(qkv: torch.Tensor, num_heads: int):
    N, T, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    q, k, v = qkv.split(C, dim=-1)
    return [x.reshape(N, T, num_heads, D).transpose(1, 2) for x in (q, k, v)]


def packed_short_attention_reference(
    qkv: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Plain version of the kernel, in the head-pair TPU kernel's order: q
    scaled in the storage type, f32 scores, exp2 against the row max, p
    rounded to the storage type for an f32-accumulated PV, then 1/l."""
    N, T, C3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    D = q.shape[-1]
    q = q * torch.tensor(_storage_scale(D, dt), dtype=dt, device=qkv.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(dt).float(), v.float()) * (1.0 / l)
    return o.to(dt).transpose(1, 2).reshape(N, T, C3 // 3)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = _build.load(KERNEL).short_attention_fwd
    # (qkv, bias, out, N, T, H, D, is_bf16, causal, scale, stream)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(qkv: torch.Tensor, bias, num_heads: int, causal: bool) -> torch.Tensor:
    if qkv.device.type != "cuda":
        raise RuntimeError(
            f"{KERNEL} runs on CUDA tensors (or, through its plain version, on "
            f"CPU tensors); got a tensor on {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{KERNEL}: qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)} "
                         f"for {num_heads} heads")
    N, T, C3 = qkv.shape
    D = C3 // (3 * num_heads)
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{KERNEL}: storage type must be bfloat16 or float32, got {qkv.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head dim {D} is not one the kernel is built for {HEAD_DIMS}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: qkv must be contiguous and 16-byte aligned")
    if bias is not None:
        if (bias.shape != (C3,) or bias.dtype != qkv.dtype or bias.device != qkv.device
                or not bias.is_contiguous() or bias.data_ptr() % 16):
            raise ValueError(f"{KERNEL}: bias must be a contiguous, 16-byte aligned "
                             f"({C3},) {qkv.dtype} tensor on {qkv.device}")
    out = torch.empty((N, T, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    if N == 0 or T == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = _kernel()(qkv.data_ptr(), None if bias is None else bias.data_ptr(),
                        out.data_ptr(), N, T, num_heads, D, _DTYPES[qkv.dtype], int(causal),
                        _storage_scale(D, qkv.dtype), torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(KERNEL), err, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return out


def packed_short_attention(
    qkv: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention straight off the packed qkv projection: qkv (N, T, 3*H*D),
    thirds q, k, v; returns (N, T, H*D)."""
    if qkv.device.type == "cpu":
        return packed_short_attention_reference(qkv, num_heads, causal)
    return _launch(qkv, None, num_heads, causal)


def packed_qkv_bias_attention(
    qkv_nobias: torch.Tensor, bias: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """The qkv bias add in the storage type, then the attention. The kernel
    adds the bias as it loads q, k and v, so the biased qkv never goes
    through device memory."""
    bias_c = bias.to(qkv_nobias.dtype)
    if qkv_nobias.device.type == "cpu":
        return packed_short_attention_reference(qkv_nobias + bias_c, num_heads, causal)
    return _launch(qkv_nobias, bias_c.contiguous(), num_heads, causal)
