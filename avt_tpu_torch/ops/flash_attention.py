"""Packed short-sequence attention, forward and backward: the ViT hot path.

Counterpart of avt_tpu/ops/flash_attention.py's packed kernels: the forward
(`_short_fwd_kernel_paired`, `_short_fwd_kernel`, launched by
`_short_attention_fwd_call`) and the recompute backward
(`_short_bwd_kernel_paired`, `_short_bwd_kernel`, launched by
`_short_attention_bwd_call` and, with the qkv-bias gradient,
`_short_attention_bwd_db_call`). Attention runs straight off the fused qkv
projection (N, T, 3C) -> (N, T, C), reading it in place, one whole sequence
per frame and head; the backward writes one packed dqkv (N, T, 3C).

Both entry points are `torch.autograd.Function`s. On a CUDA tensor they
launch the hand-written Hopper kernels `csrc/short_attention_fwd.cu` and
`csrc/short_attention_bwd.cu` (bf16 or f32 storage, head dim 32, 64 or 128)
or raise; on a CPU tensor they run the plain PyTorch versions
`packed_short_attention_reference` and `packed_short_attention_bwd_reference`,
which follow the head-pair TPU kernels' arithmetic order. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from avt_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
NEG_INF = -1e30
KERNEL = "short_attention_fwd"
BWD_KERNEL = "short_attention_bwd"
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


def packed_short_attention_bwd_reference(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, causal: bool = False,
    with_db: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the backward kernel: (dqkv (N, T, 3C) in the storage
    type, db (3C) f32 or None), in `_short_bwd_kernel_paired`'s order: the
    probabilities recomputed, 1/l kept out of the (T, T) products (it scales
    dq's result and the q' and dO operands of dk and dv, rounded), ds and p
    rounded to the storage type for the products, f32 accumulation. db sums
    the rounded dqkv over frames and rows."""
    N, T, C3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    D = q.shape[-1]
    do = dout.reshape(N, T, num_heads, D).transpose(1, 2)
    qs = q * torch.tensor(_storage_scale(D, dt), dtype=dt, device=qkv.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    inv_l = 1.0 / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True) * inv_l
    ds = (p * (dp - delta)).to(dt).float()
    inv_l_c = inv_l.to(dt)
    dq = torch.matmul(ds, k.float()) * (inv_l * (1.0 / math.sqrt(D)))
    dk = torch.matmul(ds.transpose(-1, -2), (qs * inv_l_c).float()) * (1.0 / LOG2E)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), (do * inv_l_c).float())
    dqkv = torch.cat([x.to(dt).transpose(1, 2).reshape(N, T, C3 // 3) for x in (dq, dk, dv)],
                     dim=-1)
    db = dqkv.float().sum(dim=(0, 1)) if with_db else None
    return dqkv, db


def _check_qkv(name: str, qkv: torch.Tensor, num_heads: int) -> int:
    """Validates a packed qkv for a kernel; returns the head dim."""
    if qkv.device.type != "cuda":
        raise RuntimeError(
            f"{name} runs on CUDA tensors (or, through its plain version, on "
            f"CPU tensors); got a tensor on {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name}: qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)} "
                         f"for {num_heads} heads")
    D = qkv.shape[-1] // (3 * num_heads)
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name}: storage type must be bfloat16 or float32, got {qkv.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not one the kernel is built for {HEAD_DIMS}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    return D


def _check_operand(name: str, what: str, x: Optional[torch.Tensor], shape, qkv: torch.Tensor):
    if x is not None and (x.shape != shape or x.dtype != qkv.dtype or x.device != qkv.device
                          or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned "
                         f"{tuple(shape)} {qkv.dtype} tensor on {qkv.device}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The forward's C entry point, built and loaded at first use."""
    fn = _build.load(KERNEL).short_attention_fwd
    # (qkv, bias, out, N, T, H, D, is_bf16, causal, scale, stream)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """The backward's C entry points (launch, tiles), built at first use."""
    lib = _build.load(BWD_KERNEL)
    fn = lib.short_attention_bwd
    # (qkv, bias, dout, dqkv, stats, partials, db, N, T, H, D, is_bf16, causal,
    #  scale, sm_scale, stream)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tiles = lib.short_attention_bwd_tiles
    tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    tiles.restype = ctypes.c_int
    return fn, tiles


def _launch(qkv: torch.Tensor, bias, num_heads: int, causal: bool) -> torch.Tensor:
    D = _check_qkv(KERNEL, qkv, num_heads)
    N, T, C3 = qkv.shape
    _check_operand(KERNEL, "bias", bias, (C3,), qkv)
    out = torch.empty((N, T, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    if N == 0 or T == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = _kernel()(qkv.data_ptr(), _ptr(bias), out.data_ptr(), N, T, num_heads, D,
                        _DTYPES[qkv.dtype], int(causal), _storage_scale(D, qkv.dtype),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(KERNEL), err, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return out


def _launch_bwd(qkv: torch.Tensor, bias, dout: torch.Tensor, num_heads: int, causal: bool,
                with_db: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dqkv, db in the storage type or None) from the backward kernel."""
    D = _check_qkv(BWD_KERNEL, qkv, num_heads)
    N, T, C3 = qkv.shape
    _check_operand(BWD_KERNEL, "bias", bias, (C3,), qkv)
    _check_operand(BWD_KERNEL, "dout", dout, (N, T, C3 // 3), qkv)
    dqkv = torch.empty_like(qkv)
    db = torch.zeros(C3, dtype=qkv.dtype, device=qkv.device) if with_db else None
    if N == 0 or T == 0:
        return dqkv, db
    fn, tiles = _bwd_kernel()
    is_bf16 = _DTYPES[qkv.dtype]
    f32 = dict(dtype=torch.float32, device=qkv.device)
    stats = torch.empty((N, num_heads, 3, T), **f32)  # row max, 1/l, delta
    partials = torch.empty((N * tiles(T, is_bf16), C3), **f32) if with_db else None
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), _ptr(bias), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                 _ptr(partials), _ptr(db), N, T, num_heads, D, is_bf16, int(causal),
                 _storage_scale(D, qkv.dtype), 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(BWD_KERNEL), err, BWD_KERNEL)
    _build.launch_counts[BWD_KERNEL] += 1
    return dqkv, db


class _PackedShortAttention(torch.autograd.Function):
    """packed_short_attention with the recompute backward; residual: qkv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.causal = num_heads, causal
        if qkv.device.type == "cpu":
            return packed_short_attention_reference(qkv, num_heads, causal)
        return _launch(qkv, None, num_heads, causal)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        dout = dout.contiguous()
        if qkv.device.type == "cpu":
            dqkv, _ = packed_short_attention_bwd_reference(qkv, dout, ctx.num_heads, ctx.causal)
        else:
            dqkv, _ = _launch_bwd(qkv, None, dout, ctx.num_heads, ctx.causal, with_db=False)
        return dqkv, None, None


class _PackedBiasAttention(torch.autograd.Function):
    """packed_qkv_bias_attention with the bias gradient from the backward
    kernel; residuals: the unbiased qkv and the bias (the kernels add it as
    they load, so the biased qkv is never stored)."""

    @staticmethod
    def forward(ctx, qkv_nobias, bias_c, num_heads, causal):
        ctx.save_for_backward(qkv_nobias, bias_c)
        ctx.num_heads, ctx.causal = num_heads, causal
        if qkv_nobias.device.type == "cpu":
            return packed_short_attention_reference(qkv_nobias + bias_c, num_heads, causal)
        return _launch(qkv_nobias, bias_c, num_heads, causal)

    @staticmethod
    def backward(ctx, dout):
        qkv_nobias, bias_c = ctx.saved_tensors
        dout = dout.contiguous()
        if qkv_nobias.device.type == "cpu":
            dqkv, db = packed_short_attention_bwd_reference(
                qkv_nobias + bias_c, dout, ctx.num_heads, ctx.causal, with_db=True)
            db = db.to(bias_c.dtype)
        else:
            dqkv, db = _launch_bwd(qkv_nobias, bias_c, dout, ctx.num_heads, ctx.causal,
                                   with_db=True)
        return dqkv, db, None, None


def packed_short_attention(
    qkv: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention straight off the packed qkv projection: qkv (N, T, 3*H*D),
    thirds q, k, v; returns (N, T, H*D). Differentiable: the backward is
    the recompute kernel (no db)."""
    return _PackedShortAttention.apply(qkv, num_heads, causal)


def packed_qkv_bias_attention(
    qkv_nobias: torch.Tensor, bias: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """The qkv bias add in the storage type, then the attention. The kernels
    add the bias as they load q, k and v, so the biased qkv never goes
    through device memory; the backward returns the bias gradient in the
    storage type, and the cast to the bias's own type stays outside, as in
    the JAX package."""
    bias_c = bias.to(qkv_nobias.dtype).contiguous()
    return _PackedBiasAttention.apply(qkv_nobias, bias_c, num_heads, causal)
