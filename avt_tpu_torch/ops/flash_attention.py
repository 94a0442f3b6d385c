"""Attention kernels: the packed short-sequence attention of the ViT and the
blocked flash attention of AVT-h, forward and backward.

Counterpart of avt_tpu/ops/flash_attention.py. The packed kernels: the
forward (`_short_fwd_kernel_paired`, `_short_fwd_kernel`, launched by
`_short_attention_fwd_call`) and the recompute backward
(`_short_bwd_kernel_paired`, `_short_bwd_kernel`, launched by
`_short_attention_bwd_call` and, with the qkv-bias gradient,
`_short_attention_bwd_db_call`). Attention runs straight off the fused qkv
projection (N, T, 3C) -> (N, T, C), reading it in place, one whole sequence
per frame and head; the backward writes one packed dqkv (N, T, 3C).

The fused qkv projection + attention (`_fused_qkv_attn_fwd_kernel`, via
`_fused_qkv_attn_fwd_call`; `fused_qkv_attention`): x (N, T, C) . W + b and
the head-pair attention in one kernel, which also writes the projected qkv
for the backward; the backward is the packed no-db kernel plus library
products for dx, dW and db, as `_fused_bwd_rule` leaves them to XLA.

The blocked flash attention over (B, T, H, D) (`_flash_kernel` via
`_flash_attention_fwd`; `_dq_kernel` and `_dkv_kernel` via
`_flash_attention_bwd`; `flash_attention_vjp`): what `dot_product_attention`
runs for 128 tokens or more without a mask, AVT-h's causal attention over a
long observed context on the main path. The kernels read strided (B, T, H,
D) views in place, so the q, k and v views of a fused qkv projection need
no copy (the JAX path pads and transposes them to (B*H, T_pad, D)).

Each kernel is a `torch.library` custom op of the namespace `avt_tpu_torch`
(`packed_short_attention` and its `_bwd`, `fused_qkv_attention`,
`flash_attention` and its `_bwd`), with a fake implementation for the shapes
and its backward registered as a formula over the backward ops, so that one
route serves eager training, data-parallel training and `torch.export`: an
exported program names the ops, and a process that imports
`avt_tpu_torch.ops` can run it. On
a CUDA tensor an op launches the hand-written Hopper kernels
`csrc/short_attention_{fwd,bwd}.cu` (bf16 or f32 storage, head dim 32, 64
or 128), `csrc/fused_qkv_attention_fwd.cu` (bf16 or f32, head dim 64, an
even head count) and `csrc/flash_attention_{fwd,bwd}.cu` (bf16 or f32, head
dim 64, 128, 256, 512 or 1024) or raises; on a CPU tensor it runs the plain
PyTorch versions (`packed_short_attention_reference`,
`packed_short_attention_bwd_reference`, `fused_qkv_attention_reference`,
`flash_attention_reference`, `flash_attention_bwd_reference`), which follow
the TPU kernels' arithmetic order. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from avt_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
NEG_INF = -1e30
KERNEL = "short_attention_fwd"
BWD_KERNEL = "short_attention_bwd"
HEAD_DIMS = (32, 64, 128)
FLASH_KERNEL = "flash_attention_fwd"
FLASH_BWD_KERNEL = "flash_attention_bwd"
FLASH_HEAD_DIMS = (64, 128, 256, 512, 1024)  # 512: expts/02; 1024: expts/04
FLASH_BLOCK_K = 128  # the TPU kernel's key block, which the plain version repeats
FUSED_KERNEL = "fused_qkv_attention_fwd"
FUSED_HEAD_DIM = 64  # the fused kernel exists in head-pair form only
NAMESPACE = "avt_tpu_torch"  # of the custom ops
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


def _aligned(x: torch.Tensor, in_layout: Optional[bool] = None) -> torch.Tensor:
    """x as a kernel reads it: `x` itself when its strides are the kernel's
    layout (`in_layout`, by default contiguity) and its base is 16-byte
    aligned, else a contiguous copy in a new allocation, which the caching
    allocator aligns (`.contiguous()` returns an already contiguous view
    as it is, misaligned base and all)."""
    if in_layout is None:
        in_layout = x.is_contiguous()
    if in_layout and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_qkv(name: str, qkv: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, int]:
    """Validates a packed qkv for a kernel; returns it as the kernel reads it
    (a misaligned one copied) and the head dim."""
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
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    return _aligned(qkv), D


def _check_operand(name: str, what: str, x: Optional[torch.Tensor], shape, qkv: torch.Tensor
                   ) -> Optional[torch.Tensor]:
    """A contiguous operand of qkv's type and device, as the kernel reads it
    (a misaligned one copied)."""
    if x is None:
        return None
    if (x.shape != shape or x.dtype != qkv.dtype or x.device != qkv.device
            or not x.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous "
                         f"{tuple(shape)} {qkv.dtype} tensor on {qkv.device}")
    return _aligned(x)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


@functools.lru_cache(maxsize=None)
def _kernel(csrc: Path = _build.CSRC):
    """The forward's C entry point, built and loaded at first use."""
    fn = _build.load(KERNEL, csrc).short_attention_fwd
    # (qkv, bias, out, N, T, H, D, is_bf16, causal, scale, stream)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel(csrc: Path = _build.CSRC):
    """The backward's C entry points (launch, tiles), built at first use."""
    lib = _build.load(BWD_KERNEL, csrc)
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


def _launch(qkv: torch.Tensor, bias, num_heads: int, causal: bool,
            csrc: Path = _build.CSRC) -> torch.Tensor:
    """The forward kernel, built from the sources in csrc."""
    qkv, D = _check_qkv(KERNEL, qkv, num_heads)
    N, T, C3 = qkv.shape
    bias = _check_operand(KERNEL, "bias", bias, (C3,), qkv)
    out = torch.empty((N, T, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    if N == 0 or T == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = _kernel(csrc)(qkv.data_ptr(), _ptr(bias), out.data_ptr(), N, T, num_heads, D,
                        _DTYPES[qkv.dtype], int(causal), _storage_scale(D, qkv.dtype),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(KERNEL, csrc), err, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return out


def _launch_bwd(qkv: torch.Tensor, bias, dout: torch.Tensor, num_heads: int, causal: bool,
                with_db: bool, csrc: Path = _build.CSRC
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dqkv, db in the storage type or None) from the backward kernel, built
    from the sources in csrc."""
    qkv, D = _check_qkv(BWD_KERNEL, qkv, num_heads)
    N, T, C3 = qkv.shape
    bias = _check_operand(BWD_KERNEL, "bias", bias, (C3,), qkv)
    dout = _check_operand(BWD_KERNEL, "dout", dout, (N, T, C3 // 3), qkv)
    dqkv = torch.empty_like(qkv)
    db = torch.zeros(C3, dtype=qkv.dtype, device=qkv.device) if with_db else None
    if N == 0 or T == 0:
        return dqkv, db
    fn, tiles = _bwd_kernel(csrc)
    is_bf16 = _DTYPES[qkv.dtype]
    f32 = dict(dtype=torch.float32, device=qkv.device)
    stats = torch.empty((N, num_heads, 3, T), **f32)  # row max, 1/l, delta
    partials = torch.empty((N * tiles(T, is_bf16), C3), **f32) if with_db else None
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), _ptr(bias), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                 _ptr(partials), _ptr(db), N, T, num_heads, D, is_bf16, int(causal),
                 _storage_scale(D, qkv.dtype), 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(BWD_KERNEL, csrc), err, BWD_KERNEL)
    _build.launch_counts[BWD_KERNEL] += 1
    return dqkv, db


def _check_device(name: str, x: torch.Tensor) -> None:
    """An entry point takes CPU tensors (the plain version) or CUDA tensors
    (the kernel); any other device raises before the op is reached."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"{name} runs on CUDA tensors (or, through its plain version, on "
            f"CPU tensors); got a tensor on {x.device}")


@torch.library.custom_op(f"{NAMESPACE}::packed_short_attention", mutates_args=(),
                         device_types="cpu")
def _packed_op(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
               causal: bool) -> torch.Tensor:
    """(N, T, 3C) [+ bias (3C)] -> (N, T, C); on the CPU the plain version."""
    return packed_short_attention_reference(qkv if bias is None else qkv + bias,
                                            num_heads, causal)


@_packed_op.register_kernel("cuda")
def _(qkv, bias, num_heads, causal):
    return _launch(qkv, bias, num_heads, causal)


@_packed_op.register_fake
def _(qkv, bias, num_heads, causal):
    N, T, C3 = qkv.shape
    return qkv.new_empty((N, T, C3 // 3))


@torch.library.custom_op(f"{NAMESPACE}::packed_short_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _packed_bwd_op(qkv: torch.Tensor, bias: Optional[torch.Tensor], dout: torch.Tensor,
                   num_heads: int, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, db): db (3C) in the storage type when a bias is given, else an
    empty tensor; on the CPU the plain version."""
    if bias is None:
        dqkv, _ = packed_short_attention_bwd_reference(qkv, dout, num_heads, causal)
        return dqkv, qkv.new_empty((0,))
    dqkv, db = packed_short_attention_bwd_reference(qkv + bias, dout, num_heads, causal,
                                                    with_db=True)
    return dqkv, db.to(qkv.dtype)


@_packed_bwd_op.register_kernel("cuda")
def _(qkv, bias, dout, num_heads, causal):
    dqkv, db = _launch_bwd(qkv, bias, dout, num_heads, causal, with_db=bias is not None)
    return dqkv, qkv.new_empty((0,)) if db is None else db


@_packed_bwd_op.register_fake
def _(qkv, bias, dout, num_heads, causal):
    return qkv.new_empty(qkv.shape), qkv.new_empty((0,) if bias is None else (qkv.shape[-1],))


def _packed_setup(ctx, inputs, output):
    qkv, bias, ctx.num_heads, ctx.causal = inputs
    ctx.save_for_backward(qkv, bias)


def _packed_backward(ctx, dout):
    """The recompute backward kernel; with a bias, also its gradient db."""
    qkv, bias = ctx.saved_tensors
    dqkv, db = _packed_bwd_op(qkv, bias, dout.contiguous(), ctx.num_heads, ctx.causal)
    return dqkv, (None if bias is None else db), None, None


_packed_op.register_autograd(_packed_backward, setup_context=_packed_setup)


def packed_short_attention(
    qkv: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention straight off the packed qkv projection: qkv (N, T, 3*H*D),
    thirds q, k, v; returns (N, T, H*D). Differentiable: the backward is
    the recompute kernel (no db)."""
    _check_device(KERNEL, qkv)
    return _packed_op(qkv, None, num_heads, causal)


def packed_qkv_bias_attention(
    qkv_nobias: torch.Tensor, bias: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """The qkv bias add in the storage type, then the attention. The kernels
    add the bias as they load q, k and v, so the biased qkv never goes
    through device memory; the backward returns the bias gradient in the
    storage type, and the cast to the bias's own type stays outside, as in
    the JAX package."""
    _check_device(KERNEL, qkv_nobias)
    return _packed_op(qkv_nobias, bias.to(qkv_nobias.dtype).contiguous(), num_heads, causal)


# ---------------------------------------------------------------------------
# The qkv projection and the packed attention in one kernel.
# ---------------------------------------------------------------------------
def fused_qkv_attention_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused kernel: (out (N, T, C), qkv (N, T, 3C)) in
    x's type, in `_fused_qkv_attn_fwd_kernel`'s order: x . w accumulated in
    f32 and rounded to x's type, the bias added in that type, then the
    head-pair attention of `packed_short_attention_reference`."""
    dt = x.dtype
    qkv = torch.matmul(x.float(), w.float()).to(dt) + b.to(dt)
    return packed_short_attention_reference(qkv, num_heads, causal), qkv


def _check_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int):
    """Validates the fused kernel's operands; returns x, W^T and b in the
    kernel's layout: contiguous and 16-byte aligned, W^T (3C, C) (the
    transposed view the ViT passes is read in place; any other layout or a
    misaligned base is copied once)."""
    name = FUSED_KERNEL
    if x.device.type != "cuda":
        raise RuntimeError(
            f"{name} runs on CUDA tensors (or, through its plain version, on CPU "
            f"tensors); got a tensor on {x.device}")
    if x.dim() != 3 or x.shape[-1] != FUSED_HEAD_DIM * num_heads or num_heads % 2:
        raise ValueError(f"{name}: x must be (N, T, H*{FUSED_HEAD_DIM}) with an even head "
                         f"count H, got {tuple(x.shape)} for {num_heads} heads")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: storage type must be bfloat16 or float32, got {x.dtype}")
    C = x.shape[-1]
    for what, t, shape in (("w", w, (C, 3 * C)), ("b", b, (3 * C,))):
        if t.shape != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {what} must be a {shape} {x.dtype} tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return _aligned(x), _aligned(w.t()), _aligned(b)


@functools.lru_cache(maxsize=None)
def _fused_kernel(csrc: Path = _build.CSRC):
    """The fused kernel's C entry point, built from the sources in csrc at
    first use."""
    fn = _build.load(FUSED_KERNEL, csrc).fused_qkv_attention_fwd
    # (x, wt, bias, out, qkv, N, T, H, is_bf16, causal, scale, stream)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
                  causal: bool, csrc: Path = _build.CSRC) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (N, T, C), qkv (N, T, 3C)) from the fused kernel, built from the
    sources in csrc."""
    x, wt, b = _check_fused(x, w, b, num_heads)
    N, T, C = x.shape
    out = torch.empty((N, T, C), dtype=x.dtype, device=x.device)
    qkv = torch.empty((N, T, 3 * C), dtype=x.dtype, device=x.device)
    if N == 0 or T == 0:
        return out, qkv
    with torch.cuda.device(x.device):
        err = _fused_kernel(csrc)(x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  qkv.data_ptr(), N, T, num_heads, _DTYPES[x.dtype], int(causal),
                                  _storage_scale(FUSED_HEAD_DIM, x.dtype),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(FUSED_KERNEL, csrc), err, FUSED_KERNEL)
    _build.launch_counts[FUSED_KERNEL] += 1
    return out, qkv


@torch.library.custom_op(f"{NAMESPACE}::fused_qkv_attention", mutates_args=(),
                         device_types="cpu")
def _fused_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (N, T, C), qkv (N, T, 3C)) in x's type; on the CPU the plain
    version."""
    return fused_qkv_attention_reference(x, w, b, num_heads, causal)


@_fused_op.register_kernel("cuda")
def _(x, w, b, num_heads, causal):
    return _launch_fused(x, w, b, num_heads, causal)


@_fused_op.register_fake
def _(x, w, b, num_heads, causal):
    N, T, C = x.shape
    return x.new_empty((N, T, C)), x.new_empty((N, T, 3 * C))


def _fused_setup(ctx, inputs, output):
    x, w, _, ctx.num_heads, ctx.causal = inputs
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(x, w, output[1])


def _fused_backward(ctx, dout, _):
    """`_fused_bwd_rule`'s backward; residuals (x, wc, qkv), as
    `_fused_fwd_rule` keeps them: dqkv from the packed backward kernel (no
    db), then dx = dqkv . wc^T and dw = x^T . dqkv as library products in
    the storage type (XLA's, outside the TPU kernel), db = the f32 column
    sums of dqkv rounded to the storage type."""
    x, wc, qkv = ctx.saved_tensors
    dqkv, _ = _packed_bwd_op(qkv, None, dout.contiguous(), ctx.num_heads, ctx.causal)
    N, T, C3 = dqkv.shape
    d2 = dqkv.reshape(N * T, C3)
    dx = torch.matmul(d2, wc.t()).reshape(x.shape)
    dw = torch.matmul(x.reshape(N * T, -1).t(), d2)
    db = d2.float().sum(dim=0).to(d2.dtype)
    return dx, dw, db, None, None


_fused_op.register_autograd(_fused_backward, setup_context=_fused_setup)


def fused_qkv_attention(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """The qkv projection x (N, T, C) . w (C, 3C) + b (3C) and the head-pair
    attention in one kernel; returns (N, T, C). Head dim 64, an even head
    count. The casts of w and b to x's type stay outside the op, so the
    parameters' gradients come back in their own type, as in the JAX
    package."""
    _check_device(FUSED_KERNEL, x)
    return _fused_op(x, w.to(x.dtype), b.to(x.dtype), num_heads, causal)[0]


# ---------------------------------------------------------------------------
# Blocked flash attention over (B, T, H, D): AVT-h at long observed contexts.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _flash_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) rounded to the storage type: the TPU kernel's
    `q_ref[...] * sm_scale` multiplies by a weakly typed Python float."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=dtype))


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q' = q * sm_scale in the storage type, as f32 (B, H, T, D)."""
    scale = torch.tensor(_flash_scale(q.shape[-1], q.dtype), dtype=q.dtype, device=q.device)
    return (q * scale).float().transpose(1, 2)


def _causal_keep(nq: int, k0: int, nk: int, device) -> torch.Tensor:
    """(nq, nk) True where key k0 + j is at or before query i."""
    q_pos = torch.arange(nq, device=device)[:, None]
    return torch.arange(k0, k0 + nk, device=device)[None, :] <= q_pos


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 as (B, H, T), from the rounded output, as
    `_fa_bwd` computes it outside the kernels."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out (B, Tq, H, D) in the storage
    type, lse (B, H, Tq) f32), in `_flash_kernel`'s order over 128-key blocks:
    q scaled in the storage type, f32 scores with -1e30 on masked keys, an
    online softmax with exp, p rounded to v's type for an f32-accumulated PV,
    out = acc / max(l, 1e-30) rounded once, lse = m + log(max(l, 1e-30))."""
    B, Tq, H, D = q.shape
    Tk, dt = k.shape[1], q.dtype
    qs = _scaled_q(q)
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq, 1), NEG_INF, **f32)
    l = torch.zeros((B, H, Tq, 1), **f32)
    acc = torch.zeros((B, H, Tq, D), **f32)
    for k0 in range(0, Tk, FLASH_BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + FLASH_BLOCK_K], vf[:, :, k0:k0 + FLASH_BLOCK_K]
        s = torch.matmul(qs, kb.transpose(-1, -2))
        if causal:
            s = s.masked_fill(~_causal_keep(Tq, k0, kb.shape[2], q.device), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb)
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc).to(dt).transpose(1, 2).contiguous()
    return out, (m + torch.log(lc))[..., 0]


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv) in the storage
    type, in `_dq_kernel` / `_dkv_kernel`'s order: p = exp(s - lse)
    recomputed from the scaled q, ds = p * (dO.v^T - delta) with delta =
    rowsum(dO * O) in f32, dq = (ds rounded to k's type . K) * sm_scale,
    dk = ds^T rounded . q', dv = p^T rounded . dO, f32 accumulation."""
    Tq, D = q.shape[1], q.shape[-1]
    Tk, dt = k.shape[1], q.dtype
    qs = _scaled_q(q)
    kf, vf, dof = (x.float().transpose(1, 2) for x in (k, v, dout))
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(Tq, 0, Tk, q.device), NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - _delta(dout, out)[..., None])
    sm_scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    dq = torch.matmul(ds.to(k.dtype).float(), kf) * sm_scale
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2), qs)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dof)
    return tuple(x.to(dt).transpose(1, 2).contiguous() for x in (dq, dk, dv))


def _flash_view(name: str, what: str, x: torch.Tensor, shape, like: torch.Tensor) -> torch.Tensor:
    """A (B, T, H, D) operand as the kernels read it: in the storage type,
    last two axes contiguous and rows 16-byte aligned. A view that is not (a
    transposed or misaligned one) is copied into that layout; a wrong shape,
    type or device raises."""
    if x.device != like.device or x.dtype != like.dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be a {tuple(shape)} {like.dtype} tensor on "
                         f"{like.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    D, size = x.shape[-1], x.element_size()
    return _aligned(x, x.stride(-1) == 1 and x.stride(-2) == D
                    and all((st * size) % 16 == 0 for st in x.stride()[:2]))


def _check_flash(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Validates q, k, v for a flash kernel (q's rank, type and head dim, then
    its device); returns them in its layout."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, T, H, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: storage type must be bfloat16 or float32, got {q.dtype}")
    B, _, H, D = q.shape
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} is not one the kernel is built for "
                         f"{FLASH_HEAD_DIMS}")
    if q.device.type != "cuda":
        raise RuntimeError(
            f"{name} runs on CUDA tensors (or, through its plain version, on CPU "
            f"tensors); got a tensor on {q.device}")
    kv_shape = (B, k.shape[1], H, D)
    return (_flash_view(name, "q", q, q.shape, q), _flash_view(name, "k", k, kv_shape, q),
            _flash_view(name, "v", v, kv_shape, q))


def _strides(*xs: torch.Tensor):
    return [st for x in xs for st in x.stride()[:2]]


@functools.lru_cache(maxsize=None)
def _flash_kernel(csrc: Path = _build.CSRC):
    """The forward's C entry point, built from the sources in csrc at first use."""
    fn = _build.load(FLASH_KERNEL, csrc).flash_attention_fwd
    # (q, k, v, out, lse, B, H, Tq, Tk, D, is_bf16, causal, q_sb, q_st, k_sb,
    #  k_st, v_sb, v_st, q_scale, stream)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _flash_bwd_kernel(csrc: Path = _build.CSRC):
    """The backward's C entry point, built from the sources in csrc at first use."""
    fn = _build.load(FLASH_BWD_KERNEL, csrc).flash_attention_bwd
    # (q, k, v, dout, lse, delta, dq, dk, dv, B, H, Tq, Tk, D, is_bf16, causal,
    #  q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, q_scale, dq_scale, stream)
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  want_lse: bool, csrc: Path = _build.CSRC
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse (B, H, Tq) f32 or None) from the forward kernel, built from
    the sources in csrc."""
    q, k, v = _check_flash(FLASH_KERNEL, q, k, v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if want_lse else None
    if B * H * Tq == 0:
        return out, lse
    if Tk == 0:
        raise ValueError(f"{FLASH_KERNEL}: no keys to attend to")
    with torch.cuda.device(q.device):
        err = _flash_kernel(csrc)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), B, H, Tq, Tk,
            D, _DTYPES[q.dtype], int(causal), *_strides(q, k, v), _flash_scale(D, q.dtype),
            torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(FLASH_KERNEL, csrc), err, FLASH_KERNEL)
    _build.launch_counts[FLASH_KERNEL] += 1
    return out, lse


def _launch_flash_bwd(q, k, v, dout, lse, delta, causal: bool, csrc: Path = _build.CSRC):
    """(dq, dk, dv) from the backward kernels (dq side, then dk/dv side), built
    from the sources in csrc."""
    q, k, v = _check_flash(FLASH_BWD_KERNEL, q, k, v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dout = _flash_view(FLASH_BWD_KERNEL, "dout", dout, q.shape, q)
    for what, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (B, H, Tq) or x.dtype != torch.float32 or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{FLASH_BWD_KERNEL}: {what} must be a contiguous ({B}, {H}, "
                             f"{Tq}) float32 tensor on {q.device}")
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B * H * Tq * Tk == 0:
        return dq, dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        err = _flash_bwd_kernel(csrc)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, D,
            _DTYPES[q.dtype], int(causal), *_strides(q, k, v, dout), _flash_scale(D, q.dtype),
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(FLASH_BWD_KERNEL, csrc), err, FLASH_BWD_KERNEL)
    _build.launch_counts[FLASH_BWD_KERNEL] += 1
    return dq, dk, dv


@torch.library.custom_op(f"{NAMESPACE}::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              want_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Tq, H, D), lse (B, H, Tq) f32, or an empty tensor when not
    wanted); on the CPU the plain version."""
    out, lse = flash_attention_reference(q, k, v, causal)
    return out, lse if want_lse else lse.new_empty((0,))


@_flash_op.register_kernel("cuda")
def _(q, k, v, causal, want_lse):
    out, lse = _launch_flash(q, k, v, causal, want_lse)
    return out, q.new_empty((0,), dtype=torch.float32) if lse is None else lse


@_flash_op.register_fake
def _(q, k, v, causal, want_lse):
    B, Tq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Tq) if want_lse else (0,),
                                             dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the storage type; on the CPU the plain version."""
    return flash_attention_bwd_reference(q, k, v, dout, out, lse, causal)


@_flash_bwd_op.register_kernel("cuda")
def _(q, k, v, dout, out, lse, causal):
    return _launch_flash_bwd(q, k, v, dout, lse, _delta(dout, out), causal)


@_flash_bwd_op.register_fake
def _(q, k, v, dout, out, lse, causal):
    return q.new_empty(q.shape), q.new_empty(k.shape), q.new_empty(k.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, ctx.causal, _ = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)


def _flash_backward(ctx, dout, _):
    """The recompute backward; residuals (q, k, v, out, lse), as `_fa_fwd`
    keeps them."""
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, dout, out, lse, ctx.causal)
    return dq, dk, dv, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Flash attention over (B, T, H, D) with scale 1/sqrt(D); returns (B, Tq,
    H, D). Differentiable (the recompute backward); the logsumexp is only
    written when autograd will need it."""
    _check_device(FLASH_KERNEL, q)
    want_lse = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
    return _flash_op(q, k, v, causal, want_lse)[0]
