"""f32 dense layers on the tensor cores: the engine of `models/layers.py:dense`
for f32 tensors on CUDA.

`dense_f32(x, weight, bias, in_out)` is x . W (+ bias) with W torch's (out,
in) or, with in_out, GPT-2 Conv1D's (in, out). On a CUDA tensor the forward
and both backward products (dX and dW) run the hand-written kernel
`csrc/dense_f32.cu`: f32 in and out, each product as three TF32 products on
mma.sync (hi = x with its 13 low bits cleared, lo = x - hi, lo . hi + hi .
lo + hi . hi), accumulated in f32, the bias added in f32 after. cuBLAS would
run the same f32 product on the FMA units; nothing here changes PyTorch's
TF32 settings. On a CPU tensor it runs the plain version, `gemm_reference`,
which forms the same three products exactly (in float64) and rounds once.
There is no fallback from one to the other.

The ops are `torch.library` custom ops of the namespace `avt_tpu_torch`
(`dense_f32`, and `dense_f32_bwd` for dX and dW), with fake implementations
and the backward registered over them: what the CPU and a traced program
(`torch.export`) run. Eager CUDA tensors take `_DenseF32`, an
autograd.Function that launches the same kernel without the custom op's
dispatch, which costs the host more than the launch. Either backward saves
what `torch.matmul` saves, x and W, launches dX and dW only where autograd
asks for them, and sums the bias gradient with `dY.sum(0)`.

Layouts: the kernel reads each operand with one unit stride, along the
contraction or along the output (A K- or M-major, B K- or N-major), so x,
W, W^T, dY and dY^T all go in as they lie. A tensor with no unit stride (an
expanded gradient) is copied first. Where the output tiles leave SMs idle (a
few hundred rows, as expts/02's 640), K is split over blocks and a second
pass adds the partial planes in order.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from avt_tpu_torch.ops import _build

KERNEL = "dense_f32"
NAMESPACE = "avt_tpu_torch"
BM = BN = 128  # the kernel's block tile
BK = 32  # the K a stage of the kernel takes
BLOCKS_PER_SM = 1  # the kernel's residency (launch bounds, registers)
MIN_SPLIT_K_TILES = 4  # a split of K takes at least 4 * BK = 128 of it
MAX_SPLITS = 4  # bounds the scratch: splits * M * N floats


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """float32 x with its 13 low mantissa bits cleared: the kernel's hi, and
    what the tensor cores read of its lo."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def gemm_reference(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Plain version of the kernel: a (M, K) . b (K, N) (+ bias (N)), f32. Each
    operand split into hi = tf32_rz(x) and lo = tf32_rz(x - hi), the three
    products lo_a . hi_b + hi_a . lo_b + hi_a . hi_b formed in float64 (the
    TF32 products are exact), rounded to f32, then the bias added in f32."""
    a_hi, b_hi = tf32_rz(a), tf32_rz(b)
    a_lo, b_lo = tf32_rz(a - a_hi).double(), tf32_rz(b - b_hi).double()
    a_hi, b_hi = a_hi.double(), b_hi.double()
    out = (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).float()
    return out if bias is None else out + bias


def _layout(x: torch.Tensor, k_axis: int) -> Tuple[torch.Tensor, bool, int]:
    """(x as the kernel reads it, K-major, leading dimension) of a 2-D operand
    whose contraction axis is k_axis: K-major when its unit stride runs along
    K, else M- or N-major; a tensor with no unit stride is copied."""
    if x.stride(k_axis) != 1 and x.stride(1 - k_axis) != 1:
        x = x.contiguous()
    if x.stride(k_axis) == 1:
        return x, True, x.stride(1 - k_axis)
    return x, False, x.stride(k_axis)


def _vec4(x: torch.Tensor, k_major: bool, k_axis: int, ld: int) -> bool:
    """Whether 16-byte copies can read x: base 16-byte aligned, leading
    dimension a multiple of 4 floats (or never stepped over: one row)."""
    rows = x.shape[1 - k_axis] if k_major else x.shape[k_axis]
    return x.data_ptr() % 16 == 0 and (ld % 4 == 0 or rows == 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def splits_for(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """(splits of K, BK-wide steps a split takes). One split where the output
    tiles fill a wave of the card's blocks; else the split count, up to
    MAX_SPLITS and each at least MIN_SPLIT_K_TILES steps long, whose waves
    of blocks take the fewest steps (the fewest splits of equals)."""
    tiles = -(-M // BM) * -(-N // BN)
    k_tiles = -(-K // BK)
    slots = BLOCKS_PER_SM * sms
    best_steps, splits = k_tiles, 1
    if tiles < slots:
        for s in range(2, MAX_SPLITS + 1):
            per = -(-k_tiles // s)
            if per < MIN_SPLIT_K_TILES:
                break
            steps = -(-tiles * s // slots) * per
            if steps < best_steps:
                best_steps, splits = steps, s
    per = -(-k_tiles // splits)
    return -(-k_tiles // per), per


@functools.lru_cache(maxsize=None)
def _kernel(csrc: Path = _build.CSRC):
    """The kernel's C entry point, built from the sources in csrc at first use."""
    fn = _build.load(KERNEL, csrc).dense_f32
    # (a, b, bias, out, ws, M, N, K, lda, ldb, a_kmajor, b_kmajor, vec4,
    #  splits, k_tiles, stream)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gemm(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
         csrc: Path = _build.CSRC) -> torch.Tensor:
    """a (M, K) . b (K, N) (+ bias (N)) on the kernel, built from the sources in
    csrc; f32 CUDA tensors, each with one unit stride (else copied)."""
    if a.device.type != "cuda":
        raise RuntimeError(
            f"{KERNEL} runs on CUDA tensors (or, through its plain version, on CPU "
            f"tensors); got a tensor on {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{KERNEL}: a (M, K) and b (K, N), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    device = a.device
    for what, x in (("a", a), ("b", b), ("bias", bias)):
        if x is not None and (x.dtype != torch.float32 or x.device != device):
            raise ValueError(f"{KERNEL}: {what} must be a float32 tensor on {device}, got "
                             f"{x.dtype} on {x.device}")
    if bias is not None:
        if bias.shape != (N,):
            raise ValueError(f"{KERNEL}: bias must be ({N},), got {tuple(bias.shape)}")
        bias = bias.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_() if bias is None else out.copy_(bias.expand(M, N))
    a, a_k, lda = _layout(a, 1)
    b, b_k, ldb = _layout(b, 0)
    vec4 = _vec4(a, a_k, 1, lda) and _vec4(b, b_k, 0, ldb)
    splits, k_tiles = splits_for(M, N, K, _sm_count(device.index))
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=device) if splits > 1 else None
    with torch.cuda.device(device):
        err = _kernel(csrc)(
            a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K, lda, ldb,
            int(a_k), int(b_k), int(vec4), splits, k_tiles,
            torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(KERNEL, csrc), err, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return out


def _weight_as_b(weight: torch.Tensor, in_out: bool) -> torch.Tensor:
    """W as the (K, N) operand of x . W: as it lies (in, out), or torch's (out,
    in) transposed (a view)."""
    return weight if in_out else weight.t()


def _backward_products(mm, dy, x, weight, in_out, need_dx, need_dw):
    """(dX or None, dW or None) of y = x . W from `mm` (the kernel or the plain
    version): dX = dY . W^T (W^T: torch's (out, in) as it lies), dW = X^T .
    dY, or dY^T . X for torch's layout."""
    dx = mm(dy, _weight_as_b(weight, in_out).t()) if need_dx else None
    dw = (mm(x.t(), dy) if in_out else mm(dy.t(), x)) if need_dw else None
    return dx, dw


@torch.library.custom_op(f"{NAMESPACE}::dense_f32", mutates_args=(), device_types="cpu")
def _dense_op(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              in_out: bool) -> torch.Tensor:
    """x (M, K) . W (+ bias); on the CPU the plain version."""
    return gemm_reference(x, _weight_as_b(weight, in_out), bias)


@_dense_op.register_kernel("cuda")
def _(x, weight, bias, in_out):
    return gemm(x, _weight_as_b(weight, in_out), bias)


@_dense_op.register_fake
def _(x, weight, bias, in_out):
    return x.new_empty((x.shape[0], weight.shape[1] if in_out else weight.shape[0]))


@torch.library.custom_op(f"{NAMESPACE}::dense_f32_bwd", mutates_args=(), device_types="cpu")
def _dense_bwd_op(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, in_out: bool,
                  need_dx: bool, need_dw: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX, dW), each an empty tensor where not asked for; on the CPU the plain
    version."""
    dx, dw = _backward_products(gemm_reference, dy, x, weight, in_out, need_dx, need_dw)
    return (x.new_empty((0,)) if dx is None else dx, x.new_empty((0,)) if dw is None else dw)


@_dense_bwd_op.register_kernel("cuda")
def _(dy, x, weight, in_out, need_dx, need_dw):
    dx, dw = _backward_products(gemm, dy, x, weight, in_out, need_dx, need_dw)
    return (x.new_empty((0,)) if dx is None else dx, x.new_empty((0,)) if dw is None else dw)


@_dense_bwd_op.register_fake
def _(dy, x, weight, in_out, need_dx, need_dw):
    return (x.new_empty(x.shape if need_dx else (0,)),
            x.new_empty(weight.shape if need_dw else (0,)))


def _dense_setup(ctx, inputs, output):
    x, weight, _, ctx.in_out = inputs
    ctx.save_for_backward(x, weight)


def _gradients(ctx, dy, products):
    """(dX, dW, db, None) of the op's inputs, each where autograd asks for it:
    dX and dW from `products(need_dx, need_dw)`, db = dY.sum(0)."""
    need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
    dx = dw = None
    if need_dx or need_dw:
        dx, dw = products(need_dx, need_dw)
    return (dx if need_dx else None, dw if need_dw else None,
            dy.sum(0) if need_db else None, None)


def _dense_backward(ctx, dy):
    """dX and dW through the backward op."""
    x, weight = ctx.saved_tensors
    return _gradients(ctx, dy, lambda need_dx, need_dw: _dense_bwd_op(
        dy, x, weight, ctx.in_out, need_dx, need_dw))


_dense_op.register_autograd(_dense_backward, setup_context=_dense_setup)


class _DenseF32(torch.autograd.Function):
    """The op's autograd on CUDA tensors in eager mode, the products straight
    to `gemm`: the custom op's dispatch costs the host more than the launch
    (a host-paced step, as expts/02's at 10 features, feels it). Saves x and
    W, as the op."""

    @staticmethod
    def forward(ctx, x, weight, bias, in_out):
        _dense_setup(ctx, (x, weight, bias, in_out), None)
        return gemm(x, _weight_as_b(weight, in_out), bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        return _gradients(ctx, dy, lambda need_dx, need_dw: _backward_products(
            gemm, dy, x, weight, ctx.in_out, need_dx, need_dw))


def dense_f32(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              in_out: bool = False) -> torch.Tensor:
    """x (..., K) . W (+ bias) in f32: W torch's (N, K), or (K, N) with in_out.
    Differentiable. A plain CUDA tensor in eager mode takes `_DenseF32`;
    the CPU (the plain version) and a traced program (fake tensors, or under
    torch.compile / export, which record the op by name) take the custom op."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.is_cuda and type(x2) is torch.Tensor and not torch.compiler.is_compiling():
        y = _DenseF32.apply(x2, weight, bias, in_out)
    else:
        y = _dense_op(x2, weight, bias, in_out)
    return y.reshape(*x.shape[:-1], y.shape[-1])
