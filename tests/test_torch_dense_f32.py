"""The f32 dense layers' op (avt_tpu_torch/ops/dense.py) on the CPU: its plain
version against a float64 product in every operand layout the kernel reads,
its backward against torch.matmul's autograd, the custom ops under
`torch.library.opcheck`, the split of K, and the routing of
`models/layers.py:dense` and `parallel/mesh.py:row_dense` (the CPU and bf16
keep torch.matmul, bit for bit).

Error model of the three TF32 products (csrc/dense_f32.cu, split_tf32_rz):
hi = x with its 13 low bits cleared leaves |x - hi| < 2^-10 |x|, and the
tensor cores read lo = x - hi with its 13 low bits cleared too, which leaves
< 2^-10 |lo| < 2^-20 |x|. So a . b less the three products lo_a . hi_b +
hi_a . lo_b + hi_a . hi_b is under 3 * 2^-20 |a||b|: lo_a . lo_b and the two
dropped parts of lo. Over a sum that is 3 * 2^-20 (|A| . |B|), plus the f32
rounding of the result (2^-24 of it, and as much again for the bias).
"""
import numpy as np
import pytest
import torch
from unittest import mock

from avt_tpu_torch.models import layers
from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import dense as td
from avt_tpu_torch.parallel.mesh import row_dense

SPLIT_ERR = 3 * 2.0 ** -20  # of |a||b| a product: the three terms' model
ROUND_ERR = 2.0 ** -23  # of |C|: the f32 rounding of the product and of the bias add


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _operand(rng, rows, cols, unit_axis):
    """A (rows, cols) f32 matrix whose unit stride runs along unit_axis (1:
    row-major, as it lies; 0: the transpose of a row-major (cols, rows))."""
    if unit_axis == 1:
        return _normal(rng, rows, cols)
    return _normal(rng, cols, rows).t()


def _bound(a, b, bias=None):
    """The model's bound on |C - C64|, elementwise, and C64."""
    ref = a.double() @ b.double()
    if bias is not None:
        ref = ref + bias.double()
    return SPLIT_ERR * (a.double().abs() @ b.double().abs()) + ROUND_ERR * ref.abs(), ref


LAYOUTS = [(True, True), (True, False), (False, True), (False, False)]  # (A K-major, B K-major)


@pytest.mark.parametrize("a_kmajor,b_kmajor", LAYOUTS)
@pytest.mark.parametrize("M", [1, 30, 257])
@pytest.mark.parametrize("K", [8, 24, 1000])
def test_plain_version_within_the_split_error_model(a_kmajor, b_kmajor, M, K):
    """The plain version against a float64 product, in each layout the kernel
    reads (the layout as `_layout` sees it), at ragged M, K and N, with a bias
    at odd M."""
    rng = np.random.default_rng(M * 1000 + K)
    N = 33 if M != 257 else 257
    a = _operand(rng, M, K, 1 if a_kmajor else 0)
    b = _operand(rng, K, N, 0 if b_kmajor else 1)
    bias = _normal(rng, N) if M % 2 else None
    assert td._layout(a, 1)[1] == a_kmajor or M == 1 or K == 1
    assert td._layout(b, 0)[1] == b_kmajor or N == 1 or K == 1
    out = td.gemm_reference(a, b, bias)
    bound, ref = _bound(a, b, bias)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    assert bool(((out.double() - ref).abs() <= bound).all())


def test_one_tf32_product_misses_the_model():
    """Why three products: hi . hi alone leaves ~2^-10 of |a||b|, far outside
    the three terms' bound."""
    rng = np.random.default_rng(3)
    a, b = _normal(rng, 64, 512), _normal(rng, 512, 48)
    one = (td.tf32_rz(a).double() @ td.tf32_rz(b).double()).float()
    bound, ref = _bound(a, b)
    assert ((one.double() - ref).abs() / bound).max() > 20


@pytest.mark.parametrize("value,want", [
    (1 + 2 ** -10, 1 + 2 ** -10),  # the last kept bit stays
    (1 + 2 ** -11, 1.0),  # below it goes, toward zero
    (-(1 + 2 ** -10 + 2 ** -11), -(1 + 2 ** -10)),
])
def test_tf32_rz_truncates(value, want):
    assert td.tf32_rz(torch.tensor([value], dtype=torch.float32)).item() == want


def _layer_inputs(seed, in_out, bias=True, lead=(3, 5)):
    rng = np.random.default_rng(seed)
    K, N = 24, 40
    x = _normal(rng, *lead, K).requires_grad_(True)
    w = (_normal(rng, K, N) if in_out else _normal(rng, N, K)).requires_grad_(True)
    b = _normal(rng, N).requires_grad_(True) if bias else None
    return x, w, b


@pytest.mark.parametrize("in_out", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_backward_matches_torch_matmul_autograd(in_out, bias):
    """dX, dW and db of dense_f32 (x 3-D, W in either layout) against
    torch.matmul's autograd in float64, within the model's bound of each
    product."""
    x, w, b = _layer_inputs(5, in_out, bias)
    dy = _normal(np.random.default_rng(6), 3, 5, 40)
    y = td.dense_f32(x, w, b, in_out)
    assert y.shape == (3, 5, 40)
    y.backward(dy)
    got = [x.grad, w.grad] + ([b.grad] if bias else [])
    x64, w64 = x.detach().double().requires_grad_(True), w.detach().double().requires_grad_(True)
    b64 = b.detach().double().requires_grad_(True) if bias else None
    y64 = torch.matmul(x64, w64 if in_out else w64.t())
    (y64 if b64 is None else y64 + b64).backward(dy.double())
    want = [x64.grad, w64.grad] + ([b64.grad] if bias else [])
    x2, dy2 = x.detach().reshape(-1, 24), dy.reshape(-1, 40)
    wb = w.detach() if in_out else w.detach().t()
    bounds = [_bound(dy2, wb.t())[0].reshape(3, 5, 24),
              _bound(x2.t(), dy2)[0] if in_out else _bound(dy2.t(), x2)[0]]
    for g, ref, bound in zip(got, want, bounds):
        assert g.dtype == torch.float32 and g.shape == ref.shape
        assert bool(((g.double() - ref).abs() <= bound).all())
    if bias:
        torch.testing.assert_close(got[2].double(), want[2], rtol=1e-6, atol=1e-5)


def test_backward_launches_only_what_autograd_asks_for():
    """x without a gradient: the backward op is asked for dW alone."""
    _, w, b = _layer_inputs(7, True)
    x = _normal(np.random.default_rng(8), 4, 24)
    calls = []
    real = td._dense_bwd_op

    def spy(dy, x_, w_, in_out, need_dx, need_dw):
        calls.append((need_dx, need_dw))
        return real(dy, x_, w_, in_out, need_dx, need_dw)

    with mock.patch.object(td, "_dense_bwd_op", spy):
        td.dense_f32(x, w, b, True).sum().backward()
    assert calls == [(False, True)] and x.grad is None
    assert w.grad is not None and b.grad is not None


def test_forward_saves_x_and_w_only():
    """The op keeps for its backward what torch.matmul keeps: x and W."""
    x, w, b = _layer_inputs(9, True)
    x2 = x.reshape(-1, 24)
    saved = td._dense_op(x2, w, b, True).grad_fn.saved_tensors
    assert len(saved) == 2 and torch.equal(saved[0], x2) and torch.equal(saved[1], w)


def _opcheck_cases():
    rng = np.random.default_rng(0)
    x, w, wt, b = (_normal(rng, 9, 32).requires_grad_(True), _normal(rng, 32, 20).requires_grad_(True),
                   _normal(rng, 20, 32).requires_grad_(True), _normal(rng, 20).requires_grad_(True))
    dy = _normal(rng, 9, 20)
    return {
        "in_out_bias": (td._dense_op, (x, w, b, True)),
        "linear": (td._dense_op, (x, wt, None, False)),
        "bwd_both": (td._dense_bwd_op, (dy, x.detach(), w.detach(), True, True, True)),
        "bwd_dw": (td._dense_bwd_op, (dy, x.detach(), wt.detach(), False, False, True)),
        "bwd_dx": (td._dense_bwd_op, (dy, x.detach(), wt.detach(), False, True, False)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_custom_op_passes_opcheck(case):
    op, args = _opcheck_cases()[case]
    _build.reset_launch_counts()
    torch.library.opcheck(op, args)
    assert _build.launch_counts[td.KERNEL] == 0  # the plain version on the CPU


@pytest.mark.parametrize("M,N,K,want", [
    (16384, 2048, 2048, (1, 64)),  # t256: 2048 tiles fill the card
    (16384, 8192, 2048, (1, 64)),
    (2048, 6144, 16384, (1, 512)),  # t256's dW
    (640, 2048, 2048, (3, 22)),  # t10: 80 tiles on 132 SMs
    (640, 2048, 8192, (3, 86)),
    (640, 6144, 2048, (1, 64)),  # 240 tiles
    (30, 2048, 2048, (4, 16)),  # a few rows: MAX_SPLITS
    (30, 2048, 200, (2, 4)),  # as far as MIN_SPLIT_K_TILES allows
    (30, 2048, 96, (1, 3)),  # too little K to split
    (1, 1, 1, (1, 1)),
])
def test_splits_for(M, N, K, want):
    splits, per = td.splits_for(M, N, K, 132)
    assert (splits, per) == want
    k_tiles = -(-K // td.BK)
    assert splits * per >= k_tiles and (splits - 1) * per < k_tiles  # no empty split
    assert splits == 1 or per >= td.MIN_SPLIT_K_TILES


def test_gemm_raises_on_a_cpu_tensor():
    """No fallback: the kernel's entry point takes CUDA tensors only."""
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        td.gemm(torch.zeros(2, 3), torch.zeros(3, 4))


@pytest.mark.parametrize("in_out", [True, False])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_dense_keeps_torch_matmul_on_the_cpu_and_in_bf16(in_out, dtype):
    """`dense` on CPU tensors (f32, and bf16 under a compute dtype) is
    torch.matmul + bias as before, bit for bit; the f32 op is not reached."""
    x, w, b = (t.detach() for t in _layer_inputs(11, in_out))
    xd, wd = (x, w) if dtype is None else (x.to(dtype), w.to(dtype))
    bd = b if dtype is None else b.to(dtype)
    want = torch.matmul(xd, wd if in_out else wd.t()) + bd
    with mock.patch.object(layers, "dense_f32", side_effect=AssertionError("f32 op reached")):
        got = layers.dense(x, w, b, dtype, in_out=in_out)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("in_out", [True, False])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_row_dense_without_a_mesh_is_dense(in_out, dtype, bias):
    x, w, b = (None if t is None else t.detach() for t in _layer_inputs(12, in_out, bias))
    assert torch.equal(row_dense(x, w, b, dtype, None, in_out=in_out),
                       layers.dense(x, w, b, dtype, in_out=in_out))


def test_dense_routes_f32_cuda_tensors_to_the_op():
    """The routing rule, on tensors that report CUDA: f32 goes to dense_f32
    with the layer's weight and layout; a bf16 compute dtype does not."""
    x, w, b = (t.detach() for t in _layer_inputs(13, True))
    calls = []

    def fake(x_, w_, b_, in_out):
        calls.append((x_.dtype, w_ is w, b_ is b, in_out))
        return torch.zeros(())

    with mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)), \
            mock.patch.object(layers, "dense_f32", fake):
        layers.dense(x, w, b, None, in_out=True)
        layers.dense(x, w, b, torch.float32, in_out=True)
        layers.dense(x, w, b, torch.bfloat16, in_out=True)
    assert calls == [(torch.float32, True, True, True), (torch.float32, True, True, True)]
