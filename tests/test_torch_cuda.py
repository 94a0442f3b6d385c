"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so the file runs on a GPU host:
    python -m pytest --noconftest -q tests/test_torch_cuda.py
Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import flash_attention as tfa

# bf16: p and the output are rounded to bf16 (2^-8 relative), and the kernel
# forms p against a running max where the plain version uses the final one;
# f32: the same math summed in another order.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _qkv(N, T, H, D, dtype, device, seed=0):
    x = np.random.default_rng(seed).standard_normal((N, T, 3 * H * D)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,T,causal,bias", [
    ("bfloat16", 64, 197, False, False), ("bfloat16", 64, 197, False, True),
    ("float32", 64, 197, False, True), ("bfloat16", 32, 197, True, False),
    ("bfloat16", 128, 197, True, True), ("float32", 128, 197, False, False),
    # several query tiles and key tiles per sequence; a sequence shorter than a tile
    ("bfloat16", 64, 600, True, True), ("bfloat16", 64, 600, False, False),
    ("float32", 32, 300, True, False), ("bfloat16", 64, 5, False, True),
])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, D, T, causal, bias):
    H = 768 // D
    x = _qkv(6, T, H, D, dtype, cuda_device, seed=3)
    b = (torch.randn(3 * H * D, generator=torch.Generator().manual_seed(4)) if bias
         else torch.zeros(3 * H * D)).to(cuda_device)
    _build.reset_launch_counts()
    out = tfa.packed_qkv_bias_attention(x, b, H, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.KERNEL] == 1
    ref = tfa.packed_short_attention_reference(x + b.to(x.dtype), H, causal)
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_raises_on_unbuilt_head_dim(cuda_device):
    x = torch.zeros(1, 70, 3 * 2 * 48, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.packed_short_attention(x, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.packed_short_attention(torch.zeros(1, 70, 2 * 3 * 64, dtype=torch.bfloat16,
                                               device=cuda_device)[:, ::2], 1)


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,T,causal,bias", [
    ("bfloat16", 64, 197, False, True), ("float32", 64, 197, False, True),
    ("bfloat16", 32, 197, False, False), ("bfloat16", 32, 197, True, False),
    ("bfloat16", 128, 197, False, False), ("float32", 128, 197, True, True),
    ("float32", 32, 197, True, False),
    # several query and key tiles per sequence; a sequence shorter than a tile
    ("bfloat16", 64, 600, True, True), ("bfloat16", 64, 600, False, False),
    ("float32", 64, 600, True, True), ("bfloat16", 64, 5, False, True),
    ("float32", 32, 5, True, True),
])
def test_cuda_backward_matches_plain_version(cuda_device, dtype, D, T, causal, bias):
    H = 768 // D
    x = _qkv(6, T, H, D, dtype, cuda_device, seed=5)
    do = _qkv(6, T, H, D, dtype, cuda_device, seed=6)[..., : H * D].contiguous()
    b = (torch.randn(3 * H * D, generator=torch.Generator().manual_seed(7)) if bias
         else torch.zeros(3 * H * D)).to(cuda_device, x.dtype)
    _build.reset_launch_counts()
    dqkv, db = tfa._launch_bwd(x, b, do, H, causal, with_db=True)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.BWD_KERNEL] == 1
    ref, ref_db = tfa.packed_short_attention_bwd_reference(x + b, do, H, causal, with_db=True)
    assert _rel_err(dqkv, ref) <= TOL[dtype]
    assert _rel_err(db, ref_db) <= TOL[dtype]
    again, db_again = tfa._launch_bwd(x, b, do, H, causal, with_db=True)
    assert torch.equal(again, dqkv) and torch.equal(db_again, db)  # no atomics: same bits


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 32])
def test_cuda_grads_reach_qkv_and_bias(cuda_device, D):
    H = 768 // D
    x = _qkv(4, 197, H, D, "bfloat16", cuda_device, seed=8).requires_grad_(True)
    b = torch.randn(3 * H * D, device=cuda_device, requires_grad=True)
    _build.reset_launch_counts()
    out = tfa.packed_qkv_bias_attention(x, b, H)
    out.float().square().sum().backward()
    assert x.grad is not None and b.grad is not None and b.grad.dtype == torch.float32
    assert torch.isfinite(x.grad).all() and torch.isfinite(b.grad).all()
    y = x.detach().clone().requires_grad_(True)
    tfa.packed_short_attention(y, H, causal=True).float().sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{name: 0 for name in _build.KERNELS},
                                    tfa.KERNEL: 2, tfa.BWD_KERNEL: 2}


def _heads(B, T, H, D, dtype, device, seed):
    x = np.random.default_rng(seed).standard_normal((B, T, H, D)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,H,T,causal", [
    # AVT-h of expts/02 (4 heads of 512) and of expts/13 (8 of 256), TransformerAgg's 8 of 64
    ("float32", 512, 4, 256, True), ("bfloat16", 512, 4, 256, False),
    ("float32", 256, 8, 256, False), ("bfloat16", 256, 8, 200, True),
    ("float32", 128, 2, 130, True), ("bfloat16", 128, 2, 300, False),
    ("float32", 64, 8, 200, True), ("bfloat16", 64, 8, 256, True),
    ("float32", 512, 1, 5, False),  # shorter than a tile
])
def test_cuda_flash_matches_plain_version(cuda_device, dtype, D, H, T, causal):
    q, k, v, do = (_heads(3, T, H, D, dtype, cuda_device, seed) for seed in range(4))
    _build.reset_launch_counts()
    out, lse = tfa._launch_flash(q, k, v, causal, want_lse=True)
    delta = tfa._delta(do, out)
    dq, dk, dv = tfa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.FLASH_KERNEL] == 1
    assert _build.launch_counts[tfa.FLASH_BWD_KERNEL] == 1
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=TOL[dtype], rtol=TOL[dtype])
    refs = tfa.flash_attention_bwd_reference(q, k, v, do, out, lse, causal)
    for got, want in zip((dq, dk, dv), refs):
        assert _rel_err(got, want) <= TOL[dtype]
    again = tfa._launch_flash_bwd(q, k, v, do, lse, delta, causal)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))  # no atomics: same bits
    assert torch.equal(tfa._launch_flash(q, k, v, causal, want_lse=False)[0], out)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_with_more_keys_than_queries(cuda_device, causal):
    q, do = (_heads(2, 150, 2, 128, "float32", cuda_device, seed) for seed in (11, 12))
    k, v = (_heads(2, 260, 2, 128, "float32", cuda_device, seed) for seed in (13, 14))
    out, lse = tfa._launch_flash(q, k, v, causal, want_lse=True)
    grads = tfa._launch_flash_bwd(q, k, v, do, lse, tfa._delta(do, out), causal)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out, ref, atol=TOL["float32"], rtol=TOL["float32"])
    torch.testing.assert_close(lse, ref_lse, atol=TOL["float32"], rtol=TOL["float32"])
    refs = tfa.flash_attention_bwd_reference(q, k, v, do, out, lse, causal)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    for got, want in zip(grads, refs):
        assert _rel_err(got, want) <= TOL["float32"]


@pytest.mark.cuda
def test_cuda_flash_reads_packed_views_in_place(cuda_device):
    B, T, H, D = 2, 150, 4, 128
    qkv = _qkv(B, T, H, D, "float32", cuda_device, seed=9).requires_grad_(True)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    _build.reset_launch_counts()
    out = tfa.flash_attention(q, k, v, causal=True)
    (grad,) = torch.autograd.grad(out.square().sum(), qkv)
    torch.cuda.synchronize()
    assert _build.launch_counts[tfa.FLASH_KERNEL] == 1
    assert _build.launch_counts[tfa.FLASH_BWD_KERNEL] == 1
    x = qkv.detach().requires_grad_(True)
    q2, k2, v2 = (t.reshape(B, T, H, D).contiguous() for t in x.split(H * D, dim=-1))
    ref = tfa.flash_attention_reference(q2, k2, v2, True)[0]
    (ref_grad,) = torch.autograd.grad(ref.square().sum(), x)
    torch.testing.assert_close(out, ref, atol=TOL["float32"], rtol=TOL["float32"])
    assert _rel_err(grad, ref_grad) <= TOL["float32"]


@pytest.mark.cuda
def test_cuda_flash_raises_on_unbuilt_head_dim(cuda_device):
    x = torch.zeros(1, 130, 2, 96, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa.flash_attention(x, x, x)
    with pytest.raises(TypeError, match="storage type"):
        tfa.flash_attention(*(torch.zeros(1, 130, 2, 64, dtype=torch.float16,
                                          device=cuda_device),) * 3)
