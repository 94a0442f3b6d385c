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
