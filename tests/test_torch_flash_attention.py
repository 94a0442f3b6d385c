"""The port's packed attention (avt_tpu_torch/ops/flash_attention.py)
against the JAX package's TPU kernel, run in Pallas interpret mode on the
CPU: the plain version the CPU wrapper runs, the bias form, and the launch
counter. The CUDA kernel itself is held against its plain version on the
card in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avt_tpu.ops import flash_attention as jfa
from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import flash_attention as tfa

# f32: the same math in another summation order. bf16: p and the output are
# rounded to bf16 (2^-8 relative) at places the two frameworks share, and
# XLA and torch accumulate the f32 products in different orders.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}

CASES = [  # (N, T, H, D): the head-pair body (D=64, even H) and the per-head one
    pytest.param(2, 197, 12, 64, id="paired"),
    pytest.param(2, 37, 2, 32, id="unpaired"),
]


def _qkv(N, T, H, D, seed=0):
    return np.random.default_rng(seed).standard_normal((N, T, 3 * H * D)).astype(np.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,T,H,D", CASES)
def test_packed_short_attention_matches_tpu_kernel(N, T, H, D, causal, dtype):
    x = _qkv(N, T, H, D)
    ref = jfa._short_attention_fwd_call(_to_jax(x, dtype), H, causal, True)
    out = tfa.packed_short_attention(_to_torch(x, dtype), H, causal)
    assert out.shape == (N, T, H * D) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_qkv_bias_attention_matches_jax(dtype):
    N, T, H, D = 2, 197, 12, 64
    x = _qkv(N, T, H, D, seed=1)
    b = np.random.default_rng(2).standard_normal(3 * H * D).astype(np.float32)
    ref = jfa.packed_qkv_bias_attention(_to_jax(x, dtype), jnp.asarray(b), H, False)
    out = tfa.packed_qkv_bias_attention(_to_torch(x, dtype), torch.from_numpy(b), H, False)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype], rtol=TOL[dtype])


def test_cpu_wrapper_does_not_count_launches():
    _build.reset_launch_counts()
    x = torch.from_numpy(_qkv(1, 70, 2, 32))
    tfa.packed_short_attention(x, 2)
    tfa.packed_qkv_bias_attention(x, torch.zeros(x.shape[-1]), 2)
    assert _build.launch_counts[tfa.KERNEL] == 0


def test_kernel_wrapper_refuses_other_devices():
    x = torch.zeros(1, 8, 3 * 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.packed_short_attention(x, 2)


def test_reference_scale_is_rounded_to_storage_type():
    # the TPU kernel's q * (sm_scale*log2e) takes q's dtype
    assert tfa._storage_scale(64, torch.bfloat16) == 0.1806640625
    assert tfa._storage_scale(64, torch.float32) == pytest.approx(0.125 * tfa.LOG2E, rel=1e-7)
