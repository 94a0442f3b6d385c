"""The port's attention dispatch (avt_tpu_torch/ops/attention.py) against
avt_tpu/ops/attention.py and jax.nn.dot_product_attention on the CPU, where
both sides take the plain (XLA / tensor-math) path."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.ops import attention as jattn
from avt_tpu_torch.ops import attention as tattn

# f32: the same math summed in another order. bf16: the probabilities and
# the output are rounded to bf16 (2^-8 relative) on both sides.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _j(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax_nn(causal, dtype):
    q, k, v = (_rand((2, 10, 4, 16), s) for s in range(3))
    ref = jax.nn.dot_product_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                       is_causal=causal)
    out = tattn.dot_product_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal)
    assert out.dtype == getattr(torch, dtype)
    _close(out, ref, dtype)


def test_dot_product_attention_mask_matches_avt_tpu():
    q, k, v = (_rand((2, 6, 2, 8), s) for s in range(3))
    keep = np.random.default_rng(5).random((2, 1, 6, 6)) > 0.3
    keep[..., 0] = True  # every query keeps one key
    ref = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      mask=jnp.asarray(keep))
    out = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), mask=torch.from_numpy(keep))
    _close(out, ref, "float32")


@pytest.mark.parametrize("causal", [False, True])
def test_packed_attention_matches_avt_tpu(causal):
    qkv = _rand((3, 70, 3 * 2 * 32), 7)
    ref = jattn.packed_attention(jnp.asarray(qkv), 2, causal=causal)
    out = tattn.packed_attention(torch.from_numpy(qkv), 2, causal=causal)
    _close(out, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_attention_matches_avt_tpu(dtype):
    x = _rand((2, 65, 128), 8)
    w = _rand((128, 384), 9) * 0.1
    b = _rand((384,), 10)
    ref = jattn.fused_qkv_attention(_j(x, dtype), jnp.asarray(w), jnp.asarray(b), 2)
    out = tattn.fused_qkv_attention(_t(x, dtype), torch.from_numpy(w), torch.from_numpy(b), 2)
    _close(out, ref, dtype)


def test_unported_kernels_raise():
    # every kernel is ported: use_kernel=True runs the flash kernel's and the
    # fused kernel's plain versions on the CPU
    x = torch.zeros(1, 4, 2, 64)
    assert tattn.dot_product_attention(x, x, x, use_kernel=True).shape == x.shape
    out = tattn.fused_qkv_attention(torch.zeros(1, 4, 128), torch.zeros(128, 384),
                                    torch.zeros(384), 2, use_kernel=True)
    assert out.shape == (1, 4, 128)
