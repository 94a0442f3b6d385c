"""The port's packed-attention backward (avt_tpu_torch/ops/flash_attention.py)
against the JAX package's TPU backward kernels, run in Pallas interpret mode
on the CPU: the plain version the CPU wrapper runs (dqkv and the qkv-bias
gradient db), and autograd through both autograd Functions against `jax.vjp`.
The CUDA kernel itself is held against the plain version on the card in
test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.ops import flash_attention as jfa
from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import flash_attention as tfa

# Relative to max|ref|. f32: the same math summed in another order (as
# tests/test_attention.py holds the TPU backward to its reference). bf16: ds,
# p, the 1/l products and dqkv are rounded to bf16 (2^-8) at the places the
# two share, and XLA and torch accumulate the f32 products in other orders.
TOL = {"float32": 5e-4, "bfloat16": 2e-2}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(out, ref, dtype):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(out / scale, ref / scale, atol=TOL[dtype], rtol=0)


def _inputs(N, T, H, D, dtype, seed=0):
    x, do = _rand((N, T, 3 * H * D), seed), _rand((N, T, H * D), seed + 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return (jnp.asarray(x).astype(jdt), jnp.asarray(do).astype(jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(do).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_tpu_kernel_with_db(causal, dtype):
    N, T, H, D = 2, 197, 12, 64
    jx, jdo, tx, tdo = _inputs(N, T, H, D, dtype)
    jdqkv, jdb = jfa._short_attention_bwd_db_call(jx, jdo, H, causal, True)
    dqkv, db = tfa.packed_short_attention_bwd_reference(tx, tdo, H, causal, with_db=True)
    assert dqkv.dtype == tx.dtype and db.dtype == torch.float32
    _close(dqkv, jdqkv, dtype)
    _close(db, jdb[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,T,H,D", [
    pytest.param(2, 197, 12, 64, id="paired"),
    pytest.param(2, 37, 2, 32, id="unpaired"),
])
def test_bwd_reference_matches_tpu_kernel(N, T, H, D, causal, dtype):
    jx, jdo, tx, tdo = _inputs(N, T, H, D, dtype, seed=2)
    ref = jfa._short_attention_bwd_call(jx, jdo, H, causal, True)
    dqkv, db = tfa.packed_short_attention_bwd_reference(tx, tdo, H, causal)
    assert db is None
    _close(dqkv, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_through_bias_attention_matches_jax_vjp(dtype):
    N, T, H, D = 2, 197, 12, 64
    jx, jdo, tx, tdo = _inputs(N, T, H, D, dtype, seed=4)
    b = _rand(3 * H * D, 6)
    out, vjp = jax.vjp(lambda x, bb: jfa.packed_qkv_bias_attention(x, bb, H, False),
                       jx, jnp.asarray(b))
    jdx, jdb = vjp(jdo)
    tx.requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tout = tfa.packed_qkv_bias_attention(tx, tb, H, False)
    dx, db = torch.autograd.grad(tout, (tx, tb), tdo)
    assert dx.dtype == tx.dtype and db.dtype == torch.float32  # the cast's own vjp
    _close(tout, out, dtype)
    _close(dx, jdx, dtype)
    _close(db, jdb, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_through_packed_attention_matches_jax_vjp(causal):
    N, T, H, D = 2, 37, 2, 32
    jx, jdo, tx, tdo = _inputs(N, T, H, D, "float32", seed=7)
    _, vjp = jax.vjp(lambda x: jfa.packed_short_attention(x, H, causal), jx)
    (jdx,) = vjp(jdo)
    tx.requires_grad_(True)
    (dx,) = torch.autograd.grad(tfa.packed_short_attention(tx, H, causal), tx, tdo)
    _close(dx, jdx, "float32")


def test_cpu_backward_does_not_count_launches():
    _build.reset_launch_counts()
    x = torch.from_numpy(_rand((1, 20, 3 * 64), 8)).requires_grad_(True)
    b = torch.zeros(3 * 64, requires_grad=True)
    tfa.packed_qkv_bias_attention(x, b, 1).sum().backward()
    assert x.grad is not None and b.grad is not None
    assert _build.launch_counts == {name: 0 for name in _build.KERNELS}


def test_backward_wrapper_refuses_other_devices():
    x = torch.zeros(1, 8, 3 * 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa._launch_bwd(x, None, torch.zeros(1, 8, 64, device="meta"), 1, False, False)
