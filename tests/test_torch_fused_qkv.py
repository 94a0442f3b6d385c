"""The port's fused qkv projection + attention (avt_tpu_torch/ops/
flash_attention.py: `fused_qkv_attention_reference`, `_FusedQkvAttention`)
against avt_tpu on the CPU: the plain version against the Pallas kernel
`_fused_qkv_attn_fwd_kernel` in interpret mode (out and qkv), the autograd
(dx, dW, db) against `jax.vjp` of `fused_qkv_attention(use_pallas=True)`,
and the dispatcher's rule (head dim 64 and an even head count, else the
split path), at N=2 frames, T=70 and 96, 4 heads of 64."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.ops import attention as jattn
from avt_tpu.ops.flash_attention import _fused_qkv_attn_fwd_call
from avt_tpu_torch.ops import attention as tattn
from avt_tpu_torch.ops import flash_attention as tfa

N, H, D = 2, 4, 64
C = H * D
# f32: the same math summed in another order. bf16: qkv may differ by one
# bf16 ulp where the two sides sum the projection in another order, and p and
# the output are rounded to bf16 (2^-8 relative).
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(T, seed, c=C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, T, c)).astype(np.float32) * 0.5
    w = rng.standard_normal((c, 3 * c)).astype(np.float32) * 0.05
    b = rng.standard_normal(3 * c).astype(np.float32) * 0.1
    return x, w, b


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scaled_close(out, ref, tol, what):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


@pytest.mark.parametrize("T", [70, 96])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(dtype, causal, T):
    x, w, b = _inputs(T, seed=T + causal)
    jdt = getattr(jnp, dtype)
    # the kernel gets w and b cast to x's type, as fused_qkv_attention does
    ref_o, ref_qkv = _fused_qkv_attn_fwd_call(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt), H,
        causal, True)
    tdt = getattr(torch, dtype)
    out, qkv = tfa.fused_qkv_attention_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt), H,
        causal)
    assert out.dtype == qkv.dtype == tdt
    assert out.shape == (N, T, C) and qkv.shape == (N, T, 3 * C)
    for got, ref in ((out, ref_o), (qkv, ref_qkv)):
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("T", [70, 96])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_vjp(dtype, causal, T):
    """x in the storage type, w and b f32 (parameters); the gradients come
    back in each input's own type, each scaled by its max."""
    x, w, b = _inputs(T, seed=10 + T + causal)
    g = np.random.default_rng(3).standard_normal((N, T, C)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def f(x_, w_, b_):
        return jattn.fused_qkv_attention(x_, w_, b_, H, causal=causal, use_pallas=True)

    ref_o, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b))
    ref_grads = vjp(jnp.asarray(g).astype(jdt))

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tattn.fused_qkv_attention(xt, wt, bt, H, causal=causal, use_kernel=True)
    grads = torch.autograd.grad(out, (xt, wt, bt), torch.from_numpy(g).to(tdt))
    np.testing.assert_allclose(_f32(out), _f32(ref_o), atol=TOL[dtype], rtol=TOL[dtype])
    for name, got, ref in zip(("dx", "dW", "db"), grads, ref_grads):
        assert got.dtype == (tdt if name == "dx" else torch.float32), name
        _scaled_close(got, ref, TOL[dtype], name)


@pytest.mark.parametrize("heads,head_dim", [(2, 128), (3, 64)])
def test_dispatcher_takes_the_split_path_off_head_pairs(heads, head_dim, monkeypatch):
    """use_kernel=True with head dim != 64 or an odd head count runs the split
    path, as use_pallas=True does in JAX."""
    c = heads * head_dim
    x, w, b = _inputs(70, seed=heads, c=c)
    calls = mock.Mock(wraps=tfa.fused_qkv_attention)
    monkeypatch.setattr(tfa, "fused_qkv_attention", calls)
    out = tattn.fused_qkv_attention(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), heads, use_kernel=True)
    assert calls.call_count == 0
    split = tattn.fused_qkv_attention(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(b), heads)
    assert torch.equal(out, split)
    ref = jattn.fused_qkv_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), heads,
                                    use_pallas=True)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL["float32"], rtol=TOL["float32"])


def test_dispatcher_takes_the_kernel_on_head_pairs():
    x, w, b = _inputs(70, seed=5)
    xt = torch.from_numpy(x)
    out = tattn.fused_qkv_attention(xt, torch.from_numpy(w), torch.from_numpy(b), H,
                                    use_kernel=True)
    ref, _ = tfa.fused_qkv_attention_reference(xt, torch.from_numpy(w), torch.from_numpy(b), H)
    assert torch.equal(out, ref)


def test_kernel_wrapper_refuses_a_cpu_tensor():
    """The launch path takes CUDA tensors only; the CPU runs the plain
    version through the autograd Function instead."""
    x = torch.zeros(1, 4, C)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa._launch_fused(x, torch.zeros(C, 3 * C), torch.zeros(3 * C), H, False)


def test_kernel_wrapper_with_another_source_refuses_a_cpu_tensor(tmp_path, monkeypatch):
    """The launch path built from another copy of the sources (as the turns
    tool times a parent's) refuses a CPU tensor before it builds anything."""
    load = mock.Mock(side_effect=AssertionError("built a kernel for a CPU tensor"))
    monkeypatch.setattr(tfa._build, "load", load)
    x = torch.zeros(1, 4, C)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa._launch_fused(x, torch.zeros(C, 3 * C), torch.zeros(3 * C), H, False, tmp_path)
    assert load.call_count == 0
