"""The port's blocked flash attention (avt_tpu_torch/ops/flash_attention.py)
against the JAX package's TPU kernels, run in Pallas interpret mode on the
CPU: the plain forward (out and lse) the CPU wrapper runs against
`_flash_kernel`, the plain backward through autograd against `jax.vjp` of
`flash_attention_vjp` (`_dq_kernel` + `_dkv_kernel`), and the dispatch of
`dot_product_attention`. T=130 and 200 pad the last 128-key block and span
two; D=512 is AVT-h's head of expts/02. The CUDA kernels themselves are held
against these plain versions on the card in test_torch_cuda.py and
chip_smoke.py."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.ops import attention as jattn
from avt_tpu.ops import flash_attention as jfa
from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import attention as tattn
from avt_tpu_torch.ops import flash_attention as tfa

# f32: the same math summed in another order. bf16: q', p and the results
# are rounded to bf16 (2^-8 relative) at the places the two share, and XLA
# and torch accumulate the f32 products in other orders. The backward is held
# relative to each gradient's max |value|.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}

SHAPES = [  # (T, H, D)
    pytest.param(130, 2, 64, id="T130-D64"),
    pytest.param(200, 1, 512, id="T200-D512"),
]


def _heads(T, H, D, seed, B=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,H,D", SHAPES)
def test_flash_reference_matches_tpu_kernel(T, H, D, causal, dtype):
    q, k, v, _ = _heads(T, H, D, seed=T + D)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    ref = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    _, ref_lse = jfa._flash_attention_fwd(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                                          interpret=True, want_lse=True)
    out, lse = tfa.flash_attention_reference(tq, tk, tv, causal)
    assert out.shape == (2, T, H, D) and out.dtype == tq.dtype
    assert lse.shape == (2, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(ref_lse)[..., :T], atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,H,D", SHAPES)
def test_flash_backward_matches_tpu_kernels(T, H, D, causal, dtype):
    q, k, v, do = _heads(T, H, D, seed=2 * T + D)
    jx = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_vjp(a, b, c, causal), *jx)
    jgrads = vjp(jnp.asarray(do).astype(dtype))
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*tx, causal)
    grads = torch.autograd.grad(out, tx, torch.from_numpy(do).to(getattr(torch, dtype)))
    np.testing.assert_allclose(_np(out), _np(jout), atol=TOL[dtype], rtol=TOL[dtype])
    for name, got, want in zip("qkv", grads, jgrads):
        assert got.dtype == tx[0].dtype, name
        scale = max(np.abs(_np(want)).max(), 1e-6)
        err = np.abs(_np(got) - _np(want)).max() / scale
        assert err <= TOL[dtype], f"d{name}: {err:.3g} of max |ref| (limit {TOL[dtype]})"


@pytest.mark.parametrize("causal", [False, True])
def test_dispatch_use_kernel_matches_use_pallas(causal):
    q, k, v, _ = _heads(130, 2, 64, seed=3)
    ref = jattn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                      use_pallas=True)
    out = tattn.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                      use_kernel=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL["float32"], rtol=TOL["float32"])


def test_dispatch_default_on_cpu_takes_plain_path():
    q, k, v, _ = _heads(130, 2, 64, seed=4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with mock.patch.object(tfa, "flash_attention", side_effect=AssertionError("kernel path")):
        out = tattn.dot_product_attention(tq, tk, tv, causal=True)
    ref = jax.nn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL["float32"], rtol=TOL["float32"])
    with pytest.raises(ValueError, match="mask"):
        tattn.dot_product_attention(tq, tk, tv, mask=torch.ones(130, 130, dtype=torch.bool),
                                    use_kernel=True)


def test_flash_wrapper_counts_no_cpu_launch_and_refuses_other_devices():
    q, k, v, _ = _heads(130, 1, 64, seed=5, B=1)
    _build.reset_launch_counts()
    x = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tfa.flash_attention(*x, causal=True).sum().backward()
    assert all(t.grad is not None for t in x)
    assert _build.launch_counts == {name: 0 for name in _build.KERNELS}
    meta = torch.zeros(1, 130, 1, 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention(meta, meta, meta)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa._launch_flash_bwd(meta, meta, meta, meta, None, None, False)


def test_flash_scale_is_rounded_to_storage_type():
    # the TPU kernel's q * sm_scale takes q's dtype; 1/sqrt(512) is inexact
    assert tfa._flash_scale(512, torch.bfloat16) == 0.044189453125
    assert tfa._flash_scale(512, torch.float32) == pytest.approx(512 ** -0.5, rel=1e-7)
    assert tfa._flash_scale(64, torch.bfloat16) == 0.125
