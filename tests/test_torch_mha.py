"""The port's functional multi-head attention (avt_tpu_torch/ops/attention.py:
`multi_head_attention`) against avt_tpu's on the CPU, outputs and
gradients, and the port's flash plain versions against avt_tpu's Pallas
flash kernels (interpret mode) where the query and key lengths differ.

Both packages keep key j for query i under a causal mask when j <= i (the
top-left diagonal), whatever Tq and Tk are: `jax.nn.dot_product_attention`'s
`is_causal`, `_flash_kernel`'s `k_pos <= q_pos`, the port's `_plain_attention`
(`tril`) and its flash plain versions (`_causal_keep`). The flash cases run
with blocks of 32, so that neither length is a multiple of the block and
both kernels pad a tail. The CUDA kernels are held against the same plain
versions at unequal lengths on the card (chip_smoke.py's `mha` phase,
tests/test_torch_cuda.py)."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.ops import attention as jattn
from avt_tpu.ops import flash_attention as jfa
from avt_tpu_torch.ops import multi_head_attention
from avt_tpu_torch.ops import attention as tattn
from avt_tpu_torch.ops import flash_attention as tfa

B, C, HEADS = 2, 32, 4
# f32: the same math summed in another order. bf16: the projections, the
# probabilities and the output are rounded to bf16 (2^-8 relative) on both
# sides (the cases here agree bit for bit, but a sum in another order may
# move a rounding); held against each output's max |value|.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
LENGTHS = [pytest.param(12, 12, id="Tq12-Tk12"), pytest.param(9, 15, id="Tq9-Tk15"),
           pytest.param(15, 9, id="Tq15-Tk9")]
WEIGHTS = ("wq", "wk", "wv", "wo")
BIASES = ("bq", "bk", "bv", "bo")


def _inputs(Tq, Tk, seed, bias=True):
    """x_q (B, Tq, C), x_kv (B, Tk, C), the four (C, C) weights at 1/sqrt(C)
    and, with `bias`, the four biases, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    arrays = {"x_q": rng.standard_normal((B, Tq, C)), "x_kv": rng.standard_normal((B, Tk, C))}
    arrays.update({w: rng.standard_normal((C, C)) / np.sqrt(C) for w in WEIGHTS})
    if bias:
        arrays.update({b: 0.1 * rng.standard_normal(C) for b in BIASES})
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _jax_mha(causal, mask):
    """a -> avt_tpu's multi_head_attention on the arrays of dict a."""
    def f(a):
        return jattn.multi_head_attention(
            a["x_q"], a["x_kv"], *(a[w] for w in WEIGHTS), HEADS, causal=causal, mask=mask,
            **{b: a[b] for b in BIASES if b in a})
    return jax.jit(f)


def _torch_mha(tensors, causal, mask):
    return multi_head_attention(
        tensors["x_q"], tensors["x_kv"], *(tensors[w] for w in WEIGHTS), HEADS, causal=causal,
        mask=mask, **{b: tensors[b] for b in BIASES if b in tensors})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scaled_err(got, want, scale=None):
    """max |got - want| over `scale`, by default max |want|."""
    got, want = _np(got), _np(want)
    scale = np.abs(want).max() if scale is None else scale
    return np.abs(got - want).max() / max(scale, 1e-6)


def _keep(Tq, Tk, seed):
    """A (B, 1, Tq, Tk) keep mask in which every query keeps key 0."""
    keep = np.random.default_rng(seed).random((B, 1, Tq, Tk)) > 0.4
    keep[..., 0] = True
    return keep


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", LENGTHS)
def test_multi_head_attention_matches_avt_tpu(Tq, Tk, causal, bias):
    arrays = _inputs(Tq, Tk, seed=Tq + 3 * Tk + 7 * causal, bias=bias)
    ref = _jax_mha(causal, None)({k: jnp.asarray(v) for k, v in arrays.items()})
    out = _torch_mha({k: torch.from_numpy(v) for k, v in arrays.items()}, causal, None)
    assert out.shape == (B, Tq, C) and out.dtype == torch.float32
    err = _scaled_err(out, ref)
    assert err <= TOL["float32"], f"{err:.3g} of max |ref|"


@pytest.mark.parametrize("Tq,Tk", LENGTHS)
def test_multi_head_attention_with_a_mask_matches_avt_tpu(Tq, Tk):
    arrays = _inputs(Tq, Tk, seed=11 * Tq + Tk)
    keep = _keep(Tq, Tk, seed=Tq * Tk)
    ref = _jax_mha(False, jnp.asarray(keep))({k: jnp.asarray(v) for k, v in arrays.items()})
    out = _torch_mha({k: torch.from_numpy(v) for k, v in arrays.items()}, False,
                     torch.from_numpy(keep))
    assert _scaled_err(out, ref) <= TOL["float32"]


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_bf16_matches_avt_tpu(causal):
    arrays = _inputs(9, 15, seed=21 + causal)
    ref = _jax_mha(causal, None)({k: jnp.asarray(v).astype(jnp.bfloat16)
                                      for k, v in arrays.items()})
    out = _torch_mha({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrays.items()},
                     causal, None)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    err = _scaled_err(out, ref)
    assert err <= TOL["bfloat16"], f"{err:.3g} of max |ref|"


@pytest.mark.parametrize("case", ["Tq9-Tk15-causal", "Tq15-Tk9-causal", "Tq12-Tk12-mask",
                                  "Tq15-Tk9-no-bias"])
def test_multi_head_attention_gradients_match_jax_grad(case):
    """Input, weight and bias gradients of <out, dout> against jax.grad."""
    Tq, Tk = {"Tq9": 9, "Tq15": 15, "Tq12": 12}[case.split("-")[0]], int(case.split("-")[1][2:])
    causal, bias = case.endswith("causal"), not case.endswith("no-bias")
    mask = _keep(Tq, Tk, seed=3) if case.endswith("mask") else None
    arrays = _inputs(Tq, Tk, seed=31 + Tq, bias=bias)
    dout = np.random.default_rng(32).standard_normal((B, Tq, C)).astype(np.float32)
    f = _jax_mha(causal, None if mask is None else jnp.asarray(mask))
    jgrads = jax.jit(jax.grad(lambda a: jnp.sum(f(a) * dout)))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    tensors = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrays.items()}
    out = _torch_mha(tensors, causal, None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad(out, list(tensors.values()), torch.from_numpy(dout))
    assert set(jgrads) == set(tensors)
    for name, got in zip(tensors, grads):
        # the key bias shifts every key's score for a query alike, which
        # the softmax ignores: dbk is 0 but for rounding on both sides, and
        # is held at the scale of dbq
        scale = np.abs(_np(jgrads["bq"])).max() if name == "bk" else None
        err = _scaled_err(got, jgrads[name], scale)
        assert err <= TOL["float32"], f"d{name}: {err:.3g} of max |ref|"


def test_multi_head_attention_takes_the_flash_path_at_unequal_lengths():
    """Causal, 20 queries over 35 keys, with the flash path asked for on
    both sides (use_kernel / use_pallas, which CUDA and the TPU take by
    themselves from 128 queries on: the plain versions here, the Pallas
    kernels in interpret mode there): outputs and gradients equal, and the
    port's call went through `flash_attention`."""
    Tq, Tk, heads = 20, 35, 2
    rng = np.random.default_rng(41)
    arrays = {"x_q": rng.standard_normal((1, Tq, C)), "x_kv": rng.standard_normal((1, Tk, C)),
              **{w: rng.standard_normal((C, C)) / np.sqrt(C) for w in WEIGHTS}}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    dout = rng.standard_normal((1, Tq, C)).astype(np.float32)
    jdpa, tdpa, tflash = jattn.dot_product_attention, tattn.dot_product_attention, \
        tfa.flash_attention
    calls = []

    def counted_flash(*args, **kwargs):
        calls.append(args[0].shape)
        return tflash(*args, **kwargs)

    with mock.patch.object(jattn, "dot_product_attention",
                           lambda *a, **k: jdpa(*a, **k, use_pallas=True)), \
            mock.patch.object(tattn, "dot_product_attention",
                              lambda *a, **k: tdpa(*a, **k, use_kernel=True)), \
            mock.patch.object(tfa, "flash_attention", counted_flash):
        def f(a):
            return jattn.multi_head_attention(a["x_q"], a["x_kv"], *(a[w] for w in WEIGHTS),
                                              heads, causal=True)

        jx = {k: jnp.asarray(v) for k, v in arrays.items()}
        ref = f(jx)
        jgrads = jax.jit(jax.grad(lambda a: jnp.sum(f(a) * dout)))(jx)
        tensors = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrays.items()}
        out = multi_head_attention(tensors["x_q"], tensors["x_kv"],
                                   *(tensors[w] for w in WEIGHTS), heads, causal=True)
        grads = torch.autograd.grad(out, list(tensors.values()), torch.from_numpy(dout))
    assert calls == [(1, Tq, heads, C // heads)]
    assert _scaled_err(out, ref) <= TOL["float32"]
    for name, got in zip(tensors, grads):
        assert _scaled_err(got, jgrads[name]) <= TOL["float32"], name


# --------------------------------------------- flash plain versions, Tq != Tk
BLOCK = 32  # neither length below is a multiple of it
FLASH_LENGTHS = [pytest.param(20, 35, id="Tq20-Tk35"), pytest.param(35, 20, id="Tq35-Tk20")]


def _flash_inputs(Tq, Tk, seed, H=1, D=64):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Tq, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Tk, H, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", FLASH_LENGTHS)
def test_flash_plain_versions_match_tpu_kernels_at_unequal_lengths(Tq, Tk, causal):
    """`flash_attention_reference` (out, lse) against `_flash_attention_fwd`
    and `flash_attention_bwd_reference` (dq, dk, dv) against
    `_flash_attention_bwd`, both in interpret mode with 32-row blocks; each
    backward from its own side's forward, delta as `_fa_bwd` forms it."""
    q, k, v, do = _flash_inputs(Tq, Tk, seed=Tq + Tk + causal)
    jx = [jnp.asarray(x) for x in (q, k, v, do)]
    blocks = dict(causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)
    jout, jlse = jfa._flash_attention_fwd(*jx[:3], want_lse=True, **blocks)
    tq_pad = jlse.shape[-1]
    delta = jnp.sum(jx[3] * jout, axis=-1)  # (B, Tq, H)
    delta = jnp.pad(delta, ((0, 0), (0, tq_pad - Tq), (0, 0))).transpose(0, 2, 1)
    jgrads = jfa._flash_attention_bwd(*jx, jlse, delta, **blocks)
    tx = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = tfa.flash_attention_reference(*tx[:3], causal)
    grads = tfa.flash_attention_bwd_reference(*tx, out, lse, causal)
    assert out.shape == (B, Tq, 1, 64) and lse.shape == (B, 1, Tq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL["float32"],
                               rtol=TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., :Tq], atol=TOL["float32"],
                               rtol=TOL["float32"])
    for name, got, want in zip("qkv", grads, jgrads):
        assert got.shape == want.shape
        err = _scaled_err(got, want)
        assert err <= TOL["float32"], f"d{name}: {err:.3g} of max |ref|"


@pytest.mark.parametrize("Tq,Tk", FLASH_LENGTHS)
def test_the_ports_three_causal_masks_agree_at_unequal_lengths(Tq, Tk):
    """`_plain_attention`'s tril, the flash plain versions' `_causal_keep`
    (at key offsets of a 128-key block and of none) and JAX's is_causal keep
    the same (query, key) pairs; and the plain path equals the flash plain
    version, both against jax.nn.dot_product_attention."""
    keep = torch.ones(Tq, Tk, dtype=torch.bool).tril()
    assert torch.equal(tfa._causal_keep(Tq, 0, Tk, "cpu"), keep)
    assert torch.equal(torch.cat([tfa._causal_keep(Tq, k0, min(32, Tk - k0), "cpu")
                                  for k0 in range(0, Tk, 32)], dim=1), keep)
    q, k, v, _ = _flash_inputs(Tq, Tk, seed=5)
    ref = jax.jit(lambda a, b, c: jax.nn.dot_product_attention(a, b, c, is_causal=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tx = [torch.from_numpy(x) for x in (q, k, v)]
    plain = tattn.dot_product_attention(*tx, causal=True)
    flash, _ = tfa.flash_attention_reference(*tx, causal=True)
    for got in (plain, flash):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL["float32"],
                                   rtol=TOL["float32"])
