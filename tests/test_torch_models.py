"""The port's models (avt_tpu_torch/models) against avt_tpu's on the CPU at
small sizes, with the JAX package's initial weights carried over by
`params_from_jax`: ViT, GPT2Core, AVTh and the 3-crop+flip AVTModel eval
forward, in f32 and in bf16; the converter round trip; init statistics."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    LinearClassifier as JLinearClassifier,
    ViT as JViT,
)
from avt_tpu.models.import_torch import avt_checkpoint_to_flax
from avt_tpu.models.layers import GPT2Core as JGPT2Core
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import (
    AVTh,
    AVTModel,
    GPT2Core,
    IdentityAgg,
    LinearClassifier,
    ViT,
    build_avt,
)
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax

# f32: the same math summed in another order (XLA vs torch CPU kernels).
F32_TOL = 2e-4
# bf16: both sides round activations to bf16 (2^-8 relative) after every
# layer but at slightly different places (GELU's tanh form is evaluated in
# f32 by torch and in bf16 ops by XLA; matmul accumulation orders differ), so
# a few bf16 ulps of drift build up over the layers.
BF16_TOL = 3e-2

DIM, N_CLS = 128, 10


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, tol):
    out = out.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def _jvit(dtype=None):
    return JViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2, dtype=dtype)


def _tvit(dtype=None):
    return ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2, dtype=dtype)


@pytest.mark.parametrize("jdt,tdt,tol", [
    (None, None, F32_TOL), (jnp.bfloat16, torch.bfloat16, BF16_TOL)], ids=["f32", "bf16"])
def test_vit_matches_avt_tpu(jdt, tdt, tol):
    video = _rand((2, 3, 3, 32, 32), 0)
    jm = _jvit(jdt)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video))
    ref = jax.jit(jm.apply)(params, jnp.asarray(video))
    tm = load_jax_params(_tvit(tdt), params).eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(video))
    assert out.dtype == torch.float32 and out.shape == (2, DIM, 3, 1, 1)
    _close(out, ref, tol)


@pytest.mark.parametrize("jdt,tdt,tol", [
    (None, None, F32_TOL), (jnp.bfloat16, torch.bfloat16, BF16_TOL)], ids=["f32", "bf16"])
def test_gpt2_core_matches_avt_tpu(jdt, tdt, tol):
    x = _rand((3, 10, 64), 1)
    jm = JGPT2Core(n_layer=2, n_head=2, n_positions=16, dtype=jdt)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = load_jax_params(GPT2Core(64, n_layer=2, n_head=2, n_positions=16, dtype=tdt), params)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    _close(out, ref, tol)


def _javth(dtype=None):
    return JAVTh(in_features=64, inter_dim=32, n_layer=2, n_head=2, output_len=1,
                 avg_last_n=1, return_past_too=True,
                 future_pred_loss=lambda p, t: jmse(p, t, reduction="none"), dtype=dtype)


def _tavth(dtype=None):
    return AVTh(in_features=64, inter_dim=32, n_layer=2, n_head=2, output_len=1,
                avg_last_n=1, return_past_too=True,
                future_pred_loss=lambda p, t: mse(p, t, reduction="none"), dtype=dtype)


def test_avth_matches_avt_tpu():
    feats = _rand((2, 10, 64), 2)
    jm = _javth()
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(feats))
    jpast, jfinal, jloss, _ = jax.jit(jm.apply)(params, jnp.asarray(feats))
    tm = load_jax_params(_tavth(), params).eval()
    with torch.no_grad():
        past, final, loss, endpoints = tm(torch.from_numpy(feats))
    assert endpoints == {} and set(loss) == set(jloss) == {"feat"}
    _close(past, jpast, F32_TOL)
    _close(final, jfinal, F32_TOL)
    _close(loss["feat"], jloss["feat"], F32_TOL)


def _jmodel(dtype=None):
    return JAVTModel(
        backbone=_jvit(dtype),
        temporal_aggregator=JIdentityAgg(in_features=DIM),
        future_predictor=JAVTh(in_features=DIM, inter_dim=64, n_layer=2, n_head=2,
                               output_len=1, avg_last_n=1, return_past_too=True,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               dtype=dtype),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=DIM),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),),
        backbone_dim=DIM, dropout=0.2, classifier_on_past=True,
    )


def _tmodel(dtype=None):
    return AVTModel(
        backbone=_tvit(dtype),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, inter_dim=64, n_layer=2, n_head=2,
                              output_len=1, avg_last_n=1, return_past_too=True,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"),
                              dtype=dtype),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=DIM),
        classifiers={"action": LinearClassifier(DIM, N_CLS)},
        num_classes=(("action", N_CLS),),
        backbone_dim=DIM, dropout=0.2, classifier_on_past=True,
    )


@pytest.fixture(scope="module")
def jparams():
    video = _rand((1, 1, 6, 3, 2, 32, 32), 3)
    return jax.jit(_jmodel().init)(jax.random.PRNGKey(3), jnp.asarray(video))


@pytest.mark.parametrize("jdt,tdt,tol", [
    (None, None, F32_TOL), (jnp.bfloat16, torch.bfloat16, BF16_TOL)], ids=["f32", "bf16"])
def test_avt_model_3crop_flip_eval_matches_avt_tpu(jparams, jdt, tdt, tol):
    # (B, #clips, #crops = 3 crops + flips, C, T, H, W), crops averaged
    video = _rand((2, 1, 6, 3, 4, 32, 32), 4)
    jout, jloss = jax.jit(_jmodel(jdt).apply)(jparams, jnp.asarray(video))
    tm = load_jax_params(_tmodel(tdt), jparams).eval()
    with torch.no_grad():
        out, loss = tm(torch.from_numpy(video))
    assert set(out) == set(jout) and set(loss) == set(jloss)
    assert out["logits/action"].shape == (2, N_CLS)
    for key in jout:
        _close(out[key], jout[key], tol)
    _close(loss["feat"], jloss["feat"], tol)


def test_converter_round_trip(jparams):
    sd = params_from_jax(jparams)
    back = avt_checkpoint_to_flax(sd)
    flat_ref = jax.tree_util.tree_flatten_with_path(jparams["params"])[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))


def test_state_dict_uses_reference_names():
    names = set(_tmodel().state_dict())
    assert {"backbone.model.blocks.0.attn.qkv.weight", "backbone.model.patch_embed.proj.weight",
            "future_predictor.gpt_model.h.1.attn.c_attn.weight",
            "future_predictor.gpt_model.wpe.weight", "future_predictor.encoder.weight",
            "classifiers.action.weight", "classifiers.action.bias"} <= names


def test_build_avt_init_statistics():
    m = build_avt(num_actions=20, inter_dim=256, n_layer=1, n_head=2, device="cpu", seed=0)
    sd = m.state_dict()
    vit = "backbone.model."
    assert not m.training
    assert sd[vit + "blocks.0.attn.qkv.weight"].std().item() == pytest.approx(0.01, rel=0.02)
    assert sd["future_predictor.gpt_model.h.0.mlp.c_fc.weight"].std().item() == \
        pytest.approx(0.02, rel=0.02)
    assert sd["future_predictor.encoder.weight"].std().item() == pytest.approx(0.01, rel=0.02)
    pos = sd[vit + "pos_embed"]
    assert pos.abs().max().item() <= 0.04 and pos.std().item() == pytest.approx(0.0176, rel=0.05)
    patch = sd[vit + "patch_embed.proj.weight"]
    assert patch.std().item() == pytest.approx(768 ** -0.5, rel=0.05)
    assert torch.equal(sd[vit + "blocks.0.norm1.weight"], torch.ones(768))
    assert not sd[vit + "blocks.0.attn.qkv.bias"].any()
    torch.manual_seed(0)
    again = build_avt(num_actions=20, inter_dim=256, n_layer=1, n_head=2, device="cpu", seed=0)
    assert torch.equal(again.state_dict()[vit + "pos_embed"], pos)
