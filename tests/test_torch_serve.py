"""The port's eval preprocessing and serving layer (avt_tpu_torch/data/
transforms.py, avt_tpu_torch/serve.py) against avt_tpu's on the CPU: the
torch-exact resize, 1/3 crops and flips of `VideoPreprocessor.eval_fn`, the
fused preprocess+forward, and the `batch_predict` pad/trim host loop."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.data import transforms as jtf
from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    LinearClassifier as JLinearClassifier,
    ViT as JViT,
)
from avt_tpu.serve import make_eval_forward as jmake_eval_forward
from avt_tpu_torch.data import transforms as ttf
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, LinearClassifier, ViT
from avt_tpu_torch.models.convert import load_jax_params
from avt_tpu_torch.serve import batch_predict, make_eval_forward

PP_KW = dict(crop_size=32, scale_h=36, scale_w=-1, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
DIM, N_CLS = 64, 8


def _frames(n, seed=0, T=2, H=40, W=54):
    return np.random.default_rng(seed).integers(0, 256, size=(n, T, H, W, 3)).astype(np.uint8)


@pytest.mark.parametrize("crops,flip,dtype,extra", [
    (1, False, "float32", {}), (3, True, "float32", {}), (3, True, "bfloat16", {}),
    (1, True, "float32", dict(scale_pix_val=255.0, reverse_channels=True, scale_w=60))])
def test_eval_fn_matches_avt_tpu(crops, flip, dtype, extra):
    frames = _frames(2)
    kw = dict(PP_KW, eval_num_crops=crops, eval_flip_crops=flip, **extra)
    ref = jtf.VideoPreprocessor(**kw, compute_dtype=getattr(jnp, dtype)).eval_fn(
        jnp.asarray(frames))
    out = ttf.VideoPreprocessor(**kw, compute_dtype=getattr(torch, dtype),
                                device="cpu").eval_fn(frames)
    assert out.shape == ref.shape == (2, crops * (2 if flip else 1), 3, 2, 32, 32)
    # f32 interpolation on both sides, one rounding per tap as torch's kernel
    # (relative: scale_pix_val=255 puts pixels at up to 510 after normalising)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_resize_matches_torch_interpolate():
    x = np.random.default_rng(1).random((1, 3, 37, 50)).astype(np.float32) * 255
    want = torch.nn.functional.interpolate(torch.from_numpy(x), size=(24, 71), mode="bilinear",
                                           align_corners=False, antialias=False)
    got = ttf.resize_bilinear_torch(torch.from_numpy(x).permute(0, 2, 3, 1), 24, 71)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, atol=1e-4, rtol=0)


def test_eval_resize_shape_and_size_parsing():
    pp = ttf.VideoPreprocessor(crop_size=224, scale_h=248, scale_w=-1, device="cpu")
    jpp = jtf.VideoPreprocessor(crop_size=224, scale_h=248, scale_w=-1)
    assert pp._eval_resize_shape(256, 342) == jpp._eval_resize_shape(256, 342) == (248, 331)
    assert ttf._parse_size("248-280") == jtf._parse_size("248-280") == (248, 280)
    assert ttf._parse_size(224) == (224, 224)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JAVTModel(
        backbone=JViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2),
        temporal_aggregator=JIdentityAgg(in_features=DIM),
        future_predictor=JAVTh(in_features=DIM, inter_dim=DIM, n_layer=2, n_head=2,
                               output_len=1, avg_last_n=1, return_past_too=True,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none")),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=DIM),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True,
    )
    tmodel = AVTModel(
        backbone=ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, inter_dim=DIM, n_layer=2, n_head=2,
                              output_len=1, avg_last_n=1, return_past_too=True,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none")),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=DIM),
        classifiers={"action": LinearClassifier(DIM, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True,
    )
    kw = dict(PP_KW, eval_num_crops=3, eval_flip_crops=True)
    jpp = jtf.VideoPreprocessor(**kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jpp.eval_fn(jnp.asarray(_frames(1)))[:, None])
    tmodel = load_jax_params(tmodel, params).eval()
    outputs = ("logits/action", "past_logits/action")
    jfwd = jax.jit(jmake_eval_forward(jmodel, jpp, outputs))
    tfwd = make_eval_forward(tmodel, ttf.VideoPreprocessor(**kw, device="cpu"), outputs)
    return params, jfwd, tfwd


def test_eval_forward_matches_avt_tpu(tiny):
    params, jfwd, tfwd = tiny
    frames = _frames(3, seed=2)
    ref = jfwd(params, jnp.asarray(frames))
    out = tfwd(frames)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-4, rtol=2e-4)


def test_batch_predict_pads_trims_and_handles_empty(tiny):
    _, _, tfwd = tiny
    frames = _frames(5, seed=3)
    calls = []

    def counted(chunk):
        calls.append(chunk.shape[0])
        return tfwd(chunk)

    res = batch_predict(counted, frames, batch_size=2)
    assert calls == [2, 2, 2]  # the 1-clip tail ran padded to the batch size
    assert res["logits/action"].shape == (5, N_CLS)
    assert res["past_logits/action"].shape == (5, 2, N_CLS)
    whole = tfwd(frames)
    np.testing.assert_allclose(res["logits/action"], whole["logits/action"].numpy(),
                               atol=1e-5, rtol=1e-5)
    empty = batch_predict(tfwd, frames[:0], batch_size=2)
    assert empty["logits/action"].shape == (0, N_CLS)
    assert empty["past_logits/action"].shape == (0, 2, N_CLS)
