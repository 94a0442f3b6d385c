"""The feature path of expts/02 (identity backbone + AVT-h + linear
classifier over 3806 actions, on 1024-d pre-extracted features) against
avt_tpu on the CPU, at a long observed context (T=130, past the dispatcher's
128-token threshold) and a small width: AVT-h of 2 layers, inter_dim 256,
2 heads of 128. The JAX package's weights go to the port through
`params_from_jax`. Compared: the eval step (`make_eval_step`: logits, the
unreduced losses, the auxiliary feature loss, accuracies) on the plain
attention and on the flash path (the port's plain flash versions against
the Pallas kernels in interpret mode), and one nesterov SGD train step
(`make_train_step`) on the flash path with every dropout rate 0, since JAX's
and torch's random bits differ: losses and updated parameters."""
import functools
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import avt_tpu.models.layers as jlayers
from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityBackbone as JIdentityBackbone,
    LinearClassifier as JLinearClassifier,
)
from avt_tpu.models.flagship import build_avt as jbuild_avt
from avt_tpu.train import TrainState, build_optimizer as jbuild_optimizer
from avt_tpu.train import make_eval_step as jmake_eval_step, make_train_step as jmake_train_step
import avt_tpu_torch.models.layers as tlayers
from avt_tpu_torch import build_avt, make_eval_step, make_train_step
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, IdentityBackbone, LinearClassifier
from avt_tpu_torch.models.convert import load_jax_params, opt_state_from_jax, params_from_jax
from avt_tpu_torch.ops import flash_attention as tfa
from avt_tpu_torch.train import build_optimizer

FEAT, N_CLS, B, T = 1024, 3806, 2, 130
AVTH = dict(inter_dim=256, n_layer=2, n_head=2)
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
# expts/02's optimizer (SGD, nesterov, warmup + cosine) on a short schedule
# and a larger LR, so that the compared step moves every parameter
OPT = dict(lr_wd=[["__all__", 0.1, 1e-6]], optimizer_name="sgd", scheduler_name="cosine",
           iters_per_epoch=4, num_epochs=3, warmup_epochs=1,
           optimizer_kwargs={"nesterov": True})
# f32 throughout, the same math summed in another order: logits to 2e-4,
# each parameter's update to 2e-4 of its max |JAX value|, losses to 1e-5
# relative.
TOL = {"out": 2e-4, "loss": 1e-5, "update": 2e-4}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(video=rng.standard_normal((B, T, FEAT, 1, 1, 1)).astype(np.float32),
                target=rng.integers(0, N_CLS, size=B),
                tsub=rng.integers(-1, N_CLS, size=(B, T, 1)))


def _jbatch(b):
    return {"video": jnp.asarray(b["video"]), "target": {"action": jnp.asarray(b["target"])},
            "target_subclips": {"action": jnp.asarray(b["tsub"])}}


def _tbatch(b):
    return {"video": torch.from_numpy(b["video"]),
            "target": {"action": torch.from_numpy(b["target"])},
            "target_subclips": {"action": torch.from_numpy(b["tsub"])}}


@pytest.fixture
def flash_path(monkeypatch):
    """Both sides' SelfAttention on their flash kernels: the Pallas kernels in
    interpret mode, the port's plain flash versions; returns the mock that
    counts the port's flash_attention calls."""
    monkeypatch.setattr(jlayers, "dot_product_attention",
                        functools.partial(jlayers.dot_product_attention, use_pallas=True))
    monkeypatch.setattr(tlayers, "dot_product_attention",
                        functools.partial(tlayers.dot_product_attention, use_kernel=True))
    calls = mock.Mock(wraps=tfa.flash_attention)
    monkeypatch.setattr(tfa, "flash_attention", calls)
    return calls


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scaled_close(out, ref, tol, what):
    ref, out = _f32(ref), _f32(out)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


def _eval_results(path, request):
    calls = request.getfixturevalue("flash_path") if path == "flash" else None
    jm = jbuild_avt(num_actions=N_CLS, backbone="identity", backbone_dim=FEAT, **AVTH)
    b = _batch(0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(b["video"]), (B,))
    ref = jmake_eval_step(jm, {"action": N_CLS})(params, _jbatch(b))
    model = build_avt(num_actions=N_CLS, backbone="identity", backbone_dim=FEAT, device="cpu",
                      seed=0, **AVTH)
    load_jax_params(model, params)
    model.train()  # the eval step switches to eval mode itself
    res = make_eval_step(model, {"action": N_CLS})(_tbatch(b))
    return res, ref, calls, model


@pytest.mark.parametrize("path", ["plain", "flash"])
def test_eval_step_matches_avt_tpu(path, request):
    res, ref, calls, model = _eval_results(path, request)
    assert set(res) == set(ref) == {"logits/action", "loss/cls_action", "aux_loss/feat",
                                    "acc1/action", "acc5/action"}
    assert not model.training and not any(v.requires_grad for v in res.values())
    assert res["logits/action"].shape == (B, N_CLS) and res["loss/cls_action"].shape == (B,)
    np.testing.assert_allclose(_f32(res["logits/action"]), _f32(ref["logits/action"]),
                               atol=TOL["out"], rtol=TOL["out"])
    for key in ("loss/cls_action", "aux_loss/feat"):
        np.testing.assert_allclose(_f32(res[key]), _f32(ref[key]), rtol=TOL["loss"], err_msg=key)
    for key in ("acc1/action", "acc5/action"):
        assert res[key].item() == pytest.approx(float(ref[key]), abs=1e-4)
    if calls is not None:
        assert calls.call_count == AVTH["n_layer"]


def _jmodel():
    return JAVTModel(
        backbone=JIdentityBackbone(),
        temporal_aggregator=JIdentityAgg(in_features=FEAT),
        future_predictor=JAVTh(in_features=FEAT, output_len=1, avg_last_n=1,
                               return_past_too=True, embd_pdrop=0.0, attn_pdrop=0.0,
                               resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=FEAT),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=FEAT, dropout=0.0,
        classifier_on_past=True)


def _tmodel():
    return AVTModel(
        backbone=IdentityBackbone(),
        temporal_aggregator=IdentityAgg(in_features=FEAT),
        future_predictor=AVTh(in_features=FEAT, output_len=1, avg_last_n=1,
                              return_past_too=True, embd_pdrop=0.0, attn_pdrop=0.0,
                              resid_pdrop=0.0,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=FEAT),
        classifiers={"action": LinearClassifier(FEAT, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=FEAT, dropout=0.0,
        classifier_on_past=True)


def _jax_trace(opt_state):
    """The momentum tree of every group, merged (optax masks each group's
    tree to its own parameters)."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    traces = [st.inner_state[1][0].trace for label, st in opt_state.inner_states.items()
              if label != "frozen"]
    return jax.tree.map(lambda *xs: next(x for x in xs if not masked(x)), *traces,
                        is_leaf=masked)


def test_train_step_matches_avt_tpu(flash_path):
    """After one warm-up step (LR 0, momentum set), one step at the first
    warmup LR on both sides."""
    jm = _jmodel()
    b0, b1 = _batch(1), _batch(2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(b0["video"]), (B,))
    tx, _ = jbuild_optimizer(params, **OPT)
    step = jmake_train_step(jm, tx, LOSS_WTS, {"action": N_CLS}, donate=False)
    key = jax.random.PRNGKey(1)
    state, _ = step(TrainState.create(params, tx), _jbatch(b0), key)
    new_state, jmetrics = step(state, _jbatch(b1), key)

    model = load_jax_params(_tmodel(), state.params)
    opt, _ = build_optimizer(model, **OPT)
    opt.load_state_dict(opt_state_from_jax(_jax_trace(state.opt_state), count=1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    flash_path.reset_mock()
    metrics = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS})(_tbatch(b1))
    assert flash_path.call_count == AVTH["n_layer"]
    assert set(metrics) == set(jmetrics)
    for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=TOL["loss"],
                                   err_msg=key)
    jbefore, jafter = params_from_jax(state.params), params_from_jax(new_state.params)
    assert set(jafter) == set(before)
    for name, p in model.named_parameters():
        update = p.detach() - before[name]
        assert update.abs().max() > 0, f"{name} did not move"
        _scaled_close(update, jafter[name] - jbefore[name], TOL["update"], f"update {name}")
