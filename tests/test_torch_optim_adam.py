"""The port's Adam, AdamW, Adafactor and plateau scaler
(avt_tpu_torch/train/optim.py) against avt_tpu's `build_optimizer` (optax
0.2.6) on the CPU, on the parameters of a small expts/08-shaped feature
model (identity backbone, AVT-h of 2 layers, a linear classifier): after two
steps on the JAX side, the state goes to the port through
`opt_state_from_jax`, then both sides take three steps on the same fixed
gradients. Compared: each parameter's update and the optimizer's state.
Adafactor also on a small ViT backbone (depth 2, 2 heads of 32, 32x32
frames), whose patch embedding is a conv weight laid out differently on the
two sides. Also one expts/08 train step (`make_train_step` with Adam, past
classification off, the feature loss at weight 2) against avt_tpu's."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityBackbone as JIdentityBackbone,
    LinearClassifier as JLinearClassifier,
    ViT as JViT,
)
from avt_tpu.train import TrainState, build_optimizer as jbuild_optimizer
from avt_tpu.train import make_train_step as jmake_train_step
from avt_tpu.train import optim as joptim
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import (
    AVTh, AVTModel, IdentityAgg, IdentityBackbone, LinearClassifier, ViT,
)
from avt_tpu_torch.models.convert import load_jax_params, opt_state_from_jax, params_from_jax
from avt_tpu_torch.train import ReduceLROnPlateau, build_optimizer, make_train_step

FEAT, N_CLS, B, T = 64, 12, 2, 10
AVTH = dict(inter_dim=64, n_layer=2, n_head=2)
VIT = dict(img_size=32, patch_size=16, embed_dim=FEAT, depth=2, num_heads=2)
CLIPS = 2  # ViT-backbone batches: 2 one-frame clips of 32x32
PATCH = "backbone.model.patch_embed.proj.weight"
# expts/08's loss weights: the action classifier and the feature loss at 2
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 0.0, "feat": 2.0}
# f32 on both sides, the same operations in the same order up to the
# library's summation order and a few fused multiplies: each update and each
# state tensor to 1e-4 of its max |JAX value|. A bf16 first moment can round
# to the neighbouring bf16 value once the f32 moments differ in their last
# bits, a 2^-8 step of it that the next updates carry: 2^-7 there.
TOL = {None: 1e-4, "bfloat16": 2 ** -7}
# The train step: the gradients agree to ~1e-6 of their scale (another
# summation order), but Adam divides each element by its own running RMS, so
# an element whose gradient is near zero turns that difference into a
# visible share of its update (~+-lr whatever the gradient's size).
STEP_UPDATE_TOL = 2e-3


def _jmodel(dropout=0.0, vit=False):
    return JAVTModel(
        backbone=JViT(**VIT) if vit else JIdentityBackbone(),
        temporal_aggregator=JIdentityAgg(in_features=FEAT),
        future_predictor=JAVTh(in_features=FEAT, output_len=1, avg_last_n=1,
                               return_past_too=True, embd_pdrop=0.0, attn_pdrop=0.0,
                               resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=FEAT),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=FEAT, dropout=dropout,
        classifier_on_past=False)


def _tmodel(vit=False):
    return AVTModel(
        backbone=ViT(**VIT) if vit else IdentityBackbone(),
        temporal_aggregator=IdentityAgg(in_features=FEAT),
        future_predictor=AVTh(in_features=FEAT, output_len=1, avg_last_n=1,
                              return_past_too=True, embd_pdrop=0.0, attn_pdrop=0.0,
                              resid_pdrop=0.0,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=FEAT),
        classifiers={"action": LinearClassifier(FEAT, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=FEAT, dropout=0.0,
        classifier_on_past=False)


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


def _params(vit=False):
    if vit:
        video = np.random.default_rng(0).standard_normal((B, CLIPS, 3, 1, 32, 32))
    else:
        video = _batch(0)["video"]
    return jax.jit(_jmodel(vit=vit).init)(jax.random.PRNGKey(0),
                                          jnp.asarray(video.astype(np.float32)), (B,))


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
                        params)


def _scaled_close(out, ref, tol, what):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = ref.detach().float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


def _opt_kw(name, momentum_dtype, scheduler="cosine", **sched_kw):
    kw = dict(lr_wd=[["__all__", 1e-2, 5e-2]], optimizer_name=name, scheduler_name=scheduler,
              iters_per_epoch=2, num_epochs=6, warmup_epochs=1, bias_bn_wd_scale=0.5,
              optimizer_kwargs={"betas": (0.8, 0.99), "eps": 1e-6})
    if momentum_dtype is not None:
        kw["optimizer_kwargs"]["momentum_dtype"] = momentum_dtype
    if sched_kw:
        kw["scheduler_kwargs"] = sched_kw
    return kw


def _run(kw, plateau_metrics=None, vit=False):
    """Two JAX steps, the state carried to the port, then three steps on
    both sides; returns the port optimizer, the JAX state and the updates."""
    params = _params(vit)
    tx, _ = jbuild_optimizer(params, **kw)
    state = tx.init(params)
    jplat = tplat = None
    if plateau_metrics is not None:
        jplat = joptim.ReduceLROnPlateau(patience=0, factor=0.5)
        tplat = ReduceLROnPlateau(patience=0, factor=0.5)
    for k in range(2):
        updates, state = tx.update(_grads(params, k), state, params)
        params = optax.apply_updates(params, updates)
        if jplat is not None:
            state = jplat.step(state, plateau_metrics[k])
            tplat.load_state_dict(jplat.state_dict())
    model = load_jax_params(_tmodel(vit), params)
    opt, _ = build_optimizer(model, **kw)
    opt.load_state_dict(opt_state_from_jax(state))
    assert opt.count == 2
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    jstart = params_from_jax(params)
    named = dict(model.named_parameters())
    for k in range(2, 5):
        grads = _grads(params, k)
        for name, g in params_from_jax(grads).items():
            named[name].grad = g
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        if jplat is not None:
            state = jplat.step(state, plateau_metrics[k])
            tplat.step(opt, plateau_metrics[k])
    jend = params_from_jax(params)
    return opt, state, {n: (named[n].detach() - start[n], jend[n] - jstart[n]) for n in named}


@pytest.mark.parametrize("name,momentum_dtype", [
    ("adam", None), ("adam", "bfloat16"), ("adamw", None), ("adamw", "bfloat16"),
    ("adafactor", None)])
def test_optimizer_matches_optax(name, momentum_dtype):
    opt, state, updates = _run(_opt_kw(name, momentum_dtype))
    assert opt.count == 5
    tol = TOL[momentum_dtype]
    for n, (got, want) in updates.items():
        assert want.abs().max() > 0, n
        _scaled_close(got, want, tol, f"update {n}")
    ref = opt_state_from_jax(state)
    assert ref["count"] == 5
    kinds = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "adafactor": ("row", "col", "v")}[name]
    assert set(opt.state) == set(kinds)
    for kind in kinds:
        assert set(opt.state[kind]) == set(ref[kind]) and ref[kind]
        for n, buf in opt.state[kind].items():
            _scaled_close(buf, ref[kind][n], tol, f"{kind} {n}")
    if momentum_dtype is not None:
        assert all(b.dtype == torch.bfloat16 for b in opt.state["mu"].values())


def test_adafactor_on_a_vit_backbone_matches_optax():
    """The patch embedding's conv weight is (out, in, kh, kw) in the port and
    (kh, kw, in, out) in flax, no transpose of it: the port factors its
    second moment over the flax kernel's last two axes, as JAX does, so the
    updates and the row and col moments agree."""
    opt, state, updates = _run(_opt_kw("adafactor", None), vit=True)
    assert PATCH in updates
    for n, (got, want) in updates.items():
        assert want.abs().max() > 0, n
        _scaled_close(got, want, TOL[None], f"update {n}")
    assert tuple(opt.state["row"][PATCH].shape) == (16, 16, 3)
    assert tuple(opt.state["col"][PATCH].shape) == (16, 16, FEAT)
    ref = opt_state_from_jax(state)
    for kind in ("row", "col", "v"):
        assert set(opt.state[kind]) == set(ref[kind]) and ref[kind]
        for n, buf in opt.state[kind].items():
            _scaled_close(buf, ref[kind][n], TOL[None], f"{kind} {n}")


def test_factored_state_of_a_conv_kernel_converts():
    """`opt_state_from_jax` carries a conv kernel's row and col as JAX keeps
    them and swaps a linear kernel's. After one step from a zero state the
    moments are the gradient's mean squares (beta2 at t = 1 is 0)."""
    params = _params(vit=True)
    tx, _ = jbuild_optimizer(params, **_opt_kw("adafactor", None))
    grads = _grads(params, 0)
    _, state = tx.update(grads, tx.init(params), params)
    got = opt_state_from_jax(state)
    bb = grads["params"]["backbone"]
    conv = np.square(np.asarray(bb["patch_embed"]["kernel"])) + 1e-30  # (kh, kw, in, out)
    qkv = np.square(np.asarray(bb["blocks_0"]["attn"]["qkv"]["kernel"])) + 1e-30  # (in, out)
    for kind, want in (("row", conv.mean(-1)), ("col", conv.mean(-2))):
        np.testing.assert_allclose(got[kind][PATCH].numpy(), want, rtol=1e-5, err_msg=kind)
    name = "backbone.model.blocks.0.attn.qkv.weight"  # torch (out, in): row over in
    for kind, want in (("row", qkv.mean(0)), ("col", qkv.mean(1))):
        np.testing.assert_allclose(got[kind][name].numpy(), want, rtol=1e-5, err_msg=kind)


@pytest.mark.parametrize("name", ["adam", "adamw", "adafactor"])
def test_plateau_scaler_matches_avt_tpu(name):
    """reduce_lr_on_plateau: a constant LR whose per-group multiplier the
    host tracker halves on every metric that does not improve (patience 0),
    down to min_lr; adafactor carries no multiplier, as in JAX."""
    metrics = [1.0, 0.5, 0.6, 0.7, 0.4]
    kw = _opt_kw(name, None, "reduce_lr_on_plateau", min_lr=3e-3)
    opt, state, updates = _run(kw, plateau_metrics=metrics)
    for n, (got, want) in updates.items():
        _scaled_close(got, want, TOL[None], f"update {n}")
    ref = opt_state_from_jax(state)["plateau"]
    if name == "adafactor":
        assert ref == {} and all(g.plateau is None for g in opt.groups)
        return
    # 0.6 and 0.7 do not improve on 0.5: two halvings, then the floor (0.3)
    assert {g.label: g.plateau.mult for g in opt.groups} == pytest.approx(ref) == {
        "g0": 0.3, "g0_bn": 0.3}


def test_expts08_train_step_with_adam_matches_avt_tpu():
    """After one warm-up step on the JAX side (LR 0 under the warmup, the
    moments set), one step at the first warmup LR on both sides, from the
    same parameters and Adam state."""
    kw = dict(lr_wd=[["__all__", 5e-2, 1e-4]], optimizer_name="adam", scheduler_name="cosine",
              iters_per_epoch=2, num_epochs=15, warmup_epochs=5, bias_bn_wd_scale=1.0)
    jm = _jmodel()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_batch(0)["video"]), (B,))
    tx, _ = jbuild_optimizer(params, **kw)
    step = jmake_train_step(jm, tx, LOSS_WTS, {"action": N_CLS}, donate=False)
    key = jax.random.PRNGKey(1)
    state, _ = step(TrainState.create(params, tx), _jbatch(_batch(1)), key)
    new_state, jmetrics = step(state, _jbatch(_batch(2)), key)

    model = load_jax_params(_tmodel(), state.params)
    opt, _ = build_optimizer(model, **kw)
    opt.load_state_dict(opt_state_from_jax(state.opt_state))
    assert opt.count == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS})(_tbatch(_batch(2)))
    assert set(metrics) == set(jmetrics)
    for key_ in ("loss", "loss/cls_action", "loss/feat"):
        np.testing.assert_allclose(metrics[key_].item(), float(jmetrics[key_]), rtol=1e-5,
                                   err_msg=key_)
    jbefore, jafter = params_from_jax(state.params), params_from_jax(new_state.params)
    for name, p in model.named_parameters():
        update = p.detach() - before[name]
        assert update.abs().max() > 0, f"{name} did not move"
        _scaled_close(update, jafter[name] - jbefore[name], STEP_UPDATE_TOL, f"update {name}")
