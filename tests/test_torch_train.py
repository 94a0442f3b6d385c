"""The port's train step (avt_tpu_torch/train) against avt_tpu's
`make_train_step` on the CPU, on a small AVT-b + AVT-h model (ViT img 32,
depth 2, 2 heads of 64; AVT-h 2 layers) with every dropout rate 0 (JAX's and
torch's random bits differ): the same weights (`params_from_jax`) and
momentum (`opt_state_from_jax`), nesterov SGD with a bf16 momentum buffer
under warmup + cosine. Compared after one and three steps: the total and
per-key losses, the gradients, the parameter updates and the momentum.
Also the port's train-mode dropout on its own."""
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
from avt_tpu.train import TrainState, basic_loss_accuracy as jbasic_loss_accuracy
from avt_tpu.train import build_optimizer as jbuild_optimizer, make_train_step as jmake_train_step
from avt_tpu.train.step import weighted_loss_sum as jweighted_loss_sum
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, LinearClassifier, ViT
from avt_tpu_torch.models.convert import load_jax_params, opt_state_from_jax, params_from_jax
from avt_tpu_torch.models.layers import dropout
from avt_tpu_torch.train import build_optimizer, make_train_step, weighted_loss_sum

DIM, N_CLS, B, CLIPS = 128, 10, 2, 4
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
OPT = dict(lr_wd=[["__all__", 0.1, 1e-4]], optimizer_name="sgd", scheduler_name="cosine",
           iters_per_epoch=4, num_epochs=3, warmup_epochs=1,
           optimizer_kwargs={"nesterov": True, "momentum_dtype": "bfloat16"})
# Relative to each tensor's max |JAX value|. f32: the same math in another
# summation order (as test_torch_models). bf16 ViT: activations rounded to
# bf16 at slightly different places on the two sides (see test_torch_models).
TOL = {"float32": {"loss": 1e-5, "grad": 2e-4, "update": 2e-4},
       "bfloat16": {"loss": 1e-2, "grad": 5e-2, "update": 5e-2}}
# The momentum buffer is bf16: once the parameters differ in their last
# bits (after the first step), an element of the trace can round to the
# neighbouring bf16 value on one side, a 2^-8 step that the next updates
# carry (momentum * (1 + momentum) * lr of it). So from the second step on,
# the momentum and the updates agree to two bf16 ulps of their scale.
BF16_TRACE_TOL = 2 ** -7


def _jmodel(dtype):
    return JAVTModel(
        backbone=JViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2,
                      dtype=dtype),
        temporal_aggregator=JIdentityAgg(in_features=DIM),
        future_predictor=JAVTh(in_features=DIM, inter_dim=64, n_layer=2, n_head=2, output_len=1,
                               avg_last_n=1, return_past_too=True, embd_pdrop=0.0,
                               attn_pdrop=0.0, resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               dtype=dtype),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=DIM),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True)


def _tmodel(dtype):
    return AVTModel(
        backbone=ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2, dtype=dtype),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, inter_dim=64, n_layer=2, n_head=2, output_len=1,
                              avg_last_n=1, return_past_too=True, embd_pdrop=0.0,
                              attn_pdrop=0.0, resid_pdrop=0.0,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"),
                              dtype=dtype),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=DIM),
        classifiers={"action": LinearClassifier(DIM, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, dropout=0.0,
        classifier_on_past=True)


def _batches(n, seed=0):
    """Flagship-shaped batches: 1-frame clips, #clips = frames (bench.py)."""
    rng = np.random.default_rng(seed)
    return [dict(video=rng.standard_normal((B, CLIPS, 3, 1, 32, 32)).astype(np.float32),
                 target=rng.integers(0, N_CLS, size=B),
                 tsub=rng.integers(-1, N_CLS, size=(B, CLIPS, 1)))
            for _ in range(n)]


def _jbatch(b):
    return {"video": jnp.asarray(b["video"]), "target": {"action": jnp.asarray(b["target"])},
            "target_subclips": {"action": jnp.asarray(b["tsub"])}}


def _tbatch(b):
    return {"video": torch.from_numpy(b["video"]),
            "target": {"action": torch.from_numpy(b["target"])},
            "target_subclips": {"action": torch.from_numpy(b["tsub"])}}


def _jgrads(jm, params, batch):
    jb = _jbatch(batch)

    def loss_fn(p):
        outputs, aux = jm.apply(p, jb["video"], (B,), train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)})
        tsub = {k: v.reshape(v.shape[0], v.shape[1], -1) for k, v in jb["target_subclips"].items()}
        losses, _ = jbasic_loss_accuracy(outputs, jb["target"], tsub,
                                         num_classes={"action": N_CLS})
        losses.update(aux)
        return jweighted_loss_sum(losses, LOSS_WTS)[0]

    return jax.jit(jax.grad(loss_fn))(params)


@pytest.fixture(scope="module")
def jax_runs():
    """Per dtype: the state after one warm-up step (momentum nonzero, count
    1), then three more steps, with the metrics, gradients and state of
    each."""
    runs = {}
    batches = _batches(4)
    for name in ("float32", "bfloat16"):
        jdt = None if name == "float32" else jnp.bfloat16
        jm = _jmodel(jdt)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batches[0]["video"]), (B,))
        tx, _ = jbuild_optimizer(params, **OPT)
        state = TrainState.create(params, tx)
        key = jax.random.PRNGKey(1)
        # compiled with every bf16 product rounded, as the step runs op by
        # op: XLA's fusion would otherwise keep optax's momentum * trace
        # (a bf16 array) in f32
        step = jax.jit(jmake_train_step(jm, tx, LOSS_WTS, {"action": N_CLS}, jit_compile=False)
                       ).lower(state, _jbatch(batches[0]), key).compile(
                           {"xla_allow_excess_precision": False})
        state, _ = step(state, _jbatch(batches[0]), key)
        states, metrics, grads = [state], [], []
        for b in batches[1:]:
            grads.append(_jgrads(jm, state.params, b))
            state, m = step(state, _jbatch(b), key)
            states.append(state)
            metrics.append(m)
        runs[name] = dict(batches=batches[1:], states=states, metrics=metrics, grads=grads)
    return runs


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scaled_close(out, ref, tol, what):
    ref, out = _f32(ref), _f32(out)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(out - ref).max() / scale
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_avt_tpu(jax_runs, dtype, n_steps):
    run, tol = jax_runs[dtype], TOL[dtype]
    model = load_jax_params(_tmodel(getattr(torch, dtype) if dtype != "float32" else None),
                            run["states"][0].params)
    opt, _ = build_optimizer(model, **OPT)
    opt.load_state_dict(opt_state_from_jax(run["states"][0].opt_state))
    step = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS})
    for k in range(n_steps):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = step(_tbatch(run["batches"][k]))
        jm = run["metrics"][k]
        assert set(metrics) == set(jm)
        for key in ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat"):
            np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=tol["loss"],
                                       err_msg=key)
        for key in ("acc1/action", "acc5/action"):
            assert metrics[key].item() == pytest.approx(float(jm[key]), abs=1e-4)
    # the last step: gradients, updates and momentum, by parameter name
    jgrads = params_from_jax(run["grads"][n_steps - 1])
    jbefore = params_from_jax(run["states"][n_steps - 1].params)
    jafter = params_from_jax(run["states"][n_steps].params)
    jmom = opt_state_from_jax(run["states"][n_steps].opt_state)["momentum"]
    assert opt.count == n_steps + 1
    update_tol = tol["update"] if n_steps == 1 else max(tol["update"], BF16_TRACE_TOL)
    for name, p in model.named_parameters():
        _scaled_close(p.grad, jgrads[name], tol["grad"], f"grad {name}")
        _scaled_close(p.detach() - before[name], jafter[name] - jbefore[name], update_tol,
                      f"update {name}")
        assert opt.momentum_buffers[name].dtype == torch.bfloat16
        # the trace sums gradients, so it can be no closer than they are
        _scaled_close(opt.momentum_buffers[name], jmom[name], max(tol["grad"], BF16_TRACE_TOL),
                      f"momentum {name}")


def test_weighted_loss_sum_leaves_zero_weights_out():
    a = torch.tensor([1.0, 3.0], requires_grad=True)
    b = torch.tensor([5.0], requires_grad=True)
    total, means = weighted_loss_sum({"a": a, "b": b}, {"a": 2.0, "b": 0.0})
    assert total.item() == 4.0 and means["b"].item() == 5.0
    total.backward()
    assert b.grad is None and torch.equal(a.grad, torch.tensor([1.0, 1.0]))
    with pytest.raises(KeyError, match="no weight"):
        weighted_loss_sum({"c": a}, {"a": 1.0})


def test_dropout_share_scale_and_determinism():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(3)
    y = dropout(x, 0.2, gen, training=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1.25))
    again = dropout(x, 0.2, torch.Generator().manual_seed(3), training=True)
    assert torch.equal(y, again)
    assert torch.equal(dropout(x, 0.2, gen, training=False), x)
    xb = torch.ones(1000, dtype=torch.bfloat16)
    assert dropout(xb, 0.5, gen, training=True).dtype == torch.bfloat16


def test_model_dropout_only_in_train_mode():
    model = _tmodel(None)
    model.dropout = 0.5
    video = torch.randn(2, CLIPS, 3, 1, 32, 32)
    with torch.no_grad():
        model.eval()
        e1, _ = model(video, (2,))
        e2, _ = model(video, (2,))
        model.train()
        t1, _ = model(video, (2,), generator=torch.Generator().manual_seed(0))
        t2, _ = model(video, (2,), generator=torch.Generator().manual_seed(0))
        t3, _ = model(video, (2,), generator=torch.Generator().manual_seed(1))
    assert torch.equal(e1["logits/action"], e2["logits/action"])
    assert torch.equal(t1["logits/action"], t2["logits/action"])
    assert not torch.equal(t1["logits/action"], t3["logits/action"])
    assert not torch.equal(t1["logits/action"], e1["logits/action"])
