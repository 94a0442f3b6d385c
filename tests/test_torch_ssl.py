"""The SSL op against avt_tpu on the CPU, in f32 at 2e-4: `mil_cross_entropy`
(sum and max, and the max form's mean whatever the reduction),
`simclr_infonce` with one and with K positives, with and without the
target -> output term, and the MultiDim form, against avt_tpu.losses.infonce
on the same seeded embeddings; `make_ssl_train_step` in both loss styles and
every combine (and the cumulative futures) on a BatchNorm-free AVTModel
(identity backbone, mean aggregator, the NCE projection), one step's losses
and parameters against avt_tpu's `make_ssl_train_step` from the same weights
(carried by `params_from_jax`) under the same SGD; then the SSL run of
tests/test_train_net.py through the port's `main`, on chip_smoke.py's
synthetic tree of 16-d features, to a finite metric."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avt_tpu.losses import infonce as jinfonce
from avt_tpu.models import (
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityBackbone as JIdentityBackbone,
    IdentityFuture as JIdentityFuture,
    LinearClassifier as JLinearClassifier,
    MeanAgg as JMeanAgg,
)
from avt_tpu.train import TrainState
from avt_tpu.train.optim import build_optimizer as jbuild_optimizer
from avt_tpu.train.step import make_ssl_train_step as jmake_ssl_train_step
from avt_tpu_torch import train_net
from avt_tpu_torch.config import Composer, parse_override
from avt_tpu_torch.losses import (
    MultiDimSimclrInfoNCE,
    SimclrInfoNCE,
    mil_cross_entropy,
    simclr_infonce,
)
from avt_tpu_torch.models import (
    AVTModel,
    IdentityAgg,
    IdentityBackbone,
    IdentityFuture,
    LinearClassifier,
    MeanAgg,
)
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.train import build_optimizer, make_ssl_train_step

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = 2e-4
B, C, T, N_CLS, NCE = 6, 16, 5, 7, 12


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=TOL, rtol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("mil_type", ["sum", "max"])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_mil_cross_entropy_matches_avt_tpu(mil_type, reduction):
    pred = _rand((B, 2 * B), 0) * 3
    labels = np.zeros((B, 2 * B), np.float32)
    labels[np.arange(B), np.arange(B)] = 1
    labels[np.arange(B), (np.arange(B) + 3) % (2 * B)] = 1  # two positives a row
    out = mil_cross_entropy(torch.from_numpy(pred), torch.from_numpy(labels), mil_type,
                            reduction)
    ref = jinfonce.mil_cross_entropy(jnp.asarray(pred), jnp.asarray(labels), mil_type,
                                     reduction)
    assert out.shape == ref.shape == (() if mil_type == "max" or reduction == "mean" else (B,))
    _close(out, ref)


@pytest.mark.parametrize("k,t2o,mil_type", [(1, True, "sum"), (3, True, "sum"),
                                            (1, False, "max"), (3, False, "max")])
def test_simclr_infonce_matches_avt_tpu(k, t2o, mil_type):
    """One positive (B, C) or K = 3 (B, 3, C); the reverse term or not.
    The loss and its gradients by both embeddings."""
    out_np = _rand((B, C), 1)
    tgt_np = _rand((B, C) if k == 1 else (B, k, C), 2)
    kw = dict(temperature=0.1, target_to_output_loss=t2o, mil_type=mil_type)
    out, tgt = (torch.from_numpy(x).requires_grad_() for x in (out_np, tgt_np))
    loss = simclr_infonce(out, tgt, **kw)
    loss.backward()
    ref, grads = jax.value_and_grad(lambda o, t: jinfonce.simclr_infonce(o, t, **kw),
                                    argnums=(0, 1))(jnp.asarray(out_np), jnp.asarray(tgt_np))
    _close(loss, ref, "loss")
    _close(out.grad, grads[0], "d output")
    _close(tgt.grad, grads[1], "d target")


def test_multidim_and_config_classes_match_avt_tpu():
    out, tgt = _rand((3, T, C), 3), _rand((3, T, C), 4)
    for ours, theirs in ((MultiDimSimclrInfoNCE(temperature=0.2), jinfonce.MultiDimSimclrInfoNCE(
            temperature=0.2)), (SimclrInfoNCE(mil_type="max"), jinfonce.SimclrInfoNCE(
                mil_type="max"))):
        o, t = (out, tgt) if isinstance(ours, MultiDimSimclrInfoNCE) else (out[:, 0], tgt)
        _close(ours(torch.from_numpy(o), torch.from_numpy(t)), theirs(jnp.asarray(o),
                                                                       jnp.asarray(t)))


def _models():
    """A BatchNorm-free AVTModel in both packages over C-d features: mean
    aggregator, identity future, NCE projection to 12, a linear classifier."""
    jm = JAVTModel(backbone=JIdentityBackbone(), temporal_aggregator=JMeanAgg(in_features=C),
                   future_predictor=JIdentityFuture(in_features=C),
                   temporal_aggregator_after_future_pred=JIdentityAgg(in_features=C),
                   classifiers={"action": JLinearClassifier(out_features=N_CLS)},
                   num_classes=(("action", N_CLS),), backbone_dim=C, project_dim_for_nce=NCE)
    tm = AVTModel(backbone=IdentityBackbone(), temporal_aggregator=MeanAgg(C),
                  future_predictor=IdentityFuture(C),
                  temporal_aggregator_after_future_pred=IdentityAgg(C),
                  classifiers={"action": LinearClassifier(C, N_CLS, device="cpu")},
                  num_classes=(("action", N_CLS),), backbone_dim=C, project_dim_for_nce=NCE)
    return jm, tm


@pytest.mark.parametrize("style,combine,cumulative", [
    ("separately", "min", False), ("separately", "max", False), ("separately", "mean", False),
    ("separately", "sum", True), ("together", "min", False)])
def test_ssl_step_matches_avt_tpu(style, combine, cumulative):
    """One step on 6 observed clips and 2 future clips each: the cls loss on
    the observed rows, 'reg' by the InfoNCE (the MultiDim form separately,
    K = 2 positives together), SGD with momentum."""
    jm, tm = _models()
    nfut = 2
    batch = {"video": _rand((B, 1, C, T, 1, 1), 5),
             "target": {"action": np.array([0, 3, 6, 1, 2, 5], np.int32)}}
    for i in range(nfut):
        batch[f"future_{i}_video"] = _rand((B, 1, C, T, 1, 1), 6 + i)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batch["video"]))
    load_jax_params(tm, params)
    crit = dict(temperature=0.1, target_to_output_loss=True, mil_type="sum")
    jcrit, tcrit = ((jinfonce.MultiDimSimclrInfoNCE(**crit), MultiDimSimclrInfoNCE(**crit))
                    if style == "separately" else
                    (jinfonce.SimclrInfoNCE(**crit), SimclrInfoNCE(**crit)))
    loss_wts = {"cls_action": 1.0, "reg": 1.0}
    kw = dict(lr_wd=[["__all__", 0.1, 1e-3]], optimizer_name="sgd", scheduler_name="constant",
              iters_per_epoch=1, num_epochs=1, optimizer_kwargs={"momentum": 0.9})
    step_kw = dict(nfutures=nfut, incur_loss_style=style, combine_future_losses=combine,
                   cumulative_future=cumulative)
    tx, _ = jbuild_optimizer(params, **kw)
    jstep = jmake_ssl_train_step(jm, tx, loss_wts, {"action": N_CLS}, jcrit, donate=False,
                                 **step_kw)
    state, ref = jstep(TrainState.create(params, tx), jax.tree.map(jnp.asarray, batch),
                       jax.random.PRNGKey(1))
    opt, _ = build_optimizer(tm, **kw)
    step = make_ssl_train_step(tm, opt, loss_wts, {"action": N_CLS}, tcrit, **step_kw)
    metrics = step({k: ({kk: torch.from_numpy(vv).long() for kk, vv in v.items()}
                        if isinstance(v, dict) else torch.from_numpy(v))
                    for k, v in batch.items()})
    assert set(metrics) == set(ref)
    for key in ("loss", "loss/reg", "loss/cls_action"):
        _close(metrics[key], ref[key], key)
    want = params_from_jax(state.params)
    for name, p in tm.named_parameters():
        _close(p, want[name], name)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """chip_smoke.py's synthetic EK100 tree of 16-d features, actions from
    12 s on (10 observed seconds fit before each)."""
    root = tmp_path_factory.mktemp("ek100_ssl")
    return chip_smoke.write_ek100_tree(str(root), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=12, dim=C, seed=5)


def test_ssl_run_through_main(tree, tmp_path):
    """tests/test_train_net.py's SSL run (pred_future_feat with the InfoNCE,
    identity backbone, mean aggregator, the NCE projection, 10 features at
    1 fps, future clips) through the port's `main`: 2 epochs of batch 2,
    unrolled in steps of 2, to a finite metric."""
    overrides = [
        "train_eval_op=pred_future_feat", "train_eval_op/reg_criterion=simclr_infonce",
        "train.batch_size=2", "eval.batch_size=2", "train.num_epochs=2", "train.eval_freq=2",
        "train.unroll_steps=2", "train.train_one_epoch_fn.loss_wts.feat=0.0",
        "train.train_one_epoch_fn.save_freq_min=null", "model/backbone=identity",
        f"model.backbone_dim={C}", "model/temporal_aggregator=mean",
        f"model.project_dim_for_nce={C}", "data_train.num_frames=10", "data_train.frame_rate=1",
        "data_eval.num_frames=10", "data_eval.frame_rate=1",
        "dataset_train.sample_strategy=last_clip", "dataset_eval.sample_strategy=last_clip",
        "+dataset_train.return_future_clips_too=true",
        "dataset_train.conv_to_anticipate_fn.tau_a=1",
        "dataset_train.conv_to_anticipate_fn.tau_o=10",
        "dataset_eval.conv_to_anticipate_fn.tau_a=1",
        "dataset_eval.conv_to_anticipate_fn.tau_o=10", "data_train.workers=2",
        "data_eval.workers=2"]
    cfg = Composer(train_net.CONF_DIR).compose(
        "config", [parse_override(o) for o in tree + overrides])
    assert cfg["train_eval_op"]["name"] == "pred_future_feat"
    metric = train_net.main(cfg, str(tmp_path / "run_ssl"), device="cpu")
    assert np.isfinite(metric) and 0.0 <= metric <= 100.0
