"""The port's training loop (`run_training`, `make_multi_step`) against
avt_tpu's, and against itself.

Both sides train the same small feature-path model (identity backbone, a
2-layer AVT-h 64 wide over 32-d features, 6 classes, f32, every dropout
rate 0 since JAX's and torch's random bits differ; the JAX weights go to
the port through `params_from_jax`) on the same numpy batches, 5 an epoch,
reshuffled per epoch from a seed, with nesterov SGD under warmup + cosine,
a save every half epoch, an eval every epoch and the best checkpoint kept.
Compared: the final parameters (2e-4 of each tensor's max |value|: f32, the
same math summed in another order, over 15 steps), the (names, epoch) of
every save_checkpoint call, the eval metric of each epoch (1e-4 relative),
and, with reduce_lr_on_plateau, the groups' LR multipliers. Then the port
against itself, bit for bit and with dropout on: chunks of 2 steps against
single steps, a crash plus an auto-resume and a SIGTERM preemption plus a
resume against the uninterrupted run; and the NaN abort.
"""
import functools
import os
import signal
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avt_tpu.train.loop as jloop
from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityBackbone as JIdentityBackbone,
    LinearClassifier as JLinearClassifier,
)
from avt_tpu.train import TrainState, build_optimizer as jbuild_optimizer
from avt_tpu.train import make_eval_step as jmake_eval_step, make_train_step as jmake_train_step
from avt_tpu.train.optim import ReduceLROnPlateau as JReduceLROnPlateau
from avt_tpu.train.step import make_multi_step as jmake_multi_step
import avt_tpu_torch.train.loop as tloop
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, IdentityBackbone, LinearClassifier
from avt_tpu_torch.models.convert import load_jax_params, opt_state_from_jax, params_from_jax
from avt_tpu_torch.train import (
    CKPT_NAME,
    Preempted,
    ReduceLROnPlateau,
    build_optimizer,
    make_eval_step,
    make_multi_step,
    make_train_step,
    run_training,
)
from avt_tpu_torch.utils.device import batch_to_device

N_CLS, C, B, T, BATCHES, EPOCHS = 6, 32, 4, 10, 5, 3
AVTH = dict(inter_dim=64, n_layer=2, n_head=2)
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
OPT = dict(lr_wd=[["__all__", 0.1, 1e-4]], optimizer_name="sgd", scheduler_name="cosine",
           iters_per_epoch=BATCHES, num_epochs=EPOCHS, warmup_epochs=1,
           optimizer_kwargs={"nesterov": True})
PLATEAU_OPT = dict(OPT, scheduler_name="reduce_lr_on_plateau",
                   scheduler_kwargs={"min_lr": 0.02})
RUN = dict(num_epochs=EPOCHS, save_freq=0.5, save_freq_min=None, eval_freq=1, store_best=True,
           print_freq=1)
TOL = {"param": 2e-4, "metric": 1e-4}


class _Loader:
    """BATCHES numpy batches an epoch from a fixed pool of B * BATCHES
    samples, reshuffled per epoch from a seed; `nan_at` puts NaN into the
    video of that global batch."""

    def __init__(self, nan_at=None):
        rng = np.random.default_rng(0)
        n = B * BATCHES
        self.video = rng.standard_normal((n, T, C, 1, 1, 1)).astype(np.float32)
        self.target = rng.integers(0, N_CLS, size=n)
        self.tsub = rng.integers(-1, N_CLS, size=(n, T, 1))
        self.epoch = 0
        self.nan_at = nan_at

    def __len__(self):
        return BATCHES

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        order = np.random.default_rng(100 + self.epoch).permutation(B * BATCHES)
        for i in range(BATCHES):
            sel = order[i * B:(i + 1) * B]
            video = self.video[sel]
            if self.nan_at == self.epoch * BATCHES + i:
                video = np.full_like(video, np.nan)
            yield {"video": video, "target": {"action": self.target[sel]},
                   "target_subclips": {"action": self.tsub[sel]}, "idx": sel,
                   "uid": np.array([f"clip{j}" for j in sel])}


class _Interrupting:
    """Loader proxy that, once, before yielding the `at`-th batch (counted
    across epochs), raises a simulated crash or sends this process SIGTERM."""

    def __init__(self, inner, at, how):
        self.inner, self.at, self.how = inner, at, how
        self.count = 0
        self.armed = True

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for batch in self.inner:
            if self.armed and self.count == self.at:
                self.armed = False
                if self.how == "crash":
                    raise RuntimeError("simulated crash")
                os.kill(os.getpid(), signal.SIGTERM)
            self.count += 1
            yield batch


def _eval_batch():
    rng = np.random.default_rng(7)
    return {"video": rng.standard_normal((8, T, C, 1, 1, 1)).astype(np.float32),
            "target": {"action": rng.integers(0, N_CLS, size=8)},
            "target_subclips": {"action": rng.integers(-1, N_CLS, size=(8, T, 1))}}


def _jmodel():
    return JAVTModel(
        backbone=JIdentityBackbone(), temporal_aggregator=JIdentityAgg(in_features=C),
        future_predictor=JAVTh(in_features=C, output_len=1, avg_last_n=1, return_past_too=True,
                               embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=C),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=C, dropout=0.0, classifier_on_past=True)


def _tmodel(pdrop=0.0):
    return AVTModel(
        backbone=IdentityBackbone(), temporal_aggregator=IdentityAgg(in_features=C),
        future_predictor=AVTh(in_features=C, output_len=1, avg_last_n=1, return_past_too=True,
                              embd_pdrop=pdrop, attn_pdrop=pdrop, resid_pdrop=pdrop,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=C),
        classifiers={"action": LinearClassifier(C, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=C, dropout=pdrop, classifier_on_past=True)


@functools.lru_cache(maxsize=None)
def _jparams():
    video = jnp.asarray(_eval_batch()["video"][:B])
    return jax.jit(_jmodel().init)(jax.random.PRNGKey(0), video, (B,))


@functools.lru_cache(maxsize=None)
def _jax_run(K, plateau):
    """avt_tpu's run_training: (final state, save calls, eval metrics)."""
    jm, params = _jmodel(), _jparams()
    tx, _ = jbuild_optimizer(params, **(PLATEAU_OPT if plateau else OPT))
    step = jmake_train_step(jm, tx, LOSS_WTS, {"action": N_CLS}, donate=False)
    multi = None
    if K > 1:
        multi = jmake_multi_step(
            jmake_train_step(jm, tx, LOSS_WTS, {"action": N_CLS}, jit_compile=False), K)
    jeval = jmake_eval_step(jm, {"action": N_CLS})
    eb = jax.tree.map(jnp.asarray, _eval_batch())
    saves, metrics = [], []

    def eval_fn(state, epoch):
        metrics.append(float(jnp.mean(jeval(state.params, eb)["loss/cls_action"])))
        return metrics[-1]

    def record(ckpt_dir, state, epoch, *, names=(CKPT_NAME,), **_):
        saves.append((tuple(names), float(epoch)))

    with mock.patch.object(jloop, "save_checkpoint", record):
        state = jloop.run_training(
            # a copy: the multi-step donates its state
            train_step=step, state=TrainState.create(jax.tree.map(jnp.copy, params), tx),
            train_loader=_Loader(),
            eval_fn=eval_fn, multi_step=multi, unroll_steps=K,
            plateau=JReduceLROnPlateau(patience=0) if plateau else None,
            ckpt_dir="/nonexistent/avt_ckpt", **RUN)
    return state, saves, metrics


def _port_run(ckpt_dir, K=1, plateau=False, pdrop=0.0, loader=None, **kw):
    """The port's run_training: (model, optimizer, save calls, eval metrics,
    plateau tracker)."""
    model = load_jax_params(_tmodel(pdrop), _jparams())
    opt, _ = build_optimizer(model, **(PLATEAU_OPT if plateau else OPT))
    step = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS})
    teval = make_eval_step(model, {"action": N_CLS})
    eb = {"video": torch.from_numpy(_eval_batch()["video"]),
          "target": {"action": torch.from_numpy(_eval_batch()["target"]["action"])},
          "target_subclips": {"action": torch.from_numpy(
              _eval_batch()["target_subclips"]["action"])}}
    saves, metrics = [], []
    tplat = ReduceLROnPlateau(patience=0) if plateau else None

    def eval_fn(epoch):
        metrics.append(teval(eb)["loss/cls_action"].mean().item())
        return metrics[-1]

    def record(ckpt_dir, model, optimizer, epoch, *, names=(CKPT_NAME,), **rest):
        saves.append((tuple(names), float(epoch)))
        return save(ckpt_dir, model, optimizer, epoch, names=names, **rest)

    save = tloop.save_checkpoint
    with mock.patch.object(tloop, "save_checkpoint", record):
        run_training(train_step=step, model=model, optimizer=opt,
                     train_loader=loader or _Loader(), eval_fn=eval_fn,
                     multi_step=make_multi_step(step, K) if K > 1 else None, unroll_steps=K,
                     plateau=tplat, ckpt_dir=str(ckpt_dir), **dict(RUN, **kw))
    return model, opt, saves, metrics, tplat


def _scaled_close(out, ref, tol, what):
    out, ref = out.detach().numpy(), np.asarray(ref)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, f"{what}: max |diff| {err:.3g} of its scale (limit {tol})"


@pytest.mark.parametrize("K", [1, 2])
def test_run_training_matches_avt_tpu(K, tmp_path):
    state, jsaves, jmetrics = _jax_run(K, False)
    model, opt, saves, metrics, _ = _port_run(tmp_path, K)
    assert opt.count == int(state.step) == EPOCHS * BATCHES
    assert saves == jsaves
    # a save every 2 steps (K=2: at the chunk that crosses), each epoch's
    # end, and the best after every eval
    assert ((CKPT_NAME,), 0.0) in saves and ((CKPT_NAME,), 3.0) in saves
    np.testing.assert_allclose(metrics, jmetrics, rtol=TOL["metric"])
    ref = params_from_jax(state.params)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        _scaled_close(p, ref[name], TOL["param"], name)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint", "checkpoint_best"]


def test_run_training_plateau_matches_avt_tpu(tmp_path):
    state, jsaves, jmetrics = _jax_run(1, True)
    model, opt, saves, metrics, tplat = _port_run(tmp_path, plateau=True)
    assert saves == jsaves
    np.testing.assert_allclose(metrics, jmetrics, rtol=TOL["metric"])
    mults = {g.label: g.plateau.mult for g in opt.groups}
    assert mults == pytest.approx(opt_state_from_jax(state.opt_state)["plateau"])
    assert min(mults.values()) < 1.0  # the plateau did reduce the LR
    ref = params_from_jax(state.params)
    for name, p in model.named_parameters():
        _scaled_close(p, ref[name], TOL["param"], name)


def _assert_same_run(a, b):
    (ma, oa), (mb, ob) = a[:2], b[:2]
    assert oa.count == ob.count == EPOCHS * BATCHES
    for (na, pa), (nb, pb) in zip(ma.named_parameters(), mb.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    for kind, bufs in oa.state.items():
        for name, buf in bufs.items():
            assert torch.equal(buf, ob.state[kind][name]), (kind, name)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted single-step port run with dropout 0.1."""
    return _port_run(tmp_path_factory.mktemp("straight"), pdrop=0.1)


def test_chunks_of_two_steps_equal_single_steps(straight, tmp_path):
    _assert_same_run(straight, _port_run(tmp_path, K=2, pdrop=0.1))


def test_crash_and_resume_equals_uninterrupted_run(straight, tmp_path):
    crashing = _Interrupting(_Loader(), at=7, how="crash")
    with pytest.raises(RuntimeError, match="simulated crash"):
        _port_run(tmp_path, pdrop=0.1, loader=crashing)
    assert torch.load(tmp_path / "checkpoint", weights_only=True)["epoch"] == pytest.approx(1.2)
    # a fresh model and optimizer restore the rolling checkpoint (epoch 1.2,
    # after 6 steps) and fast-forward the loader; step 6 is a save boundary,
    # so the resumed run saves there first
    resumed = _port_run(tmp_path, pdrop=0.1, loader=crashing)
    assert resumed[2][:2] == [((CKPT_NAME,), 1.2), ((CKPT_NAME,), 1.6)]
    _assert_same_run(straight, resumed)


def test_sigterm_preempts_and_resume_equals_uninterrupted_run(straight, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    signaling = _Interrupting(_Loader(), at=7, how="sigterm")
    with pytest.raises(Preempted) as info:
        _port_run(tmp_path, pdrop=0.1, loader=signaling, graceful_signals=(signal.SIGTERM,))
    assert info.value.epoch == pytest.approx(1.4)  # the boundary before global batch 7
    assert signal.getsignal(signal.SIGTERM) is before
    assert torch.load(tmp_path / "checkpoint", weights_only=True)["epoch"] == pytest.approx(1.4)
    resumed = _port_run(tmp_path, pdrop=0.1, loader=signaling,
                        graceful_signals=(signal.SIGTERM,))
    _assert_same_run(straight, resumed)


@pytest.mark.parametrize("K", [1, 2])
def test_nan_loss_aborts(K, tmp_path):
    with pytest.raises(ValueError, match="The loss is NaN!"):
        _port_run(tmp_path, K=K, loader=_Loader(nan_at=3))


def test_multi_step_stacks_metrics_on_the_device():
    model = load_jax_params(_tmodel(0.1), _jparams())
    opt, _ = build_optimizer(model, **OPT)
    multi = make_multi_step(make_train_step(model, opt, LOSS_WTS, {"action": N_CLS}), 3)
    loader = iter(_Loader())
    batches = [batch_to_device(tloop._jit_batch(next(loader)), "cpu") for _ in range(3)]
    metrics = multi(batches, 0, 42)
    assert opt.count == 3
    assert set(metrics) == {"loss", "loss/cls_action", "loss/past_cls_action", "loss/feat",
                            "acc1/action", "acc5/action"}
    assert all(v.shape == (3,) and v.dtype == torch.float32 for v in metrics.values())
    with pytest.raises(ValueError, match="2 batches for a 3-step call"):
        multi(batches[:2], 3, 42)
