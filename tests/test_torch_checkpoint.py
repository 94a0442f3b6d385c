"""The port's checkpoints (`save_checkpoint`, `restore_checkpoint`,
`Optimizer.state_dict`): a round trip of the model, the optimizer's buffers
in their own types, its count and plateau multipliers, and the plateau
tracker's host state at a fractional epoch; the atomic write; the host
template cases of avt_tpu's restore_checkpoint; and a port checkpoint's
model read back by avt_tpu's torch importer into the JAX params it came from.
"""
import os

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
    IdentityBackbone as JIdentityBackbone,
    LinearClassifier as JLinearClassifier,
)
from avt_tpu.models.import_torch import avt_checkpoint_to_flax
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, IdentityBackbone, LinearClassifier
from avt_tpu_torch.models.convert import load_jax_params
from avt_tpu_torch.train import (
    BEST_NAME,
    CKPT_NAME,
    ReduceLROnPlateau,
    build_optimizer,
    restore_checkpoint,
    save_checkpoint,
)

C, N_CLS, B, T = 16, 5, 2, 6
AVTH = dict(inter_dim=32, n_layer=2, n_head=2)


def _tmodel(seed):
    torch.manual_seed(seed)
    return AVTModel(
        backbone=IdentityBackbone(), temporal_aggregator=IdentityAgg(in_features=C),
        future_predictor=AVTh(in_features=C, output_len=1, avg_last_n=1, return_past_too=True,
                              embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=C),
        classifiers={"action": LinearClassifier(C, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=C, classifier_on_past=True)


def _trained(seed, optimizer_name, momentum_dtype):
    """A model and its optimizer after 3 updates from random gradients, with
    the plateau multipliers lowered."""
    model = _tmodel(seed)
    kw = {} if momentum_dtype is None else {"momentum_dtype": momentum_dtype}
    opt, _ = build_optimizer(model, lr_wd=[["__all__", 0.05, 1e-3]],
                             optimizer_name=optimizer_name,
                             scheduler_name="reduce_lr_on_plateau", iters_per_epoch=4,
                             num_epochs=8, warmup_epochs=1, bias_bn_wd_scale=0.5,
                             optimizer_kwargs=kw, scheduler_kwargs={"min_lr": 1e-3})
    gen = torch.Generator().manual_seed(seed)
    plateau = ReduceLROnPlateau(mode="max", patience=0, factor=0.5)
    for metric in (1.0, 0.5, 0.25):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        plateau.step(opt, metric)
    return model, opt, plateau


def _buffers(opt):
    return {(kind, name): buf for kind, bufs in opt.state.items() for name, buf in bufs.items()}


@pytest.mark.parametrize("optimizer_name,momentum_dtype,kinds", [
    ("sgd", "bfloat16", {"momentum"}), ("adam", "bfloat16", {"mu", "nu"}),
    ("adamw", None, {"mu", "nu"})])
def test_round_trip(tmp_path, optimizer_name, momentum_dtype, kinds):
    model, opt, plateau = _trained(0, optimizer_name, momentum_dtype)
    assert set(opt.state) == kinds and opt.count == 3
    assert {g.plateau.mult for g in opt.groups} == {0.25}  # two halvings
    save_checkpoint(str(tmp_path), model, opt, 6.5, names=(CKPT_NAME, BEST_NAME),
                    host_state=plateau.state_dict())
    assert sorted(os.listdir(tmp_path)) == [CKPT_NAME, BEST_NAME]  # no .tmp left behind

    model2, opt2, plateau2 = _trained(1, optimizer_name, momentum_dtype)
    assert not torch.equal(next(model2.parameters()), next(model.parameters()))
    live = _buffers(opt2)
    epoch, host = restore_checkpoint(str(tmp_path), model2, opt2,
                                     host_template=plateau2.state_dict())
    plateau2.load_state_dict(host)
    assert epoch == 6.5 and opt2.count == 3
    assert plateau2.state_dict() == plateau.state_dict() == {
        "best": 1.0, "num_bad_epochs": 0, "cooldown_counter": 0}
    assert [g.plateau.mult for g in opt2.groups] == [g.plateau.mult for g in opt.groups]
    for (n, p), (n2, p2) in zip(model.named_parameters(), model2.named_parameters()):
        assert n == n2 and torch.equal(p, p2), n
    bufs, bufs2 = _buffers(opt), _buffers(opt2)
    assert set(bufs) == set(bufs2)
    for key, buf in bufs.items():
        assert bufs2[key].dtype == buf.dtype and torch.equal(bufs2[key], buf), key
    if momentum_dtype is not None:  # the bf16 first moment stays bf16 on disk
        ckpt = torch.load(tmp_path / CKPT_NAME, weights_only=True)
        first = "momentum" if optimizer_name == "sgd" else "mu"
        assert {v.dtype for v in ckpt["optimizer"][first].values()} == {torch.bfloat16}
    # the live buffers are copied into, not replaced
    assert all(bufs2[key] is buf for key, buf in live.items())


def test_host_template_cases(tmp_path):
    model, opt, plateau = _trained(0, "sgd", None)
    template = {"best": -1.0, "num_bad_epochs": 7, "cooldown_counter": 0}
    assert restore_checkpoint(str(tmp_path), model, opt) is None  # absent
    assert restore_checkpoint(str(tmp_path), model, opt, host_template=template) is None
    save_checkpoint(str(tmp_path / "bare"), model, opt, 2.0)
    # host state asked for but not saved: the template comes back
    assert restore_checkpoint(str(tmp_path / "bare"), model, opt,
                              host_template=template) == (2.0, template)
    save_checkpoint(str(tmp_path / "host"), model, opt, 3.25, host_state=plateau.state_dict())
    # saved but not asked for: dropped
    assert restore_checkpoint(str(tmp_path / "host"), model, opt) == 3.25
    # both present: restored
    assert restore_checkpoint(str(tmp_path / "host"), model, opt, host_template=template) == (
        3.25, plateau.state_dict())
    # an optimizer is optional (eval-only restore)
    assert restore_checkpoint(str(tmp_path / "host"), _tmodel(2), None, name=CKPT_NAME) == 3.25


def test_rank_other_than_zero_writes_nothing(tmp_path):
    model, opt, _ = _trained(0, "sgd", None)
    save_checkpoint(str(tmp_path / "r1"), model, opt, 1.0, rank=1)
    assert not os.path.exists(tmp_path / "r1")


def test_checkpoint_model_reads_back_into_the_jax_params(tmp_path):
    jm = JAVTModel(
        backbone=JIdentityBackbone(), temporal_aggregator=JIdentityAgg(in_features=C),
        future_predictor=JAVTh(in_features=C, output_len=1, avg_last_n=1, return_past_too=True,
                               embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=C),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=C, classifier_on_past=True)
    video = np.random.default_rng(0).standard_normal((B, T, C, 1, 1, 1)).astype(np.float32)
    jparams = jm.init(jax.random.PRNGKey(3), jnp.asarray(video), (B,))
    model = load_jax_params(_tmodel(0), jparams)
    opt, _ = build_optimizer(model, lr_wd=[["__all__", 0.1, 0.0]], iters_per_epoch=1,
                             num_epochs=1)
    save_checkpoint(str(tmp_path), model, opt, 1.0)
    sd = {k: v.numpy() for k, v in torch.load(tmp_path / CKPT_NAME,
                                               weights_only=True)["model"].items()}
    back = avt_checkpoint_to_flax(sd)
    flat_ref = jax.tree_util.tree_flatten_with_path(jparams["params"])[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))
