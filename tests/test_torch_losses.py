"""The port's losses and train-time metrics (avt_tpu_torch/losses,
avt_tpu_torch/train/ops.py, avt_tpu_torch/utils/metrics.py) against avt_tpu's
on the same inputs, made with numpy from a seed."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avt_tpu.losses import xent as jxent
from avt_tpu.train import ops as jops
from avt_tpu.utils import metrics as jmetrics
from avt_tpu_torch import losses as tlosses
from avt_tpu_torch.train import ops as tops
from avt_tpu_torch.utils import metrics as tmetrics

jmse = importlib.import_module("avt_tpu.losses.mse")  # the package re-exports a function of that name

C = 7


def _logits_targets(shape, seed, ignore_share=0.3):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape + (C,))).astype(np.float32)
    tgt = rng.integers(0, C, size=shape)
    tgt[rng.random(shape) < ignore_share] = -1
    return logits, tgt


def _close(out, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(12,), (3, 5)])
def test_multidim_cross_entropy_matches_jax(shape, weighted, reduction):
    logits, tgt = _logits_targets(shape, seed=len(shape) + 2 * weighted)
    w = np.random.default_rng(9).uniform(0.5, 2.0, C).astype(np.float32) if weighted else None
    ref = jxent.multidim_cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                       weight=None if w is None else jnp.asarray(w),
                                       reduction=reduction)
    out = tlosses.multidim_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt),
                                         weight=None if w is None else torch.from_numpy(w),
                                         reduction=reduction)
    assert tuple(out.shape) == ref.shape
    _close(out, ref)
    mod = tlosses.MultiDimCrossEntropy(
        weight=None if w is None else torch.from_numpy(w), reduction=reduction)
    _close(mod(torch.from_numpy(logits), torch.from_numpy(tgt)), ref)


def test_cross_entropy_all_ignored_and_bad_shapes():
    logits = torch.randn(4, C)
    tgt = torch.full((4,), -1)
    assert tlosses.multidim_cross_entropy(logits, tgt, reduction="mean").item() == 0.0
    assert float(jxent.multidim_cross_entropy(jnp.asarray(logits.numpy()), jnp.asarray(tgt.numpy()),
                                              reduction="mean")) == 0.0
    logits.requires_grad_(True)
    tlosses.multidim_cross_entropy(logits, tgt, reduction="mean").backward()
    assert torch.equal(logits.grad, torch.zeros_like(logits))  # no nan in the gradient
    with pytest.raises(ValueError, match="one more dim"):
        tlosses.multidim_cross_entropy(logits, tgt[None])
    with pytest.raises(ValueError, match="leading dims"):
        tlosses.multidim_cross_entropy(logits, tgt[:3])


def test_mode_over_frames_ties_and_minus_one():
    labels = torch.tensor([[3, 1, 1, 3],      # tie 1 vs 3: the smaller
                           [-1, -1, 2, 0],    # -1 is the most frequent
                           [5, 4, 6, 2],      # all once: the smallest
                           [-1, 2, -1, 2]])   # tie -1 vs 2: -1
    out = tops.mode_over_frames(labels, C)
    assert out.tolist() == [1, -1, 2, -1]
    assert torch.equal(out, torch.mode(labels, dim=-1).values)
    rnd = torch.from_numpy(np.random.default_rng(0).integers(-1, C, size=(6, 5, 9)))
    ref = jops.mode_over_frames(jnp.asarray(rnd.numpy()), C)
    np.testing.assert_array_equal(tops.mode_over_frames(rnd, C).numpy(), np.asarray(ref))
    assert torch.equal(tops.mode_over_frames(rnd, C), torch.mode(rnd, dim=-1).values)


def test_balance_weights_match_jax():
    counts = {0: 10, 2: 5, 3: 1, -1: 100}
    _close(tops.balance_weights_from_counts(counts, 5),
           jops.balance_weights_from_counts(counts, 5), rtol=1e-6)


@pytest.mark.parametrize("topk", [(1,), (1, 5), (2, 3)])
def test_topk_accuracy_matches_jax(topk):
    logits, tgt = _logits_targets((4, 6), seed=4)
    ref = jmetrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(tgt), topk=topk)
    out = tmetrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(tgt), topk=topk)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and o.item() == pytest.approx(float(r), abs=1e-4)
    none = tmetrics.topk_accuracy(torch.from_numpy(logits), torch.full((4, 6), -1), topk=topk)
    assert all(x.item() == 0.0 for x in none)


@pytest.mark.parametrize("with_past", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_basic_loss_accuracy_matches_jax(with_past, weighted):
    rng = np.random.default_rng(5)
    B, clips = 6, 4
    logits, tgt = _logits_targets((B,), seed=6, ignore_share=0.0)
    outputs = {"logits/action": logits}
    tsub = None
    if with_past:
        outputs["past_logits/action"] = rng.standard_normal((B, clips, C)).astype(np.float32)
        tsub = {"action": rng.integers(-1, C, size=(B, clips, 3))}
    cw = {"action": rng.uniform(0.5, 2, C).astype(np.float32)} if weighted else None
    jl, ja = jops.basic_loss_accuracy(
        {k: jnp.asarray(v) for k, v in outputs.items()}, {"action": jnp.asarray(tgt)},
        None if tsub is None else {k: jnp.asarray(v) for k, v in tsub.items()},
        num_classes={"action": C},
        class_weights=None if cw is None else {k: jnp.asarray(v) for k, v in cw.items()})
    tl, ta = tops.basic_loss_accuracy(
        {k: torch.from_numpy(v) for k, v in outputs.items()}, {"action": torch.from_numpy(tgt)},
        None if tsub is None else {k: torch.from_numpy(v) for k, v in tsub.items()},
        num_classes={"action": C},
        class_weights=None if cw is None else {k: torch.from_numpy(v) for k, v in cw.items()})
    assert set(tl) == set(jl) and set(ta) == set(ja)
    assert ("past_cls_action" in tl) == with_past
    for k in jl:
        _close(tl[k], jl[k])
    for k in ja:
        assert ta[k].item() == pytest.approx(float(ja[k]), abs=1e-4)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_mse_variants_match_jax(reduction):
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((3, 4, 16)).astype(np.float32) for _ in range(2))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _close(tlosses.mse(ta, tb, reduction), jmse.mse(ja, jb, reduction))
    _close(tlosses.normed_mse(ta, tb, reduction), jmse.normed_mse(ja, jb, reduction))
    _close(tlosses.MSELoss(reduction)(ta, tb), jmse.MSELoss(reduction)(ja, jb))
    _close(tlosses.NormedMSE(reduction)(ta, tb), jmse.NormedMSE(reduction)(ja, jb))
    _close(tlosses.l2_normalize(ta), jmse.l2_normalize(ja))
    zero = torch.zeros(2, 16)
    assert torch.equal(tlosses.l2_normalize(zero), zero)  # eps keeps it finite
