"""The port's evaluation layer and meters against avt_tpu's.

* every function of evaluate/metrics.py on the same random logits, exact;
* the result sink: the same batches (two ranks, repeated idx, uids) through
  avt_tpu's `store_append_h5` + `read_results` and the port's numpy
  `store_append` + `read_results` give the same arrays;
* `evaluate` on the same weights (identity backbone + a 2-layer AVT-h, f32;
  the JAX weights go to the port through `params_from_jax`) and batches,
  with a ragged last batch padded by `_pad_rows`: the stored logits and
  losses at 2e-4, targets, idx and uids equal; the port's final accuracies
  equal avt_tpu's metric functions applied to the port's stored results;
* `SmoothedValue` and `MetricLogger` on one stream of values, exact.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avt_tpu.evaluate.metrics as jmetrics
import avt_tpu.train.meters as jmeters
from avt_tpu.evaluate import evaluate as jevaluate
from avt_tpu.evaluate import read_results as jread_results
from avt_tpu.evaluate.evaluator import _pad_rows as jpad_rows
from avt_tpu.evaluate.results import store_append_h5
from avt_tpu.losses import mse as jmse
from avt_tpu.models import (
    AVTh as JAVTh,
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityBackbone as JIdentityBackbone,
    LinearClassifier as JLinearClassifier,
)
from avt_tpu.train import make_eval_step as jmake_eval_step
import avt_tpu_torch.evaluate.metrics as tmetrics
import avt_tpu_torch.train.meters as tmeters
from avt_tpu_torch.evaluate import RESULTS_SAVE_DIR, evaluate, read_results, store_append
from avt_tpu_torch.evaluate.evaluator import _pad_rows
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, IdentityBackbone, LinearClassifier
from avt_tpu_torch.models.convert import load_jax_params
from avt_tpu_torch.train import make_eval_step

N_CLS, C, T = 12, 32, 10
AVTH = dict(inter_dim=64, n_layer=2, n_head=2)
TOL = 2e-4  # f32, the same math summed in another order


def _logits(seed, n=40, c=N_CLS):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, c)), rng.integers(0, c, size=n)


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn,args", [
    ("compute_topk", lambda: (*_logits(0), 5)),
    ("compute_topk", lambda: (*_logits(1), 1, [0, 3, 5])),
    ("topk_recall", lambda: (*_logits(2), 5)),
    ("topk_recall", lambda: (*_logits(3), 5, [1, 2, 99], True)),
    ("compute_conf_mat", lambda: (_logits(4)[0], np.where(_logits(4)[1] % 7 == 0, -1,
                                                           _logits(4)[1]))),
    ("mean_class_accuracy", lambda: (tmetrics.compute_conf_mat(*_logits(5)),)),
    ("compute_accuracy", lambda: _logits(6)),
    ("compute_accuracy", lambda: (*_logits(7), {"a": 1, "b": 4, "c": 11})),
    ("compute_accuracy", lambda: (np.zeros((0, N_CLS)), np.zeros(0))),
    ("softmax_np", lambda: (_logits(8)[0],)),
    ("combine_verb_noun_preds", lambda: (_logits(9, c=4)[0], _logits(10, c=5)[0])),
    ("final_accuracies_from_results", lambda: (
        {"logits/action": _logits(11)[0], "target/action": _logits(11)[1],
         "logits/verb": _logits(12, c=4)[0], "target/verb": _logits(12, c=4)[1],
         "uid": np.arange(40)}, {"action": {"x": 2, "y": 3}})),
])
def test_metrics_match_avt_tpu(fn, args):
    a = args()
    out, ref = getattr(tmetrics, fn)(*a), getattr(jmetrics, fn)(*a)
    if fn == "compute_accuracy" and a[0].size == 0:
        assert np.isnan(out).all() and np.isnan(ref).all()
        return
    _same(out, ref)


def _sink_batches():
    """(rank, batch) appends: two ranks, idx 3 and 5 predicted twice."""
    rng = np.random.default_rng(0)
    out = []
    for rank, idx in ((0, [0, 1, 2, 3]), (0, [4, 5]), (1, [6, 3, 7]), (1, [5])):
        n = len(idx)
        out.append((rank, {"logits/action": rng.standard_normal((n, N_CLS)).astype(np.float32),
                           "loss/cls_action": rng.random(n).astype(np.float32),
                           "aux_loss/feat": np.float32(rng.random())[None],
                           "target/action": rng.integers(0, N_CLS, size=n),
                           "idx": np.asarray(idx),
                           "uid": np.asarray([f"P01_{i:04d}" for i in idx]),
                           "epoch": np.asarray([1.5])}))
    return out


def test_result_sink_matches_avt_tpu(tmp_path):
    for rank, batch in _sink_batches():
        store_append_h5(batch, str(tmp_path / "h5"), rank=rank)
        store_append(batch, str(tmp_path / "npz"), rank=rank)
    assert sorted(p.name for p in (tmp_path / "npz" / "1").iterdir()) == [
        "000000.npz", "000001.npz"]
    ours, ref = read_results(str(tmp_path / "npz")), jread_results(str(tmp_path / "h5"))
    _same(ours, ref)
    assert ours["logits/action"].shape == (8, N_CLS)
    with np.load(tmp_path / "npz" / "1" / "000000.npz") as f:
        assert f["uid"].dtype == np.dtype("S64")  # as the H5 file stores them
    assert ours["uid"][3] == b"P01_0003"
    batches = dict(enumerate(b for _, b in _sink_batches()))
    two = np.stack([batches[0]["logits/action"][3], batches[2]["logits/action"][1]])
    np.testing.assert_array_equal(ours["logits/action"][3], two.mean(axis=0))  # the f32 mean


def test_result_sink_refuses_long_uids(tmp_path):
    with pytest.raises(ValueError, match="< 64 chars"):
        store_append({"idx": np.arange(1), "uid": np.asarray(["x" * 64])}, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        read_results(str(tmp_path / "none"))


class _Dataset:
    primary_metric = "final_acc/action/top1"
    classes_manyshot = {"action": {"m0": 0, "m1": 1, "m2": 2}}


class _EvalLoader:
    """11 clips in batches of 4, 4 and 3 (a ragged tail)."""

    dataset = _Dataset()

    def __init__(self):
        rng = np.random.default_rng(3)
        self.video = rng.standard_normal((11, T, C, 1, 1, 1)).astype(np.float32)
        self.target = rng.integers(0, N_CLS, size=11)
        self.tsub = rng.integers(-1, N_CLS, size=(11, T, 1))

    def __len__(self):
        return 3

    def __iter__(self):
        for lo in (0, 4, 8):
            sel = np.arange(lo, min(lo + 4, 11))
            yield {"video": self.video[sel], "target": {"action": self.target[sel]},
                   "target_subclips": {"action": self.tsub[sel]}, "idx": sel,
                   "uid": np.asarray([f"clip_{i}" for i in sel])}


def _jmodel():
    return JAVTModel(
        backbone=JIdentityBackbone(), temporal_aggregator=JIdentityAgg(in_features=C),
        future_predictor=JAVTh(in_features=C, output_len=1, avg_last_n=1, return_past_too=True,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none"),
                               **AVTH),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=C),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=C, classifier_on_past=True)


def _tmodel():
    return AVTModel(
        backbone=IdentityBackbone(), temporal_aggregator=IdentityAgg(in_features=C),
        future_predictor=AVTh(in_features=C, output_len=1, avg_last_n=1, return_past_too=True,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"), **AVTH),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=C),
        classifiers={"action": LinearClassifier(C, N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=C, classifier_on_past=True)


def test_evaluate_matches_avt_tpu(tmp_path):
    loader = _EvalLoader()
    jm = _jmodel()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(loader.video[:4]), (4,))
    jmetric = jevaluate(jmake_eval_step(jm, {"action": N_CLS}), params, {"": loader},
                        save_dir=str(tmp_path / "jax"), epoch=2.0, pad_multiple=2)
    model = load_jax_params(_tmodel(), params)
    metric = evaluate(make_eval_step(model, {"action": N_CLS}), {"": loader},
                      save_dir=str(tmp_path / "port"), epoch=2.0, pad_multiple=2, device="cpu")
    ours = read_results(str(tmp_path / "port" / RESULTS_SAVE_DIR))
    ref = jread_results(str(tmp_path / "jax" / RESULTS_SAVE_DIR))
    assert set(ours) == set(ref) == {"logits/action", "loss/cls_action", "aux_loss/feat",
                                     "target/action", "idx", "uid"}
    assert ours["logits/action"].shape == (11, N_CLS)
    for key in ("target/action", "idx", "uid"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    for key in ("logits/action", "loss/cls_action", "aux_loss/feat"):
        np.testing.assert_allclose(ours[key], ref[key], atol=TOL, rtol=TOL, err_msg=key)
    accs = jmetrics.final_accuracies_from_results(ours, _Dataset.classes_manyshot)
    assert metric == accs["final_acc/action/top1"]
    assert metric == pytest.approx(jmetric, abs=1e-9)
    # store=False keeps the online meters only: the top-1 meter comes back
    meter = evaluate(make_eval_step(model, {"action": N_CLS}), {"": loader},
                     save_dir=str(tmp_path / "port2"), store=False, device="cpu")
    assert 0.0 <= meter <= 100.0 and not (tmp_path / "port2").exists()


def test_pad_rows_wraps_when_batch_smaller_than_pad():
    batch = {"video": np.arange(6, dtype=np.float32).reshape(1, 2, 3), "uid": ["a"],
             "nested": {"x": np.ones((1, 5))}}
    out = _pad_rows(batch, 3)
    _same(out, jpad_rows(batch, 3))
    assert out["video"].shape[0] == 4 and out["uid"] == ["a"] * 4
    assert np.array_equal(out["video"][3], batch["video"][0])
    big = {"v": np.arange(6).reshape(3, 2)}
    _same(_pad_rows(big, 1), jpad_rows(big, 1))


class _Writer:
    def __init__(self):
        self.calls = []

    def add_scalar(self, *args):
        self.calls.append(args)


def test_meters_match_avt_tpu(caplog):
    values = np.random.default_rng(0).standard_normal(45).tolist()
    ours, ref = tmeters.SmoothedValue(window_size=8), jmeters.SmoothedValue(window_size=8)
    for i, v in enumerate(values):
        ours.update(v, n=1 + i % 3)
        ref.update(v, n=1 + i % 3)
        for attr in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
        assert str(ours) == str(ref)
    writers = _Writer(), _Writer()
    loggers = (tmeters.MetricLogger(writer=writers[0], stat_set="val"),
               jmeters.MetricLogger(writer=writers[1], stat_set="val"))
    for ml in loggers:
        for i, v in enumerate(values):
            ml.update(loss=v, **{"acc1/action": abs(v)})
            ml.update(n=4, **{"loss/feat": v * v})
            ml.write_scalar("train_per_iter/loss", v, i)
        ml.dump_to_tb(3)
        ml.synchronize_between_processes()
    assert str(loggers[0]) == str(loggers[1])
    assert writers[0].calls == writers[1].calls
    for k, m in loggers[1].meters.items():
        assert loggers[0][k].global_avg == m.global_avg, k
    # log_every: the same lines, but for the memory readout
    logger = logging.getLogger("test_torch_evaluate.meters")
    lines = []
    for ml in (tmeters.MetricLogger(logger=logger), jmeters.MetricLogger(logger=logger)):
        with caplog.at_level(logging.INFO, logger=logger.name):
            caplog.clear()
            assert list(ml.log_every(range(5), print_freq=2, header="H", total=5)) == [
                0, 1, 2, 3, 4]
            lines.append([r.getMessage().split(" mem ")[0] for r in caplog.records])
    assert len(lines[0]) == 4 and [s[:6] for s in lines[0]] == [s[:6] for s in lines[1]]
    assert tmeters.device_hbm_mb() is None  # no CUDA in this process
    assert tmeters.make_tb_writer("unused", rank=1) is None
