"""The slice as a whole: expts/02 from its experiment file, through the
port's config, data and model build functions and `train_net`, against avt_tpu's.

The tree is chip_smoke.py's synthetic EK100 one (RULSTM csv annotations,
97 verbs, 300 nouns, 3806 actions, per-video .npy features), here 32-d,
and the overrides are the ones the card's run uses (annotation paths, the
npy reader), plus a small width: AVT-h of 2 layers, 128 wide, 2 heads of
64, batches of 4, every dropout rate 0 (JAX's and torch's random bits
differ). Compared at 10 observed features (the shipped context, plain
attention on both sides) and at 128 (the flash path: the Pallas kernels in
interpret mode, the port's plain flash versions): the composed configs,
the first loader batch, the eval step's logits and losses on avt_tpu's
weights (carried by `params_from_jax`), two train steps' losses and the
eval logits after them, at 2e-4 (f32, the same math summed in another
order). Then `train_net.cli` end to end under AVT_PLATFORM=cpu: it trains,
checkpoints, evaluates, resumes without retraining, runs test_only, takes
the raw-video branch (expts/01 on raw videos through the native decoder,
its backbone from a timm file), runs conf/config.yaml's conv backbone on
raw video with no experiment file and the SSL op on expts/02, exits 143
when preempted, and refuses what is not ported and the CPU unasked.
"""
import functools
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avt_tpu.models.layers as jlayers
from avt_tpu.config import Composer as JComposer
from avt_tpu.config import parse_override as jparse_override
from avt_tpu.config import parse_overrides_file as jparse_overrides_file
from avt_tpu.config.build import build_all_datasets as jbuild_all_datasets
from avt_tpu.config.build import build_model as jbuild_model
from avt_tpu.config.build import build_optimizer_from_cfg as jbuild_optimizer_from_cfg
from avt_tpu.config.build import build_preprocess_fns as jbuild_preprocess_fns
from avt_tpu.data.loader import DataLoader as JDataLoader
from avt_tpu.train import TrainState
from avt_tpu.train import make_eval_step as jmake_eval_step
from avt_tpu.train import make_train_step as jmake_train_step
import avt_tpu_torch.models.layers as tlayers
from avt_tpu_torch import train_net
from avt_tpu_torch.config import Composer, parse_override, parse_overrides_file, resolve_target
from avt_tpu_torch.config.build import (
    build_all_datasets,
    build_model,
    build_optimizer_from_cfg,
    build_preprocess_fns,
    loss_weights,
)
from avt_tpu_torch.data.loader import DataLoader
from avt_tpu_torch.evaluate import RESULTS_SAVE_DIR, read_results
from avt_tpu_torch.models.convert import load_jax_params
from avt_tpu_torch.ops import flash_attention as tfa
from avt_tpu_torch.train import CKPT_NAME, Preempted, make_eval_step, make_train_step
from avt_tpu_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

EXPT = str(ROOT / chip_smoke.EXPT_02)
DIM, B = 32, 4
SMALL = [f"model.backbone_dim={DIM}", "model.future_predictor.n_layer=2",
         "model.future_predictor.inter_dim=128", "model.future_predictor.n_head=2",
         f"train.batch_size={B}", f"eval.batch_size={B}", "data_train.workers=2",
         "data_eval.workers=2"]
NO_DROPOUT = ["model.dropout=0.0", "+model.future_predictor.embd_pdrop=0.0",
              "+model.future_predictor.attn_pdrop=0.0", "+model.future_predictor.resid_pdrop=0.0"]
TOL = 2e-4
LOSSES = ("loss", "loss/cls_action", "loss/past_cls_action", "loss/feat")


def _long(T):
    return [f"data_train.num_frames={T}", f"data_eval.num_frames={T}",
            f"dataset_train.conv_to_anticipate_fn.tau_o={T}",
            f"dataset_eval.conv_to_anticipate_fn.tau_o={T}"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic EK100 tree; actions from 130 s on, so that 128 observed
    seconds fit in the video. Returns its overrides."""
    root = tmp_path_factory.mktemp("ek100")
    return chip_smoke.write_ek100_tree(str(root), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=130, dim=DIM, seed=3)


def _compose(overrides):
    cfg = Composer(train_net.CONF_DIR).compose(
        "config", parse_overrides_file(EXPT) + [parse_override(o) for o in overrides])
    jcfg = JComposer(train_net.CONF_DIR).compose(
        "config", jparse_overrides_file(EXPT) + [jparse_override(o) for o in overrides])
    assert cfg == jcfg
    return cfg, jcfg


@pytest.fixture
def flash_path(monkeypatch):
    """Both sides' AVT-h attention on the flash path: the Pallas kernels in
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
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(out, ref, what):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= TOL, f"{what}: max |diff| {err:.3g} of its scale (limit {TOL})"


def _to_torch(batch):
    return {k: ({kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items() if k in ("video", "target", "target_subclips")}


def _to_jax(batch):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else jnp.asarray(v))
            for k, v in batch.items() if k in ("video", "target", "target_subclips")}


@pytest.mark.parametrize("T", [10, 128])
def test_expts02_steps_match_avt_tpu(tree, T, request):
    calls = request.getfixturevalue("flash_path") if T >= 128 else None
    cfg, jcfg = _compose(tree + SMALL + NO_DROPOUT + (_long(T) if T != 10 else []))
    train, evals = build_all_datasets(cfg)
    jtrain, jevals = jbuild_all_datasets(jcfg)
    keys = ["video", "target", "target_subclips", "idx", "uid"]
    batch = next(iter(DataLoader(train[0], B, seed=cfg["seed"], num_workers=2, keys=keys)))
    jbatch = next(iter(JDataLoader(jtrain[0], B, seed=cfg["seed"], num_workers=2, keys=keys)))
    for k in ("video", "idx", "uid"):
        assert np.array_equal(batch[k], jbatch[k]), k
    assert batch["video"].shape == (B, T, DIM, 1, 1, 1)
    num_classes = {k: len(v) for k, v in train[0].classes.items()}
    assert num_classes == {"action": chip_smoke.NUM_ACTIONS}

    jm = jbuild_model(jcfg, num_classes, jtrain[0].class_mappings)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(jbatch["video"]), (B,))
    tx, _ = jbuild_optimizer_from_cfg(jcfg, params, iters_per_epoch=2)
    jstep = jmake_train_step(jm, tx, loss_weights(cfg), num_classes, donate=False)
    jeval = jmake_eval_step(jm, num_classes)
    model = build_model(cfg, num_classes, train[0].class_mappings, device="cpu")
    load_jax_params(model, params)
    opt, _ = build_optimizer_from_cfg(cfg, model, iters_per_epoch=2)
    step = make_train_step(model, opt, loss_weights(cfg), num_classes)
    eval_step = make_eval_step(model, num_classes)

    tb, jb = _to_torch(batch), _to_jax(jbatch)
    res, ref = eval_step(tb), jeval(params, jb)
    for key in ("logits/action", "loss/cls_action", "aux_loss/feat"):
        _close(res[key], ref[key], f"eval {key}")
    state = TrainState.create(params, tx)
    key = jax.random.PRNGKey(1)
    for i in range(2):
        state, jmetrics = jstep(state, jb, key)
        metrics = step(tb)
        for k in LOSSES:
            _close(metrics[k], jmetrics[k], f"train step {i} {k}")
    assert opt.count == 2
    _close(eval_step(tb)["logits/action"], jeval(state.params, jb)["logits/action"],
           "eval logits after two steps")
    if calls is not None:  # 2 layers: an eval, two steps, an eval
        assert calls.call_count == 2 * 4


ZOO_SMALL = [f"model.backbone_dim={DIM}", f"train.batch_size={B}", f"eval.batch_size={B}",
             "data_train.workers=2", "data_eval.workers=2",
             "+model.temporal_aggregator.inter_rep=128", "+model.temporal_aggregator.nheads=2",
             "+model.temporal_aggregator.nlayers=1", "+model.temporal_aggregator.ffn_dim=64",
             "+model.temporal_aggregator.dropout=0.0"]


def test_zoo_transformer_steps_match_avt_tpu(tree, flash_path, monkeypatch):
    """chip_smoke.py's zoo_transformer override list (expts/02's kept lines,
    no subclips, the Transformer aggregator, the MLP future predictor and
    classifier) at 128 features and a small width (1 layer of 2 heads of
    64): an eval step, a train step and the eval after it against avt_tpu,
    the encoder attention on the flash path in both (non-causal). The
    aggregator's fixed 0.1 dropout is the identity on both sides."""
    from flax import linen as nn

    import avt_tpu_torch.models.temporal_agg as ttagg

    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(ttagg, "dropout", lambda x, *a, **k: x)
    cfg, jcfg = _compose_lines(chip_smoke.zoo_transformer_overrides(tree, T=128) + ZOO_SMALL)
    assert cfg["model"]["temporal_aggregator"]["_target_"] == "avt_tpu.models.TransformerAgg"
    data = cfg["data_train"]
    assert not data["subclips"]["num_frames"] and data["num_frames"] == 128
    train, _ = build_all_datasets(cfg)
    jtrain, _ = jbuild_all_datasets(jcfg)
    keys = ["video", "target", "target_subclips", "idx", "uid"]
    batch = next(iter(DataLoader(train[0], B, seed=cfg["seed"], num_workers=2, keys=keys)))
    jbatch = next(iter(JDataLoader(jtrain[0], B, seed=cfg["seed"], num_workers=2, keys=keys)))
    assert np.array_equal(batch["video"], jbatch["video"])
    assert batch["video"].shape == (B, 1, DIM, 128, 1, 1)  # one clip of 128 features
    num_classes = {"action": chip_smoke.NUM_ACTIONS}
    jm = jbuild_model(jcfg, num_classes, jtrain[0].class_mappings)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(jbatch["video"]), (B,))
    tx, _ = jbuild_optimizer_from_cfg(jcfg, params, iters_per_epoch=2)
    jstep = jmake_train_step(jm, tx, loss_weights(cfg), num_classes, donate=False)
    jeval = jmake_eval_step(jm, num_classes)
    model = build_model(cfg, num_classes, train[0].class_mappings, device="cpu")
    load_jax_params(model, params)
    opt, _ = build_optimizer_from_cfg(cfg, model, iters_per_epoch=2)
    step = make_train_step(model, opt, loss_weights(cfg), num_classes)
    eval_step = make_eval_step(model, num_classes)
    tb, jb = _to_torch(batch), _to_jax(jbatch)
    res, ref = eval_step(tb), jeval(params, jb)
    for key in ("logits/action", "loss/cls_action"):
        _close(res[key], ref[key], f"eval {key}")
    state, jmetrics = jstep(TrainState.create(params, tx), jb, jax.random.PRNGKey(1))
    metrics = step(tb)
    assert set(jmetrics) <= set(metrics) and "loss/cls_action" in metrics
    for k in ("loss", "loss/cls_action"):
        _close(metrics[k], jmetrics[k], f"train step {k}")
    _close(eval_step(tb)["logits/action"], jeval(state.params, jb)["logits/action"],
           "eval logits after the step")
    assert flash_path.call_count == 3  # 1 layer: an eval, a step, an eval


def _cli_args(tree, run_dir, *extra):
    return (["--config-file", EXPT, "--run-dir", str(run_dir)] + tree + SMALL
            + ["train.num_epochs=2", "train.unroll_steps=2"] + list(extra))


def test_cli_trains_checkpoints_evaluates_and_resumes(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    epochs = []
    finals = []
    real_epoch = tloop.train_one_epoch

    def counted_epoch(*args, **kwargs):
        epochs.append(kwargs["epoch"])
        return real_epoch(*args, **kwargs)

    from avt_tpu_torch.evaluate import evaluator

    real_final = evaluator.final_accuracies_from_results

    def recorded_final(*args, **kwargs):
        finals.append(real_final(*args, **kwargs))
        return finals[-1]

    run = tmp_path / "run"
    with mock.patch.object(tloop, "train_one_epoch", counted_epoch), \
            mock.patch.object(evaluator, "final_accuracies_from_results", recorded_final):
        (metric,) = train_net.cli(_cli_args(tree, run))
        assert epochs == [0, 1] and len(finals) == 2  # an eval after each epoch, none after
        assert np.isfinite(metric) and metric == finals[-1]["final_acc/action/AR5"]
        assert (run / CKPT_NAME).exists() and not (run / "run.pid").exists()
        stored = read_results(str(run / RESULTS_SAVE_DIR))
        assert stored["logits/action"].shape == (4, chip_smoke.NUM_ACTIONS)
        assert np.isfinite(stored["logits/action"]).all()
        ckpt = torch.load(run / CKPT_NAME, weights_only=False)
        assert ckpt["epoch"] == 2.0

        (again,) = train_net.cli(_cli_args(tree, run))  # resumes: no epoch left to train
        assert epochs == [0, 1] and len(finals) == 3
        assert again == pytest.approx(metric)

        (tested,) = train_net.cli(_cli_args(tree, tmp_path / "test_only", "test_only=true"))
        assert epochs == [0, 1] and len(finals) == 4 and np.isfinite(tested)
        assert not (tmp_path / "test_only" / CKPT_NAME).exists()


def test_cli_balances_classes_and_steps_the_plateau(tree, tmp_path, monkeypatch):
    """balance_classes' inverse-frequency weights and reduce_lr_on_plateau's
    tracker are wired in: one epoch trains, evaluates and steps the
    plateau on the metric."""
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    stepped = []
    real_step = train_net.ReduceLROnPlateau.step

    def recorded(self, optimizer, metric):
        stepped.append(metric)
        return real_step(self, optimizer, metric)

    with mock.patch.object(train_net.ReduceLROnPlateau, "step", recorded):
        (metric,) = train_net.cli(_cli_args(
            tree, tmp_path / "balanced", "train.num_epochs=1",
            "train_eval_op.cls_loss_acc_fn.balance_classes=true",
            "opt/scheduler=reduce_lr_on_plateau"))
    assert stepped == [metric] and np.isfinite(metric)


RAW = ["model.backbone_dim=32", "+model.backbone.embed_dim=32",
       "+model.backbone.depth=1", "+model.backbone.num_heads=2", "+model.backbone.img_size=32",
       "model.future_predictor.n_layer=1", "model.future_predictor.inter_dim=64",
       "model.future_predictor.n_head=2", "data_train.num_frames=4", "data_train.scale_h=36-40",
       "data_train.crop_size=32", "data_eval.scale_h=36", "data_eval.crop_size=32",
       "train.batch_size=3", "eval.batch_size=3", "train.num_epochs=1",
       "data_train.workers=2", "data_eval.workers=2"]


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """The synthetic EK100 tree with raw videos (64x48 at 10 fps, actions
    from 12 s on) in place of the feature store; returns its overrides."""
    root = tmp_path_factory.mktemp("ek100_raw")
    return chip_smoke.write_ek100_tree(str(root), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=12, seed=3,
                                       video=(64, 48, 10))


def test_cli_raw_video_branch_preprocesses_on_the_device(raw_tree, tmp_path, monkeypatch):
    """expts/01 (ViT backbone on uint8 frames) at a tiny width on raw
    videos read by the file's DefaultReader (the native decoder), its
    backbone loaded from a timm file at the path the file names under
    ${cwd}: the raw-video branch builds the preprocess functions, whose
    eval path equals avt_tpu's, and trains and evaluates."""
    from avt_tpu_torch.data.video_decoder import LibavVideoReader

    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    timm = chip_smoke.write_timm_vit(str(tmp_path / chip_smoke.TIMM_IN21K), embed_dim=32,
                                     depth=1, img_size=32, num_classes=10, seed=4)
    expt = str(ROOT / "expts" / "01_ek100_avt.txt")
    cfg = Composer(train_net.CONF_DIR).compose(
        "config", parse_overrides_file(expt) + [parse_override(o) for o in raw_tree + RAW])
    jcfg = JComposer(train_net.CONF_DIR).compose(
        "config", jparse_overrides_file(expt) + [jparse_override(o) for o in raw_tree + RAW])
    video = Path(cfg["dataset"]["epic_kitchens100"]["common"]["data_dir_extension"])
    reader = resolve_target("datasets.reader_fns.DefaultReader")()
    assert type(reader) is LibavVideoReader
    frames = reader(video / "P01" / "P01_01.MP4", 1.0, 1.3, 10.0, None)[0][None]
    assert frames.shape == (1, 4, 48, 64, 3)
    _, eval_pp = build_preprocess_fns(cfg, "cpu")
    _, jeval_pp = jbuild_preprocess_fns(jcfg)
    out, ref = eval_pp(torch.from_numpy(frames)), jeval_pp(jnp.asarray(frames))
    assert out.shape == ref.shape == (1, 4, 6, 3, 1, 32, 32)  # 3 crops + flips
    np.testing.assert_allclose(_f32(out), np.asarray(ref), atol=1e-5)
    readers, inits = [], []
    real_build, real_init = train_net.build_all_datasets, train_net.init_from_model

    def built(c):
        train, evals = real_build(c)
        readers.extend(type(d.reader) for d in train + list(evals.values()))
        return train, evals

    def init(model, specs):
        inits.append(real_init(model, specs))
        sd = model.state_dict()
        assert all(torch.equal(sd["backbone.model." + k], timm[k]) for k in timm
                   if not k.startswith(("head.", "pre_logits.")))
        return inits[-1]

    with mock.patch.object(train_net, "build_preprocess_fns",
                           wraps=train_net.build_preprocess_fns) as pp, \
            mock.patch.object(train_net, "build_all_datasets", built), \
            mock.patch.object(train_net, "init_from_model", init):
        (metric,) = train_net.cli(["--config-file", expt, "--run-dir", str(tmp_path / "raw")]
                                  + raw_tree + RAW)
    assert pp.call_count == 1 and np.isfinite(metric)
    assert readers == [LibavVideoReader, LibavVideoReader]
    assert len(inits) == 1 and len(inits[0]) == len(timm) - 4  # not head nor pre_logits
    stored = read_results(str(tmp_path / "raw" / RESULTS_SAVE_DIR))
    assert stored["logits/action"].shape == (4, chip_smoke.NUM_ACTIONS)


def test_cli_exits_143_when_preempted(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    with mock.patch.object(train_net, "main", side_effect=Preempted(0.5)):
        with pytest.raises(SystemExit) as exc:
            train_net.cli(_cli_args(tree, tmp_path / "p"))
    assert exc.value.code == 143 and not (tmp_path / "p" / "run.pid").exists()


def test_main_refuses_the_cpu_unasked(tree, tmp_path, monkeypatch):
    cfg, _ = _compose(tree + SMALL)
    monkeypatch.delenv("AVT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_net.main(cfg, str(tmp_path))
    monkeypatch.setenv("AVT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="AVT_PLATFORM"):
        train_net.main(cfg, str(tmp_path))
    assert train_net.platform_device("cpu") == torch.device("cpu")


# conf/config.yaml as shipped on the raw-video tree, at a small input: 4
# frames, 32x32 crops of 48x36 frames, batches of 2, one epoch
CONV_DEFAULT = ["data_train.num_frames=4", "data_eval.num_frames=4", "data_train.scale_h=36",
                "data_train.scale_w=48", "data_eval.scale_h=36", "data_eval.scale_w=48",
                "data_train.crop_size=32", "data_eval.crop_size=32", "train.batch_size=2",
                "eval.batch_size=2", "train.num_epochs=1", "data_train.workers=2",
                "data_eval.workers=2"]
# the SSL op on expts/02: the InfoNCE, a 32-d projection, future clips, no
# subclips (the reference's step slices the clip batch, which subclips
# multiply) and so no past classifier (it classifies subclips)
SSL_EXPT02 = ["train_eval_op/reg_criterion=simclr_infonce", "model.project_dim_for_nce=32",
              "+dataset_train.return_future_clips_too=true", "data_train.subclips.num_frames=null",
              "data_train.subclips.stride=null", "data_eval.subclips.num_frames=null",
              "data_eval.subclips.stride=null", "model.classifier_on_past=false",
              "train.num_epochs=1"]


@pytest.mark.parametrize("overrides,item", [
    (["train_eval_op=pred_future_feat"], "1.8"),
    (["model/backbone=r2plus1d_34"], "1.6"),
    (["model/backbone=bn_inception"], "1.6"),
    (["+model.future_predictor.output_len_eval=3"], "1.5"),
    (["+model.future_predictor.rollout_mode=cache"], "1.5"),
    (["+dataset_train._precomputed_metadata_file=/x.pkl"], "1.3"),
])
def test_unported_options_raise_naming_their_roadmap_item(tree, tmp_path, monkeypatch, request,
                                                          overrides, item):
    """What is still to port (item 1.3) raises naming its ROADMAP item.
    What was ported since trains an epoch and evaluates through the driver
    to a finite metric: AVT-h's rollout options (item 1.5: a rollout of 2
    steps in training, with the file's dropout); the conv backbones (item
    1.6) through `cli` with no experiment file, conf/config.yaml's
    r2plus1d_34 (or BN-Inception, built with N=0) on raw video; the SSL op
    (item 1.8) on expts/02 with future clips and the InfoNCE."""
    if item == "1.5":
        cfg, _ = _compose(tree + SMALL + overrides + ["model.future_predictor.output_len=2",
                                                      "train.num_epochs=1"])
        assert np.isfinite(train_net.main(cfg, str(tmp_path), device="cpu"))
        return
    if item == "1.6":
        monkeypatch.setenv("AVT_PLATFORM", "cpu")
        extra = (["model.backbone_last_n_modules_to_drop=0"] if "bn_inception" in overrides[0]
                 else [])
        (metric,) = train_net.cli(["--run-dir", str(tmp_path / "conv")]
                                  + request.getfixturevalue("raw_tree") + CONV_DEFAULT
                                  + overrides + extra)
        assert np.isfinite(metric)
        return
    if item == "1.8":
        cfg, _ = _compose(tree + SMALL + overrides + SSL_EXPT02)
        assert np.isfinite(train_net.main(cfg, str(tmp_path), device="cpu"))
        return
    cfg, _ = _compose(tree + SMALL + overrides)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue {item}"):
        train_net.main(cfg, str(tmp_path), device="cpu")


def _compose_lines(overrides):
    cfg = Composer(train_net.CONF_DIR).compose("config", [parse_override(o) for o in overrides])
    jcfg = JComposer(train_net.CONF_DIR).compose("config",
                                                 [jparse_override(o) for o in overrides])
    assert cfg == jcfg
    return cfg, jcfg


SMALL_FEAT = [f"model.backbone_dim={DIM}", f"train.batch_size={B}", f"eval.batch_size={B}",
              "data_train.workers=2", "data_eval.workers=2", "test_only=true"]


@pytest.mark.parametrize("overrides", [
    ["model/temporal_aggregator=mean", "model/future_predictor=mlp", "model/classifier=mlp"],
    ["model.intermediate_featdim=64", "model.add_regression_head=true"],
    ["model/temporal_aggregator=rulstm", "+model.temporal_aggregator.intermediate_featdim=16",
     "train.init_from_model=[[temporal_aggregator,{rulstm}],"
     "[classifiers.action,classifier.1.,{rulstm}]]"],
], ids=["mean_mlp_heads", "mapper_regression", "rulstm_checkpoint"])
def test_zoo_options_evaluate_through_main(tree, tmp_path, overrides):
    """Options that raised until the rest of the heads were ported build
    and evaluate through `main` (test_only) on expts/02's kept data lines,
    a RULSTM checkpoint through expts/05's spec form among them."""
    path = tmp_path / "rulstm.pth.tar"
    chip_smoke.write_rulstm(str(path), feat_dim=DIM, hidden=16, seed=0)
    overrides = [o.format(rulstm=path) for o in overrides]
    cfg, _ = _compose_lines(chip_smoke.expt02_kept_overrides() + tree + SMALL_FEAT + overrides)
    metric = train_net.main(cfg, str(tmp_path / "run"), device="cpu")
    assert np.isfinite(metric)


def test_expt05_cli_evaluates_a_rulstm_file_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's rulstm_expt05 run at a small width on the CPU:
    expts/05 from its file, exact_rulstm reads, the seeded RULSTM file
    through the file's two-entry spec form; the LSTMs load bit for bit."""
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    tree = chip_smoke.write_ek100_tree(str(tmp_path / "tree"), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=4, dim=DIM, seed=5,
                                       read_type="exact_rulstm")
    path = str(tmp_path / "rulstm.pth.tar")
    sd = chip_smoke.write_rulstm(path, feat_dim=DIM, hidden=16, seed=6)
    loaded = {}
    real_init = train_net.init_from_model

    def recorded_init(model, specs):
        out = real_init(model, specs)
        loaded.update(model.state_dict())
        return out

    argv = ["--config-file", str(ROOT / chip_smoke.EXPT_05), "--run-dir", str(tmp_path / "run"),
            f"model.backbone_dim={DIM}", "+model.temporal_aggregator.intermediate_featdim=16",
            f"train.batch_size={B}", f"eval.batch_size={B}", "data_train.workers=2",
            "data_eval.workers=2",
            f"train.init_from_model=[[temporal_aggregator,{path}],"
            f"[classifiers.action,classifier.1.,{path}]]"] + tree
    with mock.patch.object(train_net, "init_from_model", recorded_init):
        (metric,) = train_net.cli(argv)
    assert np.isfinite(metric)
    for k, v in sd.items():
        name = ("classifiers.action." + k.split(".")[-1] if k.startswith("classifier.")
                else "temporal_aggregator." + k.replace(".lstm.", "."))
        assert torch.equal(loaded[name], v), name


def test_main_refuses_a_process_group(tree, tmp_path, monkeypatch):
    cfg, _ = _compose(tree + SMALL)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1.9"):
        train_net.main(cfg, str(tmp_path), device="cpu")


def test_module_runs_as_a_script_and_refuses_the_cpu_unasked(tmp_path):
    """`python -m avt_tpu_torch.train_net` parses its arguments; run with no
    GPU and no AVT_PLATFORM, it raises rather than taking the CPU."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k not in ("AVT_PLATFORM", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, "-m", "avt_tpu_torch.train_net"]
    res = subprocess.run(cmd + ["--help"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0 and "--config-file" in res.stdout
    res = subprocess.run(cmd + ["--config-file", EXPT, "--run-dir", str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0 and "device='cpu'" in res.stderr
    assert not (tmp_path / "run.pid").exists()
