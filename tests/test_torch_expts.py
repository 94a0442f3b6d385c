"""Every experiment file that runs on the port from its file, against avt_tpu.

The synthetic DATA/ tree of tests/_expt_fixtures.py (EK100 pkl
annotations with a label-less test split, EK55 with its video splits,
EGTEA's RULSTM csvs and 50Salads' activity files; fake-lmdb feature stores
at the channel counts the files configure; cv2-written raw videos read by
each package's native decoder) stands in for the data, with timm ViT files
at the names the files load (a block more than the model has, and the
in21k classifier head, which neither package loads). Each file is composed
by both packages with the working directory at the tree (`${cwd}/DATA`),
at a small width (a ViT of 1 block, 32 wide, on 32x32 crops; AVT-h of 1
layer, 64 wide, 2 heads; batches of 2; every dropout rate 0, as JAX's and
torch's random bits differ). Then the port's `build_all_datasets`,
`DataLoader`, `build_model`, `init_from_model` (the file's own spec: the
timm file, or a run checkpoint written here for the `_testonly` files),
`build_optimizer_from_cfg`, one train step (raw frames preprocessed by
avt_tpu's train_fn, as the two packages' augmentation draws differ), and
then one eval step on the first batch of every eval dataset (raw frames
through each package's eval preprocessing), are held against avt_tpu's,
from avt_tpu's weights, at 2e-4 (f32); the loaded weights exactly.
expts/05 (RULSTM) runs at a 64-wide RULSTM with its own two-entry spec
onto a seeded file in the original RULSTM layout (chip_smoke.py's
`write_rulstm`); its LSTM biases load as the file holds them and are
compared folded into one, as avt_tpu's cell holds them. expts/06 as
shipped is refused by both packages. expts/02 with the options that once
raised naming their ROADMAP item: AVT-h's rollout options match avt_tpu's
eval, the conv backbones build with avt_tpu's names and shapes, and the SSL
op's step matches avt_tpu's.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avt_tpu.data.readers as jreaders
from avt_tpu.config import Composer as JComposer
from avt_tpu.config import expand_sweeps as jexpand_sweeps
from avt_tpu.config import parse_override as jparse_override
from avt_tpu.config import parse_overrides_file as jparse_overrides_file
from avt_tpu.config.build import build_all_datasets as jbuild_all_datasets
from avt_tpu.config.build import build_model as jbuild_model
from avt_tpu.config.build import build_optimizer_from_cfg as jbuild_optimizer_from_cfg
from avt_tpu.config.build import build_preprocess_fns as jbuild_preprocess_fns
from avt_tpu.data.dataset import ConcatDataset as JConcatDataset
from avt_tpu.data.loader import DataLoader as JDataLoader
from avt_tpu.models.import_torch import init_from_model as jinit_from_model
from avt_tpu.train import TrainState
from avt_tpu.train import make_eval_step as jmake_eval_step
from avt_tpu.train import make_train_step as jmake_train_step
from avt_tpu_torch import train_net
from avt_tpu_torch.config import Composer, expand_sweeps, parse_override, parse_overrides_file
from avt_tpu_torch.config.build import (
    build_all_datasets,
    build_model,
    build_optimizer_from_cfg,
    build_preprocess_fns,
    loss_weights,
)
from avt_tpu_torch.data.dataset import ConcatDataset
from avt_tpu_torch.data.loader import DataLoader
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.models.import_torch import init_from_model
from avt_tpu_torch.train import make_eval_step, make_train_step, save_checkpoint

import _expt_fixtures
import ref_harness

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

EXPTS_DIR = Path(__file__).resolve().parents[1] / "expts"
B = 2
SMALL = ["model.future_predictor.n_layer=1", "model.future_predictor.inter_dim=64",
         "model.future_predictor.n_head=2", f"train.batch_size={B}", f"eval.batch_size={B}",
         "data_train.workers=2", "data_eval.workers=2", "model.dropout=0.0",
         "+model.future_predictor.embd_pdrop=0.0", "+model.future_predictor.attn_pdrop=0.0",
         "+model.future_predictor.resid_pdrop=0.0"]
# the ViT at a small width, on 32x32 crops of the fixture's 128x96 frames
VIT = 32
SMALL_VIT = [f"model.backbone_dim={VIT}", f"+model.backbone.embed_dim={VIT}",
             "+model.backbone.depth=1", "+model.backbone.num_heads=2",
             f"+model.backbone.img_size={VIT}", "data_train.scale_h=36-40",
             f"data_train.crop_size={VIT}", "data_eval.scale_h=36", f"data_eval.crop_size={VIT}"]
TOL = 2e-4
KEYS = ["video", "target", "target_subclips", "idx", "uid"]

RUN_FROM_FILE = sorted(p.stem for p in EXPTS_DIR.glob("*.txt")
                       if p.stem != "06_ek100_avt_tsnflow")
# expts/05's RULSTM at a small width; the file's spec form onto the seeded
# RULSTM file the data_root fixture writes (EK100's 1024-d features in)
RULSTM_WIDTH, RULSTM_FILE = 64, "rulstm/RULSTM-anticipation_0.25_6_8_rgb_mt5r_best.pth.tar"
SMALL_RULSTM = [f"train.batch_size={B}", f"eval.batch_size={B}", "data_train.workers=2",
                "data_eval.workers=2", "model.dropout=0.0",
                f"+model.temporal_aggregator.intermediate_featdim={RULSTM_WIDTH}",
                f"train.init_from_model=[[temporal_aggregator,${{cwd}}/{RULSTM_FILE}],"
                f"[classifiers.action,classifier.1.,${{cwd}}/{RULSTM_FILE}]]"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The directory holding DATA/, with the timm files the raw-video files
    load (chip_smoke.py's in21k layout at the small width, a block more than
    the model has)."""
    root = tmp_path_factory.mktemp("expt_tree")
    data = _expt_fixtures.build_data_tree(root)
    timm = data / "pretrained" / "TIMM"
    for name in ("jx_vit_base_p16_224-80ecf9dd.pth", "jx_vit_base_patch16_224_in21k-e5005f0a.pth"):
        chip_smoke.write_timm_vit(str(timm / name), embed_dim=VIT, depth=2, img_size=VIT,
                                  seed=31)
    actions = len(_expt_fixtures.pd.read_csv(
        data / "annotations" / "rulstm" / "ek100" / "actions.csv"))
    chip_smoke.write_rulstm(str(root / RULSTM_FILE), feat_dim=1024, hidden=RULSTM_WIDTH,
                            num_actions=actions, seed=32)
    return root


@pytest.fixture
def in_tree(data_root, monkeypatch):
    """The working directory at the tree (so `${cwd}/DATA` is it) and both
    packages' lmdb readers on tests/_fake_lmdb.py."""
    monkeypatch.chdir(data_root)
    fake = ref_harness._load_fake_lmdb()
    monkeypatch.setitem(sys.modules, "lmdb", fake)
    monkeypatch.setattr(jreaders, "lmdb", fake, raising=False)
    monkeypatch.setattr(jreaders, "HAVE_LMDB", True, raising=False)


def _compose(name, overrides=SMALL):
    """Both packages' configs of the file's first sweep variant (a ViT at
    the small width too, where the file's backbone is one; the RULSTM's
    small width and spec for expts/05)."""
    expt = EXPTS_DIR / f"{name}.txt"
    if overrides and "model/temporal_aggregator=rulstm" in expt.read_text():
        overrides = SMALL_RULSTM
    if overrides and "avt_b" in expt.read_text():
        overrides = list(overrides) + SMALL_VIT
    cfg = Composer(train_net.CONF_DIR).compose("config", expand_sweeps(
        parse_overrides_file(expt) + [parse_override(o) for o in overrides])[0])
    jcfg = JComposer(train_net.CONF_DIR).compose("config", jexpand_sweeps(
        jparse_overrides_file(expt) + [jparse_override(o) for o in overrides])[0])
    assert cfg == jcfg
    return cfg, jcfg


def _close(out, ref, what):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= TOL, f"{what}: max |diff| {err:.3g} of its scale (limit {TOL})"


def _write_run_checkpoint(model, path, cfg):
    """The checkpoint a `_testonly` file loads: the port's own run
    checkpoint (`train/checkpoint.py`) at a `<run>/checkpoint` path, else a
    reference `{'model': sd}` file; both hold the model's weights, moved."""
    moved = {k: v * 1.5 + 0.01 for k, v in model.state_dict().items()}
    if os.path.basename(path) == "checkpoint":
        original = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(moved)
        opt, _ = build_optimizer_from_cfg(cfg, model, iters_per_epoch=2)
        save_checkpoint(os.path.dirname(path), model, opt, 1.0)
        model.load_state_dict(original)
    else:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": moved, "epoch": 1.0}, path)


def _folded(sd):
    """LSTM biases folded into bias_hh_l0 (bias_ih_l0 zeros), as avt_tpu's
    cell holds them."""
    out = dict(sd)
    for k in sd:
        if k.endswith("bias_ih_l0"):
            hh = k[:-len("bias_ih_l0")] + "bias_hh_l0"
            out[hh], out[k] = sd[k] + sd[hh], torch.zeros_like(sd[k])
    return out


def _init_both(cfg, model, params):
    """The file's train.init_from_model through both packages; the port's
    weights must equal avt_tpu's exactly, and some must have moved."""
    spec = cfg["train"]["init_from_model"]
    for s in spec:
        if not os.path.exists(str(s[-1])):
            _write_run_checkpoint(model, str(s[-1]), cfg)
    params = jinit_from_model(params, spec)
    loaded = init_from_model(model, spec)
    ref = params_from_jax(params)
    assert loaded and set(ref) == set(model.state_dict())
    for k, v in _folded(model.state_dict()).items():
        assert torch.equal(v, ref[k]), k
    if "RULSTM" in str(spec[0][-1]):  # the aggregator and the action classifier, no more
        assert {k.split(".")[0] for k in loaded} == {"temporal_aggregator", "classifiers"}
        assert len(loaded) == 8 + 2
    if "TIMM" in str(spec[-1][-1]):  # one block of the file's two, no head
        assert all(k.startswith("backbone.model.") and ".blocks.1." not in k for k in loaded)
    return params


def _first(ds, jds, seed, shuffle):
    kw = dict(shuffle=shuffle, drop_last=shuffle, seed=seed, num_workers=2, keys=KEYS)
    batch, jbatch = next(iter(DataLoader(ds, B, **kw))), next(iter(JDataLoader(jds, B, **kw)))
    assert batch.keys() == jbatch.keys()
    for k in ("video", "idx", "uid"):
        assert np.array_equal(batch[k], jbatch[k]), k
    for task in jbatch["target"]:
        assert np.array_equal(batch["target"][task], jbatch["target"][task]), task
    sel = ("video", "target", "target_subclips")
    tb = {k: ({kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
          for k, v in batch.items() if k in sel}
    jb = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v))
          for k, v in jbatch.items() if k in sel}
    return tb, jb


@pytest.mark.parametrize("name", RUN_FROM_FILE)
def test_expt_builds_and_steps_like_avt_tpu(in_tree, name):
    cfg, jcfg = _compose(name)
    train, evals = build_all_datasets(cfg)
    jtrain, jevals = jbuild_all_datasets(jcfg)
    assert [len(d) for d in train] == [len(d) for d in jtrain]
    assert {k: len(d) for k, d in evals.items()} == {k: len(d) for k, d in jevals.items()}
    ds = train[0] if len(train) == 1 else ConcatDataset(train)
    jds = jtrain[0] if len(jtrain) == 1 else JConcatDataset(jtrain)
    num_classes = {k: len(v) for k, v in ds.classes.items()}
    assert num_classes == {k: len(v) for k, v in jds.classes.items()}
    tb, jb = _first(ds, jds, cfg["seed"], shuffle=True)
    eval_pp = jeval_pp = None
    if jb["video"].ndim == 5:  # raw uint8 frames (B, T, H, W, 3)
        _, eval_pp = build_preprocess_fns(cfg, "cpu")
        jtrain_pp, jeval_pp = jbuild_preprocess_fns(jcfg)
        jb["video"] = jax.jit(jtrain_pp)(jb["video"], jax.random.PRNGKey(5))
        tb["video"] = torch.from_numpy(np.array(jb["video"]))

    jm = jbuild_model(jcfg, num_classes, jds.class_mappings)
    params = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), jb["video"], (B,))
    model = build_model(cfg, num_classes, ds.class_mappings, device="cpu")
    load_jax_params(model, params)
    if cfg["train"]["init_from_model"]:
        params = _init_both(cfg, model, params)
    tx, _ = jbuild_optimizer_from_cfg(jcfg, params, iters_per_epoch=2)
    jstep = jmake_train_step(jm, tx, loss_weights(cfg), num_classes, donate=False)
    jeval = jmake_eval_step(jm, num_classes, preprocess_fn=jeval_pp)
    opt, _ = build_optimizer_from_cfg(cfg, model, iters_per_epoch=2)
    step = make_train_step(model, opt, loss_weights(cfg), num_classes)
    eval_step = make_eval_step(model, num_classes, preprocess_fn=eval_pp)

    def eval_both(jparams):
        for suffix in jevals:
            etb, ejb = _first(evals[suffix], jevals[suffix], cfg["seed"], shuffle=False)
            res, ref = eval_step(etb), jeval(jparams, ejb)
            for task in num_classes:
                key = f"logits/{task}"
                if key in ref:
                    _close(res[key], ref[key], f"eval{suffix} {key}")

    # expts/05's lr_wd names `classifiers`, which avt_tpu matches against
    # flax's `classifiers_action` and so freezes, where the reference and the
    # port train the classifier: its eval runs before the step, and after
    # the step only the aggregator (which both train) is compared
    frozen_in_jax = any(m == "classifiers" for m, _, _ in cfg["opt"]["lr_wd"])
    if frozen_in_jax:
        eval_both(params)
    state, jmetrics = jstep(TrainState.create(params, tx), jb, jax.random.PRNGKey(1))
    metrics = step(tb)
    losses = [k for k in jmetrics if k.startswith("loss")]
    assert "loss" in losses and set(losses) <= set(metrics)
    for k in losses:
        _close(metrics[k], jmetrics[k], f"train step {k}")
    if frozen_in_jax:
        stepped = params_from_jax(state.params)
        for k, v in _folded(model.state_dict()).items():
            if k.startswith("temporal_aggregator."):
                _close(v, stepped[k], f"{k} after the step")
    else:
        eval_both(state.params)  # after the step


def test_expt06_as_shipped_is_refused_by_both(in_tree):
    """expts/06 sets drop_style=rulstm, which the reference refuses."""
    cfg, jcfg = _compose("06_ek100_avt_tsnflow")
    with pytest.raises(NotImplementedError):
        jbuild_all_datasets(jcfg)
    with pytest.raises(NotImplementedError):
        build_all_datasets(cfg)


def _eval_matches_avt_tpu(cfg, jcfg):
    """Both packages' build_model on the composed configs, one eval step on
    the first batch of each eval dataset from avt_tpu's weights; the logits
    at TOL."""
    _, evals = build_all_datasets(cfg)
    _, jevals = jbuild_all_datasets(jcfg)
    for suffix, ds in evals.items():
        num_classes = {k: len(v) for k, v in ds.classes.items()}
        tb, jb = _first(ds, jevals[suffix], cfg["seed"], shuffle=False)
        jm = jbuild_model(jcfg, num_classes, jevals[suffix].class_mappings)
        params = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), jb["video"], (B,))
        model = load_jax_params(build_model(cfg, num_classes, ds.class_mappings, device="cpu"),
                                params)
        res = make_eval_step(model, num_classes)(tb)
        ref = jmake_eval_step(jm, num_classes)(params, jb)
        for task in num_classes:
            key = f"logits/{task}"
            if key in ref:
                _close(res[key], ref[key], f"eval{suffix} {key}")


ROLLOUT = ["model.future_predictor.output_len=2", "+model.future_predictor.output_len_eval=8"]


@pytest.mark.parametrize("option", ["output_attentions", "assign_to_centroids"])
def test_expt02_with_an_avth_option_matches_avt_tpu(in_tree, tmp_path, option):
    """expts/02 with attention maps exported over a rollout, or with its
    features assigned to 16 centroids from a .npy file (a cross-entropy
    feat loss over the ids, as JAX's test_train_net runs it): eval as
    avt_tpu's."""
    if option == "output_attentions":
        extra = ROLLOUT + ["+model.future_predictor.output_attentions=true"]
    else:
        cents = np.random.default_rng(3).standard_normal((16, 1024)).astype(np.float32)
        np.save(tmp_path / "cents.npy", cents)
        extra = [f"+model.future_predictor.assign_to_centroids={tmp_path / 'cents.npy'}",
                 "model.future_predictor.future_pred_loss="
                 "{_target_: loss_fn.multidim_xentropy.MultiDimCrossEntropy}"]
    _eval_matches_avt_tpu(*_compose("02_ek100_avt_tsn", overrides=SMALL + extra))


CONV_VIDEO = (2, 1, 3, 4, 33, 33)  # (B, #clips, C, T, H, W) raw clips for a conv backbone
SSL = ["train_eval_op/reg_criterion=simclr_infonce", "model.project_dim_for_nce=32",
       "+dataset_train.return_future_clips_too=true"]


def _expt02_conv_backbone_matches_avt_tpu(cfg, jcfg, monkeypatch):
    """expts/02 on a conv backbone: both packages' `build_model`; the port's
    parameters and buffers named and shaped as avt_tpu's converter maps
    `jax.eval_shape` of its init; AVT-h on the backbone's width (512 or
    1024, not the file's backbone_dim); a finite eval forward on raw clips."""
    import avt_tpu_torch.models.convert as convert

    num_classes = {"action": 7}
    jm = jbuild_model(jcfg, num_classes, {})
    shapes = jax.eval_shape(lambda key, video: jm.init(key, video, (B,)),
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct(CONV_VIDEO, jnp.float32))
    monkeypatch.setattr(convert, "_np", lambda x: np.broadcast_to(np.float32(0), np.shape(x)))
    monkeypatch.setattr(convert, "_conv_k", lambda x: np.broadcast_to(
        np.float32(0), (np.shape(x)[-1], np.shape(x)[-2], *np.shape(x)[:-2])))
    want = convert.avt_from_jax(shapes["params"], shapes["batch_stats"])
    model = build_model(cfg, num_classes, {}, device="cpu")
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items() if not k.endswith("num_batches_tracked")} \
        == {k: v.shape for k, v in want.items()}
    width = 1024 if cfg["model"]["backbone"]["_target_"].endswith("BNInceptionVideo") else 512
    assert sd["future_predictor.encoder.weight"].shape[1] == width
    with torch.no_grad():
        out, _ = model(torch.from_numpy(np.random.default_rng(0).standard_normal(
            CONV_VIDEO).astype(np.float32)), (B,))
    assert out["logits/action"].shape == (B, 7) and torch.isfinite(out["logits/action"]).all()


def _expt02_ssl_step_matches_avt_tpu(cfg, jcfg, tmp_path):
    """pred_future_feat on expts/02: without future clips `main` raises
    avt_tpu's ValueError; with them (and the InfoNCE, a 32-d projection), one
    SSL step from avt_tpu's weights on a seeded feature batch and its future
    clips matches avt_tpu's `make_ssl_train_step`: losses and parameters."""
    from avt_tpu.config.registry import instantiate as jinstantiate
    from avt_tpu.train.step import make_ssl_train_step as jmake_ssl_train_step
    from avt_tpu_torch.config.registry import instantiate
    from avt_tpu_torch.train import make_ssl_train_step

    with pytest.raises(ValueError, match="return_future_clips_too"):
        train_net.main(cfg, str(tmp_path), device="cpu")
    cfg, jcfg = _compose("02_ek100_avt_tsn", overrides=SMALL + ["train_eval_op=pred_future_feat"]
                         + SSL + ["opt.warmup.num_epochs=0"])  # a step at a nonzero LR
    num_classes = {"action": 7}
    rng = np.random.default_rng(0)
    # one clip of 10 features: the reference's step slices the clip batch,
    # so it takes no subclips (both packages' shapes break on expts/02's 10)
    batch = {k: rng.standard_normal((B, 1, 1024, 10, 1, 1)).astype(np.float32)
             for k in ("video", "future_0_video")}
    batch["target"] = {"action": np.array([2, 5], np.int32)}
    jm = jbuild_model(jcfg, num_classes, {})
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batch["video"]))
    model = load_jax_params(build_model(cfg, num_classes, {}, device="cpu"), params)
    tx, _ = jbuild_optimizer_from_cfg(jcfg, params, iters_per_epoch=1)
    opt, _ = build_optimizer_from_cfg(cfg, model, iters_per_epoch=1)
    state, ref = jmake_ssl_train_step(
        jm, tx, loss_weights(jcfg), num_classes, jinstantiate(jcfg["train_eval_op"][
            "reg_criterion"]), donate=False)(TrainState.create(params, tx),
                                             jax.tree.map(jnp.asarray, batch),
                                             jax.random.PRNGKey(1))
    metrics = make_ssl_train_step(model, opt, loss_weights(cfg), num_classes, instantiate(
        cfg["train_eval_op"]["reg_criterion"]))(
        {k: ({kk: torch.from_numpy(vv).long() for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in batch.items()})
    for key in ("loss", "loss/reg", "loss/cls_action", "loss/feat"):
        _close(metrics[key], ref[key], key)
    want = params_from_jax(state.params)
    for name, p in model.named_parameters():
        _close(p, want[name], name)


@pytest.mark.parametrize("overrides,item", [
    (["model/backbone=r2plus1d_34"], "1.6"),
    (["model/backbone=bn_inception", "model.backbone_last_n_modules_to_drop=0"], "1.6"),
    (ROLLOUT, "1.5"),
    (["+model.future_predictor.rollout_mode=cache"] + ROLLOUT, "1.5"),
    (["train_eval_op=pred_future_feat"], "1.8"),
], ids=["r2plus1d_34", "bn_inception", "output_len_2", "rollout_cache", "pred_future_feat"])
def test_unported_option_raises_naming_its_roadmap_item(in_tree, tmp_path, monkeypatch,
                                                        overrides, item):
    """Every shipped file now runs, and so do the options on expts/02 that
    once raised naming their ROADMAP item. Item 1.5's (AVT-h rollouts, of 2
    steps in training and 8 at eval, recomputed or through the KV cache)
    match avt_tpu's eval; item 1.6's conv backbones build as avt_tpu's
    (`_expt02_conv_backbone_matches_avt_tpu`); item 1.8's SSL step matches
    avt_tpu's (`_expt02_ssl_step_matches_avt_tpu`)."""
    cfg, jcfg = _compose("02_ek100_avt_tsn", overrides=SMALL + overrides)
    if item == "1.5":
        _eval_matches_avt_tpu(cfg, jcfg)
    elif item == "1.6":
        _expt02_conv_backbone_matches_avt_tpu(cfg, jcfg, monkeypatch)
    else:
        _expt02_ssl_step_matches_avt_tpu(cfg, jcfg, tmp_path)
