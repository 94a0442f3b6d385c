"""The port's `init_from_model` against avt_tpu's.

A small AVT model (ViT of 2 blocks, 32 wide, AVT-h of 1 layer, 5 actions)
is built in both packages, the port's from avt_tpu's weights
(`params_from_jax`). Each spec then goes through both packages'
`init_from_model` on the same torch files, and the port's parameters must
equal avt_tpu's result, carried by `params_from_jax`, leaf for leaf and
exactly. The files: a timm in21k ViT with its `head` and `pre_logits`
(which neither loads) and a block more than the model has; a reference
`{'model': sd}` AVT checkpoint with a shape-mismatched classifier; a prefix
spec onto a bare `nn.Linear`; the port's own run checkpoint; a raw HF GPT-2;
several specs in turn; an original RULSTM checkpoint (bare nn.LSTM layers
and OpenLSTM's nesting) through expts/05's two-entry spec, the aggregator
and the `classifier.1.` prefix onto the action classifier; a reference AVT
checkpoint carrying a Transformer aggregator, loaded whole; a reference
checkpoint of AVT-h on cluster ids, whose nn.Embedding encoder and tied
decoder load by their names, and round-trip through
`avt_checkpoint_to_flax`. An LSTM's two
biases load as the file holds them, where avt_tpu folds them into one: the
port's are compared folded, and with the file bit for bit. Every error
avt_tpu raises is raised here with the same type; the conv layouts
(pretrainedmodels BN-Inception, torchvision video ResNet, a VISSL trunk)
load what avt_tpu's converters load, BatchNorm running statistics included;
and a directory (an avt_tpu orbax checkpoint) raises ValueError.
"""
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
    IdentityFuture as JIdentityFuture,
    LinearClassifier as JLinearClassifier,
    RULSTMAgg as JRULSTMAgg,
    TransformerAgg as JTransformerAgg,
    ViT as JViT,
)
from avt_tpu.models.import_torch import avt_checkpoint_to_flax
from avt_tpu.models.import_torch import init_from_model as jinit_from_model
from avt_tpu_torch.losses import mse
from avt_tpu_torch.models import (
    AVTh,
    AVTModel,
    IdentityAgg,
    IdentityBackbone,
    IdentityFuture,
    LinearClassifier,
    RULSTMAgg,
    TransformerAgg,
    ViT,
)
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.models.import_torch import init_from_model, load_torch_state_dict
from avt_tpu_torch.train import build_optimizer, save_checkpoint

DIM, N_CLS, MLP, TOK = 32, 5, 128, 5  # a 32x32 image in 16x16 patches: 4 + cls


def _jmodel():
    return JAVTModel(
        backbone=JViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2),
        temporal_aggregator=JIdentityAgg(in_features=DIM),
        future_predictor=JAVTh(in_features=DIM, inter_dim=64, n_layer=1, n_head=2,
                               output_len=1, avg_last_n=1, return_past_too=True,
                               future_pred_loss=lambda p, t: jmse(p, t, reduction="none")),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=DIM),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, classifier_on_past=True)


def _tmodel():
    return AVTModel(
        backbone=ViT(img_size=32, patch_size=16, embed_dim=DIM, depth=2, num_heads=2,
                     device="cpu"),
        temporal_aggregator=IdentityAgg(in_features=DIM),
        future_predictor=AVTh(in_features=DIM, inter_dim=64, n_layer=1, n_head=2,
                              output_len=1, avg_last_n=1, return_past_too=True,
                              future_pred_loss=lambda p, t: mse(p, t, reduction="none"),
                              device="cpu"),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=DIM),
        classifiers={"action": LinearClassifier(DIM, N_CLS, device="cpu")},
        num_classes=(("action", N_CLS),), backbone_dim=DIM, classifier_on_past=True)


@pytest.fixture(scope="module")
def jparams():
    video = np.random.default_rng(0).standard_normal((1, 1, 1, 3, 2, 32, 32), np.float32)
    return jax.jit(_jmodel().init)(jax.random.PRNGKey(0), jnp.asarray(video))


def _w(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02)


def timm_sd(seed, depth=3, head=True):
    """A timm ViT state_dict at the model's width: `depth` blocks, and the
    in21k file's classifier head and pre_logits."""
    rng = np.random.default_rng(seed)
    sd = {"cls_token": _w(rng, 1, 1, DIM), "pos_embed": _w(rng, 1, TOK, DIM),
          "patch_embed.proj.weight": _w(rng, DIM, 3, 16, 16), "patch_embed.proj.bias": _w(rng, DIM),
          "norm.weight": _w(rng, DIM), "norm.bias": _w(rng, DIM)}
    for i in range(depth):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": _w(rng, DIM), f"{b}.norm1.bias": _w(rng, DIM),
                   f"{b}.attn.qkv.weight": _w(rng, 3 * DIM, DIM),
                   f"{b}.attn.qkv.bias": _w(rng, 3 * DIM),
                   f"{b}.attn.proj.weight": _w(rng, DIM, DIM), f"{b}.attn.proj.bias": _w(rng, DIM),
                   f"{b}.norm2.weight": _w(rng, DIM), f"{b}.norm2.bias": _w(rng, DIM),
                   f"{b}.mlp.fc1.weight": _w(rng, MLP, DIM), f"{b}.mlp.fc1.bias": _w(rng, MLP),
                   f"{b}.mlp.fc2.weight": _w(rng, DIM, MLP), f"{b}.mlp.fc2.bias": _w(rng, DIM)})
    if head:
        sd.update({"head.weight": _w(rng, 21843, DIM), "head.bias": _w(rng, 21843),
                   "pre_logits.fc.weight": _w(rng, DIM, DIM), "pre_logits.fc.bias": _w(rng, DIM)})
    return sd


def avt_sd(seed, n_cls=N_CLS):
    """A reference AVT state_dict: another model's weights under the
    reference's names, its classifier over `n_cls` classes."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g) * 0.02 for k, v in _tmodel().state_dict().items()}
    sd["classifiers.action.weight"] = torch.randn(n_cls, DIM, generator=g)
    sd["classifiers.action.bias"] = torch.randn(n_cls, generator=g)
    return sd


def _save(obj, path):
    torch.save(obj, str(path))
    return str(path)


def folded(sd):
    """A state_dict with each LSTM's two biases folded into bias_hh_l0 (and
    bias_ih_l0 zeros), as avt_tpu's cell holds them."""
    out = dict(sd)
    for k in sd:
        if k.endswith("bias_ih_l0"):
            hh = k[:-len("bias_ih_l0")] + "bias_hh_l0"
            out[hh], out[k] = sd[k] + sd[hh], torch.zeros_like(sd[k])
    return out


def both(jparams, specs, tmodel=_tmodel):
    """Both packages' init_from_model from the same weights; the port's
    parameters (LSTM biases folded) must equal avt_tpu's. Returns the names
    the port loaded."""
    model = load_jax_params(tmodel(), jparams)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = params_from_jax(jinit_from_model(jparams, specs))
    loaded = init_from_model(model, specs)
    raw = model.state_dict()
    sd = folded(raw)
    assert set(sd) == set(ref)
    for k in sd:
        assert torch.equal(sd[k], ref[k]), k
    assert set(loaded) == {k for k in raw if not torch.equal(raw[k], before[k])}
    return loaded


@pytest.mark.parametrize("module", ["backbone.model", "backbone"])
def test_timm_in21k_file_loads_the_backbone_as_avt_tpu(jparams, tmp_path, module):
    sd = timm_sd(1)
    path = _save(sd, tmp_path / "jx_vit_base_patch16_224_in21k-e5005f0a.pth")
    loaded = both(jparams, [[module, path]])
    want = {"backbone.model." + k for k in sd if not k.startswith(("head.", "pre_logits.",
                                                                   "blocks.2."))}
    assert set(loaded) == want  # head, pre_logits and the third block are skipped


def test_reference_checkpoint_skips_the_mismatched_classifier(jparams, tmp_path):
    sd = avt_sd(2, n_cls=N_CLS + 1)
    path = _save({"model": sd, "epoch": 3}, tmp_path / "checkpoint.pth")
    loaded = both(jparams, [[path]])
    assert set(loaded) == set(sd) - {"classifiers.action.weight", "classifiers.action.bias"}


def test_reference_checkpoint_into_one_module(jparams, tmp_path):
    path = _save({"state_dict": avt_sd(3)}, tmp_path / "ckpt.pth")
    loaded = both(jparams, [["backbone.model", path]])
    assert loaded and all(k.startswith("backbone.model.") for k in loaded)
    loaded = both(jparams, [["classifiers.action", path]])
    assert set(loaded) == {"classifiers.action.weight", "classifiers.action.bias"}


def test_prefix_spec_onto_a_bare_linear(jparams, tmp_path):
    rng = np.random.default_rng(4)
    sd = {"classifier.1.weight": _w(rng, N_CLS, DIM), "classifier.1.bias": _w(rng, N_CLS),
          "rolling_lstm.weight_ih_l0": _w(rng, 8, DIM)}
    path = _save(sd, tmp_path / "rulstm.pth.tar")
    loaded = both(jparams, [["classifiers.action", "classifier.1.", path]])
    assert set(loaded) == {"classifiers.action.weight", "classifiers.action.bias"}
    loaded = both(jparams, [["classifiers.action", _save(
        {"weight": sd["classifier.1.weight"]}, tmp_path / "linear.pth")]])
    assert loaded == ["classifiers.action.weight"]


def test_the_ports_own_run_checkpoint_loads_whole(jparams, tmp_path):
    src = load_jax_params(_tmodel(), jparams)
    with torch.no_grad():
        for p in src.parameters():
            p.mul_(1.5).add_(0.01)
    opt, _ = build_optimizer(src, [["__all__", 0.1, 0.0]], iters_per_epoch=1, num_epochs=1)
    save_checkpoint(str(tmp_path / "run"), src, opt, 1.0)
    path = str(tmp_path / "run" / "checkpoint")
    loaded = both(jparams, [[path]])
    assert set(loaded) == set(src.state_dict())
    assert set(load_torch_state_dict(path)) == set(src.state_dict())


def test_raw_gpt2_and_several_specs_in_turn(jparams, tmp_path):
    full = avt_sd(5)
    gpt = {k[len("future_predictor.gpt_model."):]: v for k, v in full.items()
           if k.startswith("future_predictor.gpt_model.")}
    gpt["wte.weight"] = torch.zeros(7, 64)
    gpt_path = _save(gpt, tmp_path / "gpt2.bin")
    # into future_predictor: avt_tpu's tree puts GPT-2 under `gpt`, so a raw
    # GPT-2 there matches no name and loads nothing, in both
    assert both(jparams, [["future_predictor", gpt_path]]) == []
    timm_path = _save(timm_sd(6, depth=2, head=False), tmp_path / "vit.pth")
    full_path = _save({"model": full}, tmp_path / "full.pth")
    loaded = both(jparams, [[full_path], ["backbone.model", timm_path]])
    assert set(loaded) == set(full)


def _error_case(tmp_path, case):
    """(spec, exception type) of one failure, its files written."""
    if case == "unrecognized layout":
        return [["backbone", _save({"foo.weight": torch.zeros(2)}, tmp_path / "x.pth")]], ValueError
    if case == "prefix matches nothing":
        return [["classifiers.action", "nope.", _save(avt_sd(7), tmp_path / "x.pth")]], ValueError
    if case == "nothing converted":
        return [[_save({"backbone.foo": torch.zeros(2)}, tmp_path / "x.pth")]], ValueError
    if case == "module not in the model":
        return [["temporal_aggregator", _save(timm_sd(8), tmp_path / "x.pth")]], KeyError
    if case == "module-level file without a module":
        return [[_save(timm_sd(9), tmp_path / "x.pth")]], ValueError
    if case == "timm file missing a leaf":
        sd = timm_sd(10)
        del sd["norm.weight"]
        return [["backbone.model", _save(sd, tmp_path / "x.pth")]], KeyError
    if case == "missing file":
        return [["backbone.model", str(tmp_path / "absent.pth")]], FileNotFoundError
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "unrecognized layout", "prefix matches nothing", "nothing converted",
    "module not in the model", "module-level file without a module",
    "timm file missing a leaf", "missing file"])
def test_errors_match_avt_tpu(jparams, tmp_path, case):
    specs, exc = _error_case(tmp_path, case)
    with pytest.raises(exc):
        jinit_from_model(jparams, specs)
    model = load_jax_params(_tmodel(), jparams)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(exc):
        init_from_model(model, specs)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


H = 24  # the RULSTM's width


def _lstm(rng, prefix, feat=DIM):
    return {f"{prefix}.weight_ih_l0": _w(rng, 4 * H, feat),
            f"{prefix}.weight_hh_l0": _w(rng, 4 * H, H),
            f"{prefix}.bias_ih_l0": _w(rng, 4 * H), f"{prefix}.bias_hh_l0": _w(rng, 4 * H)}


def _jagg_model(agg):
    return JAVTModel(
        backbone=JIdentityBackbone(), temporal_aggregator=agg,
        future_predictor=JIdentityFuture(in_features=agg.output_dim),
        temporal_aggregator_after_future_pred=JIdentityAgg(in_features=agg.output_dim),
        classifiers={"action": JLinearClassifier(out_features=N_CLS)},
        num_classes=(("action", N_CLS),), backbone_dim=DIM)


def _tagg_model(agg):
    return AVTModel(
        backbone=IdentityBackbone(), temporal_aggregator=agg,
        future_predictor=IdentityFuture(agg.output_dim),
        temporal_aggregator_after_future_pred=IdentityAgg(agg.output_dim),
        classifiers={"action": LinearClassifier(agg.output_dim, N_CLS, device="cpu")},
        num_classes=(("action", N_CLS),), backbone_dim=DIM)


def _agg_params(jm):
    video = np.random.default_rng(1).standard_normal((1, 1, DIM, 6, 1, 1), np.float32)
    return jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(video))


@pytest.mark.parametrize("nested", [False, True], ids=["bare", "openlstm"])
def test_rulstm_checkpoint_loads_as_avt_tpu_through_the_expts05_spec(tmp_path, nested):
    """expts/05's spec: the LSTMs into the aggregator, then the classifier
    through the `classifier.1.` prefix; the file is an original
    `{'state_dict': ..., 'epoch': ...}` RULSTM checkpoint."""
    rng = np.random.default_rng(14)
    sub = ".lstm" if nested else ""
    sd = {**_lstm(rng, f"rolling_lstm{sub}"), **_lstm(rng, f"unrolling_lstm{sub}"),
          "classifier.1.weight": _w(rng, N_CLS, H), "classifier.1.bias": _w(rng, N_CLS)}
    path = _save({"state_dict": sd, "epoch": 40, "best_perf": 0.1}, tmp_path / "rulstm.pth.tar")
    jparams = _agg_params(_jagg_model(JRULSTMAgg(in_features=DIM, intermediate_featdim=H)))
    tmodel = lambda: _tagg_model(RULSTMAgg(DIM, H, device="cpu"))  # noqa: E731
    specs = [["temporal_aggregator", path], ["classifiers.action", "classifier.1.", path]]
    loaded = both(jparams, specs, tmodel)
    lstm = {f"temporal_aggregator.{k.replace('.lstm.', '.')}": v for k, v in sd.items()
            if "lstm" in k}
    assert set(loaded) == set(lstm) | {"classifiers.action.weight", "classifiers.action.bias"}
    model = load_jax_params(tmodel(), jparams)
    init_from_model(model, specs)
    got = model.state_dict()
    for k, v in lstm.items():  # the file's tensors, both biases, bit for bit
        assert torch.equal(got[k], v), k
    assert torch.equal(got["classifiers.action.weight"], sd["classifier.1.weight"])


def test_an_avt_checkpoint_with_a_transformer_aggregator_loads_whole(tmp_path):
    """A reference AVT checkpoint carrying a Transformer aggregator (its
    positional table and mask embedding too) loads whole as avt_tpu loads
    it; a spec into one module takes only that module's part."""
    E = 16
    jagg = JTransformerAgg(in_features=DIM, inter_rep=E, nheads=2, nlayers=2, ffn_dim=32)
    jparams = _agg_params(_jagg_model(jagg))
    tmodel = lambda: _tagg_model(TransformerAgg(DIM, E, 2, 2, 32, device="cpu"))  # noqa: E731
    g = torch.Generator().manual_seed(15)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in tmodel().state_dict().items()}
    sd["temporal_aggregator.pos_encoder.pe"] = torch.zeros(1000, 1, E)  # a buffer: not loaded
    path = _save({"model": sd}, tmp_path / "x.pth")
    loaded = both(jparams, [[path]], tmodel)
    assert set(loaded) == set(sd) - {"temporal_aggregator.pos_encoder.pe"}
    loaded = both(jparams, [["temporal_aggregator", path]], tmodel)
    assert loaded and all(k.startswith("temporal_aggregator.") for k in loaded)
    # with a mask embedding (a cloze-trained aggregator): into a model that has one
    sd["temporal_aggregator.extra_embeddings.weight"] = torch.randn(1, DIM, generator=g)
    model = _tagg_model(TransformerAgg(DIM, E, 2, 2, 32, cloze_loss_ratio=0.2, device="cpu"))
    init_from_model(model, [[_save({"model": sd}, tmp_path / "y.pth")]])
    assert torch.equal(model.state_dict()["temporal_aggregator.extra_embeddings.weight"],
                       sd["temporal_aggregator.extra_embeddings.weight"])


def _conv_models(layout):
    """An AVTModel on a conv backbone in both packages: BN-Inception, or a
    video ResNet of one (2+1)D block a stage; mean aggregator, identity
    future, 5 actions."""
    import avt_tpu.models.video_resnet as jvr
    import avt_tpu_torch.models.video_resnet as tvr
    from avt_tpu.models import MeanAgg as JMeanAgg
    from avt_tpu.models.bninception import BNInceptionVideo as JBNInceptionVideo
    from avt_tpu_torch.models import BNInceptionVideo, MeanAgg

    if layout == "bninception":
        jb, tb, dim = JBNInceptionVideo(), BNInceptionVideo(device="cpu"), 1024
    else:
        jb = jvr.VideoResNet(block=jvr.BasicBlock3D, conv_maker=jvr.Conv2Plus1D,
                             layers=(1, 1, 1, 1), stem="r2plus1d")
        tb = tvr.VideoResNet(tvr.BasicBlock3D, tvr.Conv2Plus1D, (1, 1, 1, 1), "r2plus1d",
                             device="cpu")
        dim = 512
    heads = dict(future_predictor=JIdentityFuture(in_features=dim),
                 temporal_aggregator_after_future_pred=JIdentityAgg(in_features=dim),
                 classifiers={"action": JLinearClassifier(out_features=N_CLS)},
                 num_classes=(("action", N_CLS),), backbone_dim=dim)
    jm = JAVTModel(backbone=jb, temporal_aggregator=JMeanAgg(in_features=dim), **heads)
    tm = AVTModel(backbone=tb, temporal_aggregator=MeanAgg(dim),
                  future_predictor=IdentityFuture(dim),
                  temporal_aggregator_after_future_pred=IdentityAgg(dim),
                  classifiers={"action": LinearClassifier(dim, N_CLS, device="cpu")},
                  num_classes=(("action", N_CLS),), backbone_dim=dim)
    return jm, tm


@pytest.mark.parametrize("layout", ["bninception", "video_resnet", "vissl_resnet"])
def test_layouts_of_unported_modules_raise_naming_queue_1_6(tmp_path, layout):
    """The conv layouts, whose modules raised naming ROADMAP Queue 1.6 until
    they were ported: a pretrainedmodels BN-Inception file (with its
    `last_linear`), a torchvision video ResNet (with its `fc`) and the same
    as a VISSL trunk (`_feature_blocks.` inside `classy_state_dict`), seeded,
    with `num_batches_tracked` counts. `init_from_model` into
    `backbone.model` loads what avt_tpu's does, bit for bit: every conv and
    every BatchNorm's weight, bias and running statistics, not the head nor
    the counts."""
    jm, tm = _conv_models(layout)
    video = np.random.default_rng(0).standard_normal((1, 1, 3, 4, 33, 33), np.float32)
    jvars = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video))
    load_jax_params(tm, jvars)
    g = torch.Generator().manual_seed(12)
    backbone = {k[len("backbone.model."):]: v for k, v in tm.state_dict().items()
                if k.startswith("backbone.model.")}
    sd = {k: (torch.tensor(3) if k.endswith("num_batches_tracked")
              else torch.rand(v.shape, generator=g) + 0.5 if k.endswith("running_var")
              else torch.randn(v.shape, generator=g) * 0.05) for k, v in backbone.items()}
    head = "last_linear" if layout == "bninception" else "fc"
    sd.update({f"{head}.weight": torch.randn(400, 8, generator=g),
               f"{head}.bias": torch.randn(400, generator=g)})
    obj = sd if layout != "vissl_resnet" else {"classy_state_dict": {"base_model": {"model": {
        "trunk": {"_feature_blocks." + k: v for k, v in sd.items()}}}}}
    path = _save(obj, tmp_path / "x.pth")
    loaded = init_from_model(tm, [["backbone.model", path]])
    ref = params_from_jax(jinit_from_model(jvars, [["backbone.model", path]]))
    got = tm.state_dict()
    assert set(ref) == {k for k in got if not k.endswith("num_batches_tracked")}
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert set(loaded) == {"backbone.model." + k for k in backbone
                           if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(got["backbone.model." + k], sd[k]) for k in backbone
               if not k.endswith("num_batches_tracked"))


def test_a_directory_is_an_avt_tpu_checkpoint(tmp_path):
    (tmp_path / "checkpoint").mkdir()
    with pytest.raises(ValueError, match="avt_tpu"):
        init_from_model(_tmodel(), [[str(tmp_path / "checkpoint")]])
    with pytest.raises(ValueError, match="avt_tpu"):
        init_from_model(_tmodel(), [["backbone.model", str(tmp_path / "checkpoint")]])


K_IDS = 12  # cluster ids of the quantized AVT-h


def _quantized(cls, head, agg, backbone, **kw):
    """AVT-h on cluster ids (in_features 1: an nn.Embedding encoder, the
    decoder tied to it) behind an identity backbone, in either package."""
    return cls[0](
        backbone=backbone(), temporal_aggregator=agg(in_features=1),
        future_predictor=cls[1](in_features=1, num_cluster_centers=K_IDS, inter_dim=64,
                                n_layer=1, n_head=2, output_len=1, avg_last_n=1, **kw),
        temporal_aggregator_after_future_pred=agg(in_features=64),
        classifiers={"action": head}, num_classes=(("action", N_CLS),), backbone_dim=1)


def test_a_tied_embedding_checkpoint_loads_by_name_into_a_quantized_avth(tmp_path):
    """A reference AVT checkpoint whose future_predictor.encoder.weight and
    decoder.weight are one tied (K, inter_dim) embedding loads by those
    names into the port's quantized AVT-h as avt_tpu's converter loads it
    (encoder_embed), and the port's state_dict maps back to it."""
    jm = _quantized((JAVTModel, JAVTh), JLinearClassifier(out_features=N_CLS), JIdentityAgg,
                    JIdentityBackbone)
    ids = np.random.default_rng(6).integers(0, K_IDS, size=(2, 4, 1, 1, 1, 1))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.float32))

    def tmodel():
        return _quantized((AVTModel, AVTh), LinearClassifier(64, N_CLS, device="cpu"),
                          IdentityAgg, IdentityBackbone, device="cpu")

    g = torch.Generator().manual_seed(7)
    sd = {k: torch.randn(v.shape, generator=g) * 0.02 for k, v in tmodel().state_dict().items()}
    sd["future_predictor.decoder.weight"] = sd["future_predictor.encoder.weight"]
    assert sd["future_predictor.encoder.weight"].shape == (K_IDS, 64)
    loaded = both(jparams, [[_save({"model": sd}, tmp_path / "quantized.pth")]], tmodel)
    assert {"future_predictor.encoder.weight", "future_predictor.decoder.weight"} <= set(loaded)
    model = load_jax_params(tmodel(), jparams)
    init_from_model(model, [[str(tmp_path / "quantized.pth")]])
    fp = model.future_predictor
    assert fp.decoder.weight is fp.encoder.weight
    assert torch.equal(fp.encoder.weight, sd["future_predictor.encoder.weight"])
    back = avt_checkpoint_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    np.testing.assert_array_equal(back["future_predictor"]["encoder_embed"]["embedding"],
                                  sd["future_predictor.encoder.weight"].numpy())
    assert "encoder" not in back["future_predictor"]
    with torch.no_grad():  # the loaded model runs on ids
        out, _ = model.eval()(torch.from_numpy(ids.astype(np.float32)), (2,))
    assert out["logits/action"].shape == (2, N_CLS)
