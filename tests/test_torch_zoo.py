"""The rest of the model heads against avt_tpu on the CPU, at small widths
(widths of 32-128, a few layers, batches of 2), each with avt_tpu's weights
carried by `params_from_jax`, in f32 at 2e-4: MeanAgg; RULSTMAgg at 0 and
3 padding steps; TransformerAgg on the plain path (10 features) and at 128,
where both sides take the flash path (the Pallas kernels `_flash_kernel`,
`_dq_kernel` and `_dkv_kernel` in interpret mode, the port's plain flash
versions), with mean and last pooling, and in cloze training with a given
mask; EncoderBlock forward and gradients on both paths; MLPFuture,
IdentityFuture, MLPClassifier; then `build_model` on composed configs,
against avt_tpu's `build_model`: every aggregator, future predictor and
classifier of conf/model, each of AVTModel's five options, and the ViT's
drop_rate and gelu_approx. The Transformer aggregator's dropout after the
positional table is fixed at 0.1, so the tests that train it patch flax's
Dropout and the port's dropout to the identity (JAX's and torch's random
bits differ). Then the converter round trip of a model holding every new
module, and the init statistics."""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

import avt_tpu.models.layers as jlayers
import avt_tpu_torch.models.layers as tlayers
import avt_tpu_torch.models.temporal_agg as ttagg
from avt_tpu.config import Composer as JComposer
from avt_tpu.config import parse_override as jparse_override
from avt_tpu.config.build import build_model as jbuild_model
from avt_tpu.models import (
    IdentityFuture as JIdentityFuture,
    MeanAgg as JMeanAgg,
    MLPClassifier as JMLPClassifier,
    MLPFuture as JMLPFuture,
    RULSTMAgg as JRULSTMAgg,
    TransformerAgg as JTransformerAgg,
)
from avt_tpu.models.import_torch import avt_checkpoint_to_flax
from avt_tpu.models.layers import EncoderBlock as JEncoderBlock
from avt_tpu_torch import train_net
from avt_tpu_torch.config import Composer, parse_override
from avt_tpu_torch.config.build import build_model
from avt_tpu_torch.models import (
    EncoderBlock,
    IdentityFuture,
    MeanAgg,
    MLPClassifier,
    MLPFuture,
    RULSTMAgg,
    TransformerAgg,
)
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.ops import flash_attention as tfa

TOL = 2e-4  # f32: the same math summed in another order
B, T, C = 2, 10, 48


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x,
                                                                                     np.float32)


def _close(out, ref, what=""):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL, err_msg=what)


def _scaled_close(out, ref, what):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= TOL, f"{what}: max |diff| {err:.3g} of its scale (limit {TOL})"


@pytest.fixture
def flash_path(monkeypatch):
    """Both sides' encoder attention on the flash path: the Pallas kernels in
    interpret mode, the port's plain flash versions; returns the mock that
    counts the port's flash_attention calls."""
    monkeypatch.setattr(jlayers, "dot_product_attention",
                        functools.partial(jlayers.dot_product_attention, use_pallas=True))
    monkeypatch.setattr(tlayers, "dot_product_attention",
                        functools.partial(tlayers.dot_product_attention, use_kernel=True))
    calls = mock.Mock(wraps=tfa.flash_attention)
    monkeypatch.setattr(tfa, "flash_attention", calls)
    return calls


@pytest.fixture
def no_dropout(monkeypatch):
    """flax's Dropout and the port's dropout as the identity."""
    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for module in (ttagg, tlayers):
        monkeypatch.setattr(module, "dropout", lambda x, *a, **k: x)


def _apply_both(jm, tm, x, **init_kw):
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), **init_kw)
    ref = jm.apply(params, jnp.asarray(x))
    tm = load_jax_params(tm, params).eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    return out, ref, params


def test_mean_agg_matches_avt_tpu():
    x = _rand((B, T, C), 0)
    out, aux = MeanAgg(C)(torch.from_numpy(x))
    ref, jaux = JMeanAgg(in_features=C).apply({}, jnp.asarray(x))
    assert aux == jaux == {} and MeanAgg(C).output_dim == C
    _close(out, ref)


@pytest.mark.parametrize("num_pad_feats", [0, 3])
def test_rulstm_agg_matches_avt_tpu(num_pad_feats):
    x = _rand((B, T, C), 1)
    jm = JRULSTMAgg(in_features=C, intermediate_featdim=40, dropout=0.0,
                    num_pad_feats=num_pad_feats)
    tm = RULSTMAgg(C, 40, dropout=0.0, num_pad_feats=num_pad_feats, device="cpu")
    (out, aux), (ref, _), params = _apply_both(jm, tm, x)
    assert aux == {} and out.shape == (B, 40) and tm.output_dim == 40
    _close(out, ref)
    # the JAX cell's one bias is the port's h side; the input side is zeros
    sd = params_from_jax(params)
    assert not sd["rolling_lstm.bias_ih_l0"].any()
    np.testing.assert_array_equal(
        sd["unrolling_lstm.bias_hh_l0"][40:80].numpy(),
        np.asarray(params["params"]["unrolling"]["hf"]["bias"]))


def _jtransformer(**kw):
    return JTransformerAgg(in_features=C, inter_rep=128, nheads=2, nlayers=2, ffn_dim=64,
                           dropout=0.0, **kw)


def _ttransformer(**kw):
    return TransformerAgg(C, inter_rep=128, nheads=2, nlayers=2, ffn_dim=64, dropout=0.0,
                          device="cpu", **kw)


@pytest.mark.parametrize("agg_style", ["mean", "last"])
@pytest.mark.parametrize("T_", [10, 128])
def test_transformer_agg_matches_avt_tpu(T_, agg_style, request):
    """At 10 features the plain path; at 128 both sides take the flash path,
    non-causal (2 heads of 64)."""
    calls = request.getfixturevalue("flash_path") if T_ >= 128 else None
    x = _rand((B, T_, C), 2)
    (out, aux), (ref, jaux), _ = _apply_both(_jtransformer(agg_style=agg_style),
                                             _ttransformer(agg_style=agg_style), x)
    assert aux == jaux == {} and out.shape == (B, 128)
    _close(out, ref)
    if calls is not None:
        assert calls.call_count == 2 and calls.call_args.args[3] is False  # non-causal


@pytest.mark.usefixtures("no_dropout")
def test_transformer_agg_cloze_with_a_given_mask_matches_avt_tpu(monkeypatch):
    """Cloze training: the same draw on both sides (JAX's uniform and the
    port's `_uniform` patched to one array), the masked positions swapped
    for the mask embedding and dropped as attention keys; the output and the
    tx_mlm loss. The mask embedding exists in JAX only when it is
    initialised in train mode."""
    x = _rand((B, T, C), 3)
    u = np.random.default_rng(4).uniform(size=(B, T)).astype(np.float32)
    jm = _jtransformer(cloze_loss_ratio=0.4, cloze_loss_wt=0.5)
    rngs = {"params": jax.random.PRNGKey(0), "cloze": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params = jm.init(rngs, jnp.asarray(x), train=True)
    assert params["params"]["mask_embed"].shape == (1, 1, C)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    ref, jaux = jm.apply(params, jnp.asarray(x), train=True,
                         rngs={"cloze": jax.random.PRNGKey(3)})
    monkeypatch.setattr(ttagg, "_uniform", lambda shape, generator, device: torch.from_numpy(u))
    tm = load_jax_params(_ttransformer(cloze_loss_ratio=0.4, cloze_loss_wt=0.5), params)
    out, aux = tm.train()(torch.from_numpy(x))
    assert 0 < (u <= 0.4).sum() < u.size and set(aux) == set(jaux) == {"tx_mlm"}
    _close(out, ref)
    _close(aux["tx_mlm"], jaux["tx_mlm"])
    # an eval-mode JAX init has no mask embedding: the port keeps its own
    eval_params = jm.init(rngs, jnp.asarray(x))
    assert "mask_embed" not in eval_params["params"]
    assert "extra_embeddings.weight" not in params_from_jax(eval_params)
    load_jax_params(_ttransformer(cloze_loss_ratio=0.4), eval_params)


@pytest.mark.parametrize("T_", [10, 128])
def test_encoder_block_forward_and_gradients_match_avt_tpu(T_, request):
    """Forward and the gradients of every parameter and the input, at 10
    tokens (plain) and 128 (the flash forward and backward, non-causal)."""
    calls = request.getfixturevalue("flash_path") if T_ >= 128 else None
    x, dy = _rand((B, T_, 128), 5), _rand((B, T_, 128), 6)
    jm = JEncoderBlock(num_heads=2, ffn_dim=64, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, vjp = jax.vjp(lambda p, a: jm.apply(p, a), params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tm = load_jax_params(EncoderBlock(128, 2, 64, dropout=0.0, device="cpu"), params)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tm.train()(tx)
    out.backward(torch.from_numpy(dy))
    _close(out, ref)
    _scaled_close(tx.grad, jgx, "dx")
    jgrads = params_from_jax(jgp)
    for name, p in tm.named_parameters():
        _scaled_close(p.grad, jgrads[name], f"d{name}")
    if calls is not None:
        assert calls.call_count == 1


def test_future_predictors_and_mlp_classifier_match_avt_tpu():
    x = _rand((B, T, C), 7)
    (past, fut, losses, ends), (jpast, jfut, jlosses, jends), _ = _apply_both(
        JMLPFuture(in_features=C, num_layers=3), MLPFuture(C, num_layers=3, device="cpu"), x)
    assert losses == jlosses == {} and ends == jends == {}
    _close(past, jpast)
    _close(fut, jfut)
    assert torch.equal(past, torch.from_numpy(x))
    past, fut, _, _ = IdentityFuture(C)(torch.from_numpy(x))
    jpast, jfut, _, _ = JIdentityFuture(in_features=C).apply({}, jnp.asarray(x))
    _close(past, jpast)
    _close(fut, jfut)
    for bias in (True, False):
        out, ref, params = _apply_both(JMLPClassifier(out_features=7, nlayers=3, bias=bias),
                                       MLPClassifier(C, 7, nlayers=3, bias=bias, device="cpu"),
                                       x)
        _close(out, ref)
        assert ("bias" in params["params"]["fc_0"]) == bias
        assert "bias" in params["params"]["fc_2"]


# ------------------------------------------------------------ build_model
FEAT, N_ACT = 48, 6
NUM_CLASSES = {"action": N_ACT, "verb": 3, "noun": 2}
VERB_IN_ACTION = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
NOUN_IN_ACTION = np.eye(2, dtype=np.float32)[[0, 0, 0, 1, 1, 1]]
CLASS_MAPPINGS = {("verb", "action"): VERB_IN_ACTION, ("noun", "action"): NOUN_IN_ACTION}
FEATURES = ["model/backbone=identity", f"model.backbone_dim={FEAT}", "model.dropout=0.0",
            "model/temporal_aggregator=identity"]
SMALL_TX = ["+model.temporal_aggregator.inter_rep=32", "+model.temporal_aggregator.nheads=2",
            "+model.temporal_aggregator.nlayers=2", "+model.temporal_aggregator.ffn_dim=64"]
SMALL_AVTH = ["model/future_predictor=avth", "+model.future_predictor.n_layer=1",
              "+model.future_predictor.n_head=2", "+model.future_predictor.inter_dim=32",
              "+model.future_predictor.output_len=1", "+model.future_predictor.avg_last_n=1",
              "+model.future_predictor.embd_pdrop=0.0", "+model.future_predictor.attn_pdrop=0.0",
              "+model.future_predictor.resid_pdrop=0.0"]
VIT = ["model/backbone=avt_b", "model.backbone_dim=32", "model.backbone_last_n_modules_to_drop=0",
       "+model.backbone.embed_dim=32", "+model.backbone.depth=1", "+model.backbone.num_heads=2",
       "+model.backbone.img_size=32"]
CASES = {
    # every temporal aggregator of conf/model/temporal_aggregator
    "agg_identity": FEATURES,
    "agg_mean": FEATURES + ["model/temporal_aggregator=mean"],
    "agg_rulstm": FEATURES + ["model/temporal_aggregator=rulstm",
                              "+model.temporal_aggregator.intermediate_featdim=40",
                              "model.temporal_aggregator.num_pad_feats=3"],
    "agg_transformer": FEATURES + ["model/temporal_aggregator=transformer"] + SMALL_TX,
    "after_agg_mean": FEATURES + ["model/temporal_aggregator_after_future_pred=mean"],
    "after_agg_rulstm": FEATURES + [
        "model/temporal_aggregator_after_future_pred=rulstm",
        "+model.temporal_aggregator_after_future_pred.intermediate_featdim=24"],
    "after_agg_transformer": FEATURES + [
        "model/temporal_aggregator_after_future_pred=transformer"] + [
        o.replace("temporal_aggregator", "temporal_aggregator_after_future_pred")
        for o in SMALL_TX],
    # every future predictor (AVT-h at its one-step rollout) and classifier
    "future_identity": FEATURES + ["model/future_predictor=identity"],
    "future_mlp": FEATURES + ["model/future_predictor=mlp",
                              "+model.future_predictor.num_layers=3"],
    "future_avth": FEATURES + SMALL_AVTH,
    "classifier_linear": FEATURES + ["model/temporal_aggregator=mean"],
    "classifier_mlp": FEATURES + ["model/temporal_aggregator=mean", "model/classifier=mlp",
                                  "model.classifier.nlayers=3"],
    "classifier_mlp_no_bias": FEATURES + ["model/temporal_aggregator=mean",
                                          "model/classifier=mlp", "model.classifier.bias=false"],
    # AVTModel's five options
    "intermediate_featdim": FEATURES + ["model/temporal_aggregator=mean",
                                        "model.intermediate_featdim=32"],
    "same_temp_agg_dim": FEATURES + ["model/temporal_aggregator=transformer",
                                     "model.same_temp_agg_dim=true"] + SMALL_TX,
    "project_dim_for_nce": FEATURES + ["model/temporal_aggregator=mean",
                                       "model.project_dim_for_nce=16"],
    "project_dim_for_nce_transformer": FEATURES + ["model/temporal_aggregator=transformer",
                                                   "model.project_dim_for_nce=16"] + SMALL_TX,
    "use_cls_mappings": FEATURES + ["model/temporal_aggregator=mean",
                                    "model.use_cls_mappings=true",
                                    "model.classifier_on_past=true"],
    "add_regression_head": FEATURES + ["model/temporal_aggregator=rulstm",
                                       "+model.temporal_aggregator.intermediate_featdim=40",
                                       "model.add_regression_head=true"],
    # the ViT at drop_rate 0, its GELU chosen either way
    "vit_gelu_exact": VIT + ["+model.backbone.drop_rate=0.0",
                             "+model.backbone.gelu_approx=false"],
    "vit_gelu_approx": VIT + ["+model.backbone.drop_rate=0.0",
                              "+model.backbone.gelu_approx=true"],
}


def _compose(overrides):
    cfg = Composer(train_net.CONF_DIR).compose("config", [parse_override(o) for o in overrides])
    jcfg = JComposer(train_net.CONF_DIR).compose("config",
                                                 [jparse_override(o) for o in overrides])
    assert cfg == jcfg
    return cfg, jcfg


def _models(overrides, video):
    cfg, jcfg = _compose(overrides)
    jm = jbuild_model(jcfg, NUM_CLASSES, CLASS_MAPPINGS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(video))
    model = build_model(cfg, NUM_CLASSES, CLASS_MAPPINGS, device="cpu")
    return jm, params, load_jax_params(model, params).eval()


def _video(overrides, seed=8):
    if "model/backbone=avt_b" in overrides:
        return _rand((B, 1, 3, 2, 32, 32), seed)
    return _rand((B, 1, FEAT, T, 1, 1), seed)  # (B, #clips, C, T, 1, 1) features


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_model_matches_avt_tpu(case):
    overrides = CASES[case]
    video = _video(overrides)
    jm, params, model = _models(overrides, video)
    jout, jaux = jm.apply(params, jnp.asarray(video))
    with torch.no_grad():
        out, aux = model(torch.from_numpy(video))
    assert set(out) == set(jout) and set(aux) == set(jaux)
    for key in jout:
        _close(out[key], jout[key], key)
    if case == "use_cls_mappings":
        assert set(model.classifiers) == {"action"}
        assert {"logits/verb", "past_logits/noun"} <= set(out)
    if case.startswith("project_dim_for_nce"):
        assert out["temp_agg_projected"].shape[-1] == 16
        # only a backbone mean as wide as the aggregator's output is projected
        assert ("backbone_mean_projected" in out) == (case == "project_dim_for_nce")
    if case == "add_regression_head":
        assert out["logits_regression"].shape == (B, 1)
    if case == "intermediate_featdim":
        assert "mapper_to_inter.weight" in model.state_dict()
    if case == "same_temp_agg_dim":
        assert "reset_temp_agg_feat_dim.weight" in model.state_dict()


@pytest.mark.usefixtures("no_dropout")
@pytest.mark.parametrize("case", ["agg_transformer", "agg_rulstm", "future_mlp"])
def test_build_model_train_forward_and_gradients_match_avt_tpu(case):
    """Train mode (dropout as the identity on both sides) through the
    aggregators with parameters: outputs and every parameter's gradient."""
    overrides = CASES[case]
    video = _video(overrides, seed=9)
    jm, params, model = _models(overrides, video)

    def jloss(p):
        out, _ = jm.apply(p, jnp.asarray(video), train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["logits/action"] ** 2)

    jval, jgp = jax.jit(jax.value_and_grad(jloss))(params)
    out, _ = model.train()(torch.from_numpy(video))
    val = (out["logits/action"] ** 2).sum()
    val.backward()
    _close(val, jval, "loss")
    jgrads = params_from_jax(jgp)
    for name, p in model.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad  # an unused head's
        _scaled_close(grad, jgrads[name], f"d{name}")


def _conv_backbone_builds_as_avt_tpu(overrides):
    """conf/config.yaml on a conv backbone: the port builds it with
    model.bn's eps and torch momentum (set here to 1e-4 and 0.2) and its own
    width (not model.backbone_dim, 2048 in the config), and raises avt_tpu's
    ValueError for a backbone_last_n_modules_to_drop the backbone was not
    built with (BN-Inception's is 0, the config's 2)."""
    cfg, jcfg = _compose(overrides)
    if "bn_inception" in overrides[0]:
        for build, c in ((jbuild_model, jcfg), (functools.partial(build_model, device="cpu"),
                                                 cfg)):
            with pytest.raises(ValueError, match="backbone_last_n_modules_to_drop=2"):
                build(c, NUM_CLASSES, CLASS_MAPPINGS)
        overrides = overrides + ["model.backbone_last_n_modules_to_drop=0"]
    cfg, _ = _compose(overrides + ["model.bn.eps=0.0001", "model.bn.mom=0.2"])
    model = build_model(cfg, NUM_CLASSES, CLASS_MAPPINGS, device="cpu")
    backbone = model.backbone["model"]
    norms = {(m.eps, m.momentum) for m in backbone.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert norms == {(1e-4, 0.2)}
    assert model.backbone_dim == backbone.output_dim == (
        1024 if "bn_inception" in overrides[0] else 512)
    assert model.classifiers["action"].weight.shape[1] == backbone.output_dim


def test_unported_model_options_raise_naming_their_roadmap_item():
    """The options that once raised naming their ROADMAP item: the conv
    backbones (item 1.6) build as avt_tpu's `build_model` does
    (`_conv_backbone_builds_as_avt_tpu`); AVT-h's rollout options (item 1.5)
    build and match avt_tpu's eval forward."""
    for overrides, item in (
            (["model/backbone=r2plus1d_34"], "1.6"), (["model/backbone=bn_inception"], "1.6"),
            (FEATURES + SMALL_AVTH[:-4] + ["+model.future_predictor.output_len_eval=2"], "1.5"),
            (FEATURES + SMALL_AVTH + ["+model.future_predictor.rollout_mode=cache",
                                      "+model.future_predictor.output_len_eval=3"], "1.5")):
        if item == "1.6":
            _conv_backbone_builds_as_avt_tpu(overrides)
            continue
        video = _video(overrides)
        jm, params, model = _models(overrides, video)
        jout, _ = jm.apply(params, jnp.asarray(video))
        with torch.no_grad():
            out, _ = model(torch.from_numpy(video))
        assert set(out) == set(jout)
        for key in jout:
            _close(out[key], jout[key], key)


ROUND_TRIP = {
    "transformer": FEATURES + [
        "model/temporal_aggregator=transformer", "model/future_predictor=mlp",
        "model.same_temp_agg_dim=true", "model.intermediate_featdim=40",
        "model.project_dim_for_nce=16", "model.add_regression_head=true",
        "+model.temporal_aggregator.cloze_loss_ratio=0.3"] + SMALL_TX,
    "rulstm": FEATURES + ["model/temporal_aggregator_after_future_pred=rulstm",
                          "+model.temporal_aggregator_after_future_pred.intermediate_featdim=24",
                          "model/future_predictor=mlp"],
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_converter_round_trip_of_the_new_modules(case):
    """A port state_dict holding every new module (the Transformer aggregator
    with its mask embedding, the RULSTM, the MLP future predictor, the
    mapper, the width reset, the NCE projection, the regression head) goes
    through avt_tpu's `avt_checkpoint_to_flax` and back to the same JAX
    params (the mask embedding from a train-mode init)."""
    overrides = ROUND_TRIP[case]
    cfg, jcfg = _compose(overrides)
    video = _video(overrides)
    jm = jbuild_model(jcfg, NUM_CLASSES, CLASS_MAPPINGS)
    rngs = {"params": jax.random.PRNGKey(0), "cloze": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params = jax.jit(functools.partial(jm.init, train=True))(rngs, jnp.asarray(video))
    model = load_jax_params(build_model(cfg, NUM_CLASSES, CLASS_MAPPINGS, device="cpu"), params)
    sd = model.state_dict()
    want = {"transformer": {
        "temporal_aggregator.transformer_encoder.layers.1.self_attn.in_proj_weight",
        "temporal_aggregator.extra_embeddings.weight", "future_predictor.model.2.weight",
        "mapper_to_inter.weight", "reset_temp_agg_feat_dim.bias", "project_mlp.2.weight",
        "regression_head.weight"},
        "rulstm": {"temporal_aggregator_after_future_pred.rolling_lstm.weight_ih_l0",
                   "temporal_aggregator_after_future_pred.unrolling_lstm.bias_ih_l0"}}[case]
    assert want <= set(sd)
    back = avt_checkpoint_to_flax({k: v.numpy() for k, v in sd.items()})
    flat_ref = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))


def test_init_statistics_of_the_new_modules():
    H = 256  # the RULSTM's width
    overrides = FEATURES + ["model/temporal_aggregator=rulstm",
                            f"+model.temporal_aggregator.intermediate_featdim={H}",
                            "model/temporal_aggregator_after_future_pred=transformer",
                            "+model.temporal_aggregator_after_future_pred.cloze_loss_ratio=0.2",
                            "model/future_predictor=mlp", "model/classifier=mlp"]
    cfg, _ = _compose(overrides)
    sd = build_model(cfg, NUM_CLASSES, CLASS_MAPPINGS, device="cpu").state_dict()
    w_ih = sd["temporal_aggregator.rolling_lstm.weight_ih_l0"]
    assert w_ih.shape == (4 * H, FEAT)
    assert w_ih.std().item() == pytest.approx(FEAT ** -0.5, rel=0.05)  # lecun-normal
    for gate in sd["temporal_aggregator.unrolling_lstm.weight_hh_l0"].chunk(4):
        torch.testing.assert_close(gate @ gate.t(), torch.eye(H), atol=1e-4, rtol=0)
    assert not sd["temporal_aggregator.rolling_lstm.bias_hh_l0"].any()
    tx = "temporal_aggregator_after_future_pred."
    in_proj = sd[tx + "transformer_encoder.layers.0.self_attn.in_proj_weight"]
    limit = (6 / (512 + 1536)) ** 0.5  # xavier-uniform over (512, 1536)
    assert in_proj.abs().max().item() <= limit
    assert in_proj.std().item() == pytest.approx(limit / 3 ** 0.5, rel=0.02)
    assert sd[tx + "transformer_encoder.layers.0.linear1.weight"].std().item() == \
        pytest.approx(0.01, rel=0.02)
    assert sd[tx + "extra_embeddings.weight"].std().item() == pytest.approx(0.02, rel=0.1)
    assert torch.equal(sd[tx + "transformer_encoder.norm.weight"], torch.ones(512))
    assert sd["future_predictor.model.0.weight"].std().item() == pytest.approx(0.01, rel=0.02)
    assert sd["classifiers.action.model.0.weight"].std().item() == pytest.approx(0.01, rel=0.05)
