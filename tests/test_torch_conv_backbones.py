"""The conv backbones against avt_tpu on the CPU, with avt_tpu's weights and
running statistics carried by `params_from_jax`, in f32 at 2e-4: a video
ResNet of one block a stage for each stem, block and conv maker (r3d,
r(2+1)d with both blocks, ir-CSN, ip-CSN) in train mode (outputs, the
running statistics the forward leaves), then in eval mode on those
statistics (outputs, every parameter's gradient); every parameter's
gradient in train mode, of those nets and of BN-Inception, with the ReLUs
of both packages made softplus (below); r2plus1d_18 and BN-Inception
whole at odd inputs, where the stride-2 ceil-mode pools and the padded
convs meet odd sizes (train-mode outputs and the running statistics they
leave, then eval outputs); the seven factories' parameter and buffer
names and shapes against `jax.eval_shape` of avt_tpu's, with no full-size
forward; the init statistics; the weight-decay groups under
`bias_bn_wd_scale` against avt_tpu's `/bn` rule; one train step of an
AVTModel on a video ResNet through `make_train_step` against avt_tpu's
step, running statistics included; and the port's own checkpoint of a
conv model, which loads by its names.

Train-mode gradients through a ReLU are not comparable between two f32
programs: train-mode BatchNorm puts every channel at mean 0 and variance
1, so some ReLU inputs lie within f32 rounding of 0, and one that flips
moves a weight's gradient by one position's share of its sum. Larger
inputs hold more such values, so they flip more. Against the port's own
float64 forward and backward (one block a stage, with ReLU), the largest
gradient error, as a share of its parameter's largest gradient: at
(2, 3, 4, 33, 33), r(2+1)D basic 0.0237 (port) and 0.0374 (avt_tpu), r(2+1)D
bottleneck 5.8e-6 and 0.213; at (8, 3, 4, 65, 65), 0.0932 and 0.272
(ip-CSN), with r3d's at 0.0071 and 0.0265. With softplus in place of ReLU
in both, every case, BN-Inception's too, holds 3.5e-5 between them at
(2, 3, 4, 33, 33). So the train-mode gradients are held with softplus, and
the ReLU nets' gradients in eval mode. A conv bias ahead of a train-mode
BatchNorm (BN-Inception's) gets no gradient, since the BatchNorm takes the
mean out: both packages' values are held to 0 at 2e-4 of its kernel's
largest gradient.

BN-Inception's train-mode output is ill-conditioned at few frames: its
late stages normalise 1 x 1 maps over the batch's frames alone. Against
the port's float64 forward its largest error is 9.7e-4 (port) and 1.56e-3
(avt_tpu) of a largest output of 1.73 at (1, 3, 4, 33, 33), and 9.7e-5 and
2.54e-4 of 2.94 at (2, 3, 8, 65, 65), where it is held, as a share of the
largest output.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen
import jax
import jax.numpy as jnp

import avt_tpu.models.video_resnet as jvr
from avt_tpu.models import (
    AVTModel as JAVTModel,
    IdentityAgg as JIdentityAgg,
    IdentityFuture as JIdentityFuture,
    LinearClassifier as JLinearClassifier,
    MeanAgg as JMeanAgg,
)
from avt_tpu.models.bninception import BNInceptionVideo as JBNInceptionVideo
from avt_tpu.train import TrainState
from avt_tpu.train import make_train_step as jmake_train_step
from avt_tpu.train import optim as joptim
from avt_tpu.train.optim import build_optimizer as jbuild_optimizer
import avt_tpu_torch.models.convert as convert
import avt_tpu_torch.models.video_resnet as tvr
from avt_tpu_torch.models import (
    AVTModel,
    BNInceptionVideo,
    IdentityAgg,
    IdentityFuture,
    LinearClassifier,
    MeanAgg,
)
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.models.flagship import init_conv_backbone
from avt_tpu_torch.models.import_torch import init_from_model
from avt_tpu_torch.train import CKPT_NAME, build_optimizer, make_train_step, save_checkpoint

TOL = 2e-4  # f32: the same math summed in another order
X_SHAPE = (2, 3, 4, 33, 33)  # batch 2: train-mode BatchNorm over 2 clips
ODD = {"r2plus1d_18": (1, 3, 4, 33, 33), "bninception": (2, 3, 8, 65, 65)}
# stem, block, conv maker
CASES = {
    "r3d": ("basic", "BasicBlock3D", "Conv3DSimple"),
    "r2plus1d": ("r2plus1d", "BasicBlock3D", "Conv2Plus1D"),
    "r2plus1d_bottleneck": ("r2plus1d", "Bottleneck3D", "Conv2Plus1D"),
    "ir_csn": ("basic_pool", "Bottleneck3D", "Conv3DDepthwise"),
    "ip_csn": ("basic_pool", "Bottleneck3D", "IPConv3DDepthwise"),
}


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


def _small(case):
    stem, block, maker = CASES[case]
    jm = jvr.VideoResNet(block=getattr(jvr, block), conv_maker=getattr(jvr, maker),
                         layers=(1, 1, 1, 1), stem=stem)
    tm = tvr.VideoResNet(getattr(tvr, block), getattr(tvr, maker), (1, 1, 1, 1), stem,
                         device="cpu")
    return jm, tm


def _running_stats(sd):
    return {k: v for k, v in sd.items() if "running" in k}


@pytest.mark.parametrize("case", list(CASES))
def test_video_resnet_blocks_match_avt_tpu(case):
    """Every stem, block and conv maker, one block a stage: a train-mode
    forward (outputs, the running statistics it leaves), then eval mode on
    those statistics (outputs, and every parameter's gradient of sum(out *
    w), w a seeded projection)."""
    jm, tm = _small(case)
    x = _rand(X_SHAPE, 0)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    load_jax_params(tm, variables)
    jout, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm.train()(torch.from_numpy(x))
    _close(out, jout, "train output")
    stats = mut["batch_stats"]
    sd = tm.state_dict()
    for name, value in _running_stats(params_from_jax(
            {"params": variables["params"], "batch_stats": stats})).items():
        _close(sd[name], value, name)
    assert all(sd[k].item() == 1 for k in sd if k.endswith("num_batches_tracked"))

    def loss(params, w):
        out = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
        return jnp.sum(out * w), out

    w = _rand(tuple(out.shape), 2)
    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"],
                                                                      jnp.asarray(w))
    out = tm.eval()(torch.from_numpy(x))
    _close(out, ref, "eval output")
    (out * torch.from_numpy(w)).sum().backward()
    jgrads = params_from_jax(grads)
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _scaled_close(p.grad, jgrads[name], f"d{name}")


def _softplus_activations(monkeypatch):
    """Every ReLU of both packages' conv backbones made softplus: flax's
    `nn.relu`, and torch's `relu` and `F.relu` (which `nn.ReLU` calls)."""
    monkeypatch.setattr(flax.linen, "relu", jax.nn.softplus)
    monkeypatch.setattr(torch, "relu", F.softplus)
    monkeypatch.setattr(F, "relu", lambda x, inplace=False: F.softplus(x))


@pytest.mark.parametrize("case", list(CASES) + ["bninception"])
def test_train_mode_gradients_match_avt_tpu(case, monkeypatch):
    """Every parameter's gradient of sum(out * w) through a train-mode
    forward (BatchNorm on the batch's statistics), w a seeded projection,
    with softplus for ReLU in both packages (module docstring): each stem,
    block and conv maker at one block a stage, and BN-Inception whole. A
    conv bias ahead of a BatchNorm is held to 0 at the scale of its
    kernel's gradient."""
    _softplus_activations(monkeypatch)
    if case == "bninception":
        jm, tm = JBNInceptionVideo(), BNInceptionVideo(device="cpu")
    else:
        jm, tm = _small(case)
    x_np = _rand(X_SHAPE, 5)
    x = jnp.asarray(x_np)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(6), x)
    load_jax_params(tm, variables)

    def loss(params, w):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), out

    out = tm.train()(torch.from_numpy(x_np))
    w = _rand(tuple(out.shape), 7)
    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"],
                                                                      jnp.asarray(w))
    _scaled_close(out, ref, "train output")
    (out * torch.from_numpy(w)).sum().backward()
    jgrads = params_from_jax(grads)
    params = dict(tm.named_parameters())
    assert set(jgrads) == set(params)
    for name, p in params.items():
        kernel = name[:-len("bias")] + "weight"
        if name.endswith(".bias") and name[:-len(".bias")] + "_bn.bias" in params:
            scale = np.abs(_f32(jgrads[kernel])).max()
            for side, g in (("port", p.grad), ("avt_tpu", jgrads[name])):
                err = np.abs(_f32(g)).max() / scale
                assert err <= TOL, f"d{name} ({side}): {err:.3g} of d{kernel}'s scale"
        else:
            _scaled_close(p.grad, jgrads[name], f"d{name}")


@pytest.mark.parametrize("which", ["r2plus1d_18", "bninception"])
def test_whole_backbones_at_an_odd_input_match_avt_tpu(which):
    """r2plus1d_18 whole at (1, 3, 4, 33, 33) and BN-Inception at (2, 3, 8,
    65, 65): the train-mode output and the running statistics it leaves,
    then the eval output on them."""
    if which == "bninception":
        jm, tm = JBNInceptionVideo(), BNInceptionVideo(device="cpu")
    else:
        jm, tm = jvr.r2plus1d_18(), tvr.r2plus1d_18(device="cpu")
    x = _rand(ODD[which], 2)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    load_jax_params(tm, variables)
    jout, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm.train()(torch.from_numpy(x))
    _scaled_close(out, jout, "train output")
    sd = tm.state_dict()
    for name, value in _running_stats(params_from_jax(
            {"params": variables["params"], "batch_stats": mut["batch_stats"]})).items():
        _close(sd[name], value, name)
    ref = jax.jit(jm.apply)({"params": variables["params"], **mut}, jnp.asarray(x))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    assert out.shape == ((2, 1024, 8, 1, 1) if which == "bninception" else (1, 512, 1, 3, 3))
    _close(out, ref, "eval output")


def _shape_only(monkeypatch):
    """convert's array helpers on shapes alone (zero-stride arrays), so that
    a full-size tree converts without its values."""
    def np_(x):
        return np.broadcast_to(np.float32(0), np.shape(x))

    def conv_k(x):
        s = np.shape(x)
        return np.broadcast_to(np.float32(0), (s[-1], s[-2], *s[:-2]))

    monkeypatch.setattr(convert, "_np", np_)
    monkeypatch.setattr(convert, "_conv_k", conv_k)


@pytest.mark.parametrize("factory", sorted(tvr.VIDEO_RESNETS) + ["BNInceptionVideo"])
def test_factories_have_avt_tpu_names_and_shapes(factory, monkeypatch):
    """Each factory's parameters and buffers, named and shaped as avt_tpu's
    converter maps `jax.eval_shape` of its init (the port's model on the
    meta device: no values either side)."""
    if factory == "BNInceptionVideo":
        jm, tm = JBNInceptionVideo(), BNInceptionVideo(device="meta")
    else:
        jm, tm = getattr(jvr, factory)(), tvr.VIDEO_RESNETS[factory](device="meta")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 3, 4, 64, 64), jnp.float32))
    _shape_only(monkeypatch)
    want = {k: v.shape for k, v in convert.backbone_from_jax(
        shapes["params"], shapes["batch_stats"]).items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    assert tm.output_dim == (1024 if factory == "BNInceptionVideo" else
                             512 if factory in ("r3d_18", "r2plus1d_18", "r2plus1d_34") else 2048)
    if factory == "ip_csn_50":  # the factory's eps
        assert {m.eps for m in tm.modules() if isinstance(m, torch.nn.BatchNorm3d)} == {0.3}


def test_init_statistics():
    """The draw of avt_tpu's initialisers: the video ResNets' convs
    N(0, 2 / fan_out) (torchvision's kaiming_normal_; a depthwise conv's
    fan_out is O * 27), BN-Inception's flax lecun-normal (a normal cut at 2
    std, scaled to variance 1 / fan_in) with zero biases, every BatchNorm at
    weight 1, bias 0, running mean 0, running var 1."""
    gen = torch.Generator().manual_seed(0)
    for tm in (_small("ir_csn")[1], BNInceptionVideo(device="cpu")):
        init_conv_backbone(tm, gen)
        for name, mod in tm.named_modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                for t, v in ((mod.weight, 1), (mod.bias, 0), (mod.running_mean, 0),
                             (mod.running_var, 1)):
                    assert torch.equal(t, torch.full_like(t, v)), name
            elif isinstance(mod, (torch.nn.Conv3d, torch.nn.Conv2d)):
                w = mod.weight
                if isinstance(mod, torch.nn.Conv3d):
                    std = (2 / (w.shape[0] * w[0, 0].numel())) ** 0.5
                else:
                    std = w[0].numel() ** -0.5
                    assert not mod.bias.any(), name
                    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7, name
                if w.numel() >= 4096:  # enough values for their moments
                    assert w.mean().abs().item() < 0.05 * std, name
                    assert w.std().item() == pytest.approx(std, rel=0.05), name


def _avt_models(backbone):
    """A small AVTModel on a BatchNorm backbone in both packages: mean
    aggregator, identity future, a linear classifier of 7 actions."""
    if backbone == "bninception":
        jb, tb, dim = JBNInceptionVideo(), BNInceptionVideo(device="cpu"), 1024
    else:
        jb, tb = _small("r2plus1d")
        dim = 512
    jm = JAVTModel(backbone=jb, temporal_aggregator=JMeanAgg(in_features=dim),
                   future_predictor=JIdentityFuture(in_features=dim),
                   temporal_aggregator_after_future_pred=JIdentityAgg(in_features=dim),
                   classifiers={"action": JLinearClassifier(out_features=7)},
                   num_classes=(("action", 7),), backbone_dim=dim)
    tm = AVTModel(backbone=tb, temporal_aggregator=MeanAgg(dim),
                  future_predictor=IdentityFuture(dim),
                  temporal_aggregator_after_future_pred=IdentityAgg(dim),
                  classifiers={"action": LinearClassifier(dim, 7, device="cpu")},
                  num_classes=(("action", 7),), backbone_dim=dim)
    return jm, tm


@pytest.mark.parametrize("backbone", ["r2plus1d", "bninception"])
def test_weight_decay_groups_follow_avt_tpu(backbone, monkeypatch):
    """bias_bn_wd_scale applies to the parameters avt_tpu's `/bn` rule
    picks (`_is_bias_or_norm` on its parameter paths, carried to the
    port's names): every BatchNorm weight and bias, and the conv biases."""
    jm, tm = _avt_models(backbone)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 1, 3, 2, 33, 33), jnp.float32))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    marked = {path: joptim._is_bias_or_norm("params/" + joptim._path_str(path), leaf)
              for path, leaf in flat}
    # the port's name of each path: convert (with no re-layout) a tree whose
    # leaves hold the mark
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, float(marked[path]), np.float32),
        shapes["params"])
    monkeypatch.setattr(convert, "_np", lambda x: np.asarray(x, np.float32))
    monkeypatch.setattr(convert, "_conv_k", lambda x: np.asarray(x, np.float32))
    want = {k for k, v in params_from_jax(tree).items() if v.flatten()[0] == 1}
    opt, _ = build_optimizer(tm, [["__all__", 0.1, 1e-2]], iters_per_epoch=1, num_epochs=1,
                             bias_bn_wd_scale=0.5)
    assert {n for g in opt.groups if g.weight_decay == 5e-3 for n in g.names} == want


def test_bn_train_step_matches_avt_tpu():
    """One `make_train_step` step of an AVTModel on a video ResNet (SGD with
    momentum, weight decay 1e-2, bias_bn_wd_scale 0.5): the loss, every
    parameter and every running statistic after it; the optimizer never
    touches the statistics."""
    jm, tm = _avt_models("r2plus1d")
    video = _rand((2, 1, 3, 4, 33, 33), 4)
    target = {"action": np.array([1, 5], np.int32)}
    variables = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(5), jnp.asarray(video),
                                                   (2,))
    load_jax_params(tm, variables)
    kw = dict(lr_wd=[["__all__", 0.1, 1e-2]], optimizer_name="sgd", scheduler_name="constant",
              iters_per_epoch=1, num_epochs=1, bias_bn_wd_scale=0.5,
              optimizer_kwargs={"momentum": 0.9})
    loss_wts = {"cls_action": 1.0}
    tx, _ = jbuild_optimizer(variables, **kw)
    jstep = jmake_train_step(jm, tx, loss_wts, {"action": 7}, donate=False)
    state, jmetrics = jstep(TrainState.create(variables, tx),
                            {"video": jnp.asarray(video),
                             "target": {k: jnp.asarray(v) for k, v in target.items()}},
                            jax.random.PRNGKey(6))
    opt, _ = build_optimizer(tm, **kw)
    metrics = make_train_step(tm, opt, loss_wts, {"action": 7})(
        {"video": torch.from_numpy(video),
         "target": {k: torch.from_numpy(v).long() for k, v in target.items()}})
    _scaled_close(metrics["loss"], jmetrics["loss"], "loss")
    ref = params_from_jax(state.params)
    sd = tm.state_dict()
    assert set(ref) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for name, value in ref.items():
        _close(sd[name], value, name)
    held = {id(p) for g in opt.groups for p in g.params}
    assert not any(id(b) in held for b in tm.buffers())


def test_own_checkpoint_of_a_conv_model_loads_by_name(tmp_path):
    """The port's run checkpoint of an AVTModel on a video ResNet loads back
    whole through `init_from_model`, running statistics included (avt_tpu
    reads a checkpoint's `backbone.model.` only as a timm ViT)."""
    _, src = _avt_models("r2plus1d")
    init_conv_backbone(src.backbone["model"], torch.Generator().manual_seed(7))
    with torch.no_grad():
        src.train()(torch.from_numpy(_rand((2, 1, 3, 4, 33, 33), 8)))  # moves the statistics
    opt, _ = build_optimizer(src, [["__all__", 0.1, 0.0]], iters_per_epoch=1, num_epochs=1)
    save_checkpoint(str(tmp_path), src, opt, epoch=1.0)
    path = str(tmp_path / CKPT_NAME)
    _, dst = _avt_models("r2plus1d")
    loaded = init_from_model(dst, [[path]])
    want, got = src.state_dict(), dst.state_dict()
    assert set(loaded) == {k for k in want if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(got[k], want[k]) for k in loaded)
