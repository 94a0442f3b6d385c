"""JAX package parameters -> the port's state_dict.

The inverse of avt_tpu/models/import_torch.py (`timm_vit_to_flax`,
`gpt2_to_flax`, `transformer_agg_to_flax`, `rulstm_to_flax`,
`avt_checkpoint_to_flax`), kept here as the port's own copy of the name
mapping. The input is a flax parameter tree as nested dicts of numpy arrays
(a `{"params": ...}` wrapper is unwrapped); the output uses the reference's
torch names: timm ViT, HF GPT-2 (Conv1D (in, out) weights), the Transformer
aggregator's nn.TransformerEncoder, RULSTM's nn.LSTM layers,
`future_predictor.model.<2i>`, `classifiers.<task>` (the MLP classifier's
Linears at `classifiers.<task>.model.<2i>`, the port's own names), and
AVTModel's `mapper_to_inter`, `reset_temp_agg_feat_dim`, `project_mlp.{0,2}`
and `regression_head`.

Layout changes: flax Dense kernel (in, out) -> torch Linear weight (out, in);
flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw); LayerNorm
scale -> weight. GPT-2's Conv1D weights keep the flax layout. An LSTM cell's
per-gate kernels are packed [i|f|g|o] into weight_ih_l0 / weight_hh_l0; the
cell's one bias (the JAX cell folds torch's two into its h side) becomes
bias_hh_l0, and bias_ih_l0 is zeros.

The conv backbones (the inverse of `video_resnet_to_flax` and
`bninception_to_flax`) take the whole `{"params", "batch_stats"}` variables:
a video ResNet's convs under torchvision's names, BN-Inception's under
pretrainedmodels'; a conv kernel (kt, kh, kw, I/g, O) or (kh, kw, I, O) goes
to (O, I/g, kt, kh, kw) or (O, I, kh, kw); each BatchNorm's params
`scale`/`bias` to `weight`/`bias` and its batch_stats `mean`/`var` to
`running_mean`/`running_var`. torch's `num_batches_tracked` has no JAX
counterpart and is not emitted.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")  # a writable copy


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x).T)


def _conv_k(x) -> np.ndarray:
    """A flax conv kernel (*k, in, out) as torch's (out, in, *k)."""
    x = _np(x)
    return np.ascontiguousarray(np.transpose(x, (x.ndim - 1, x.ndim - 2, *range(x.ndim - 2))))


def _indices(tree: Mapping, prefix: str):
    return sorted(int(m.group(1)) for k in tree if (m := re.fullmatch(prefix + r"(\d+)", k)))


def _ln(sd: Dict, dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = _np(p["scale"])
    sd[f"{dst}.bias"] = _np(p["bias"])


def _linear(sd: Dict, dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(p["kernel"])
    if "bias" in p:
        sd[f"{dst}.bias"] = _np(p["bias"])


def vit_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu ViT params -> timm vit_base_patch16_224 names."""
    sd: Dict[str, np.ndarray] = {
        "cls_token": _np(p["cls_token"]),
        "pos_embed": _np(p["pos_embed"]),
        "patch_embed.proj.weight": np.ascontiguousarray(
            np.transpose(_np(p["patch_embed"]["kernel"]), (3, 2, 0, 1))),
        "patch_embed.proj.bias": _np(p["patch_embed"]["bias"]),
    }
    for i in _indices(p, "blocks_"):
        src, dst = p[f"blocks_{i}"], f"blocks.{i}"
        _ln(sd, f"{dst}.norm1", src["norm1"])
        _linear(sd, f"{dst}.attn.qkv", src["attn"]["qkv"])
        _linear(sd, f"{dst}.attn.proj", src["attn"]["proj"])
        _ln(sd, f"{dst}.norm2", src["norm2"])
        _linear(sd, f"{dst}.mlp.fc1", src["mlp_fc1"])
        _linear(sd, f"{dst}.mlp.fc2", src["mlp_fc2"])
    _ln(sd, "norm", p["norm"])
    return sd


def _bn(sd: Dict, dst: str, p: Mapping, stats: Optional[Mapping]) -> None:
    """A TorchExactBatchNorm's params (and its batch_stats, when given)."""
    sd[f"{dst}.weight"] = _np(p["scale"])
    sd[f"{dst}.bias"] = _np(p["bias"])
    if stats is not None:
        sd[f"{dst}.running_mean"] = _np(stats["mean"])
        sd[f"{dst}.running_var"] = _np(stats["var"])


def _sub_stats(stats: Optional[Mapping], *path: str) -> Optional[Mapping]:
    for key in path:
        if stats is None:
            return None
        stats = stats.get(key)
    return stats


def _video_resnet_maker(sd: Dict, dst: str, p: Mapping, stats: Optional[Mapping]) -> None:
    """A conv maker's subtree at torch prefix `dst`: a plain conv (`conv`),
    Conv2Plus1D (`conv_s`, `bn_mid`, `conv_t` -> .0, .1, .3) or
    IPConv3DDepthwise (`conv_p`, `bn_mid`, `conv_dw` -> .0, .1, .2)."""
    if "conv" in p:
        sd[f"{dst}.weight"] = _conv_k(p["conv"]["kernel"])
        return
    first, last, idx = (("conv_s", "conv_t", 3) if "conv_s" in p else ("conv_p", "conv_dw", 2))
    sd[f"{dst}.0.weight"] = _conv_k(p[first]["kernel"])
    _bn(sd, f"{dst}.1", p["bn_mid"]["bn"], _sub_stats(stats, "bn_mid", "bn"))
    sd[f"{dst}.{idx}.weight"] = _conv_k(p[last]["kernel"])


def video_resnet_from_jax(p: Mapping, stats: Optional[Mapping] = None
                          ) -> Dict[str, np.ndarray]:
    """avt_tpu VideoResNet params (and batch_stats) -> torchvision's
    VideoResNet names."""
    sd: Dict[str, np.ndarray] = {}

    def bn(dst, name, tree=p, tstats=stats):
        _bn(sd, dst, tree[name]["bn"], _sub_stats(tstats, name, "bn"))

    if "stem_conv1" in p:  # R2Plus1dStem: conv bn relu conv bn relu
        sd["stem.0.weight"] = _conv_k(p["stem_conv1"]["kernel"])
        bn("stem.1", "stem_bn1")
        sd["stem.3.weight"] = _conv_k(p["stem_conv2"]["kernel"])
        bn("stem.4", "stem_bn2")
    else:  # BasicStem[_Pool]: conv bn relu [pool]
        sd["stem.0.weight"] = _conv_k(p["stem_conv"]["kernel"])
        bn("stem.1", "stem_bn")
    for key in sorted(k for k in p if re.fullmatch(r"layer\d_\d+", k)):
        layer, i = key[len("layer"):].split("_")
        src, bstats, dst = p[key], _sub_stats(stats, key), f"layer{layer}.{i}"
        if "conv3" in src:  # Bottleneck: 1x1, maker, 1x1
            sd[f"{dst}.conv1.0.weight"] = _conv_k(src["conv1"]["kernel"])
            _video_resnet_maker(sd, f"{dst}.conv2.0", src["conv2"], _sub_stats(bstats, "conv2"))
            sd[f"{dst}.conv3.0.weight"] = _conv_k(src["conv3"]["kernel"])
            bn(f"{dst}.conv3.1", "bn3", src, bstats)
        else:  # BasicBlock: maker, maker
            _video_resnet_maker(sd, f"{dst}.conv1.0", src["conv1"], _sub_stats(bstats, "conv1"))
            _video_resnet_maker(sd, f"{dst}.conv2.0", src["conv2"], _sub_stats(bstats, "conv2"))
        bn(f"{dst}.conv1.1", "bn1", src, bstats)
        bn(f"{dst}.conv2.1", "bn2", src, bstats)
        if "ds_conv" in src:
            sd[f"{dst}.downsample.0.weight"] = _conv_k(src["ds_conv"]["kernel"])
            bn(f"{dst}.downsample.1", "ds_bn", src, bstats)
    return sd


# BNInceptionVideo's unit names -> pretrainedmodels'
_BNINCEPTION_STEM = (("conv1", "conv1_7x7_s2"), ("conv2r", "conv2_3x3_reduce"),
                     ("conv2", "conv2_3x3"))
_BNINCEPTION_BRANCHES = (("b1", "1x1"), ("b3r", "3x3_reduce"), ("b3", "3x3"),
                         ("bd3r", "double_3x3_reduce"), ("bd3a", "double_3x3_1"),
                         ("bd3b", "double_3x3_2"), ("bpool", "pool_proj"))


def bninception_from_jax(p: Mapping, stats: Optional[Mapping] = None
                         ) -> Dict[str, np.ndarray]:
    """avt_tpu BNInceptionVideo params (and batch_stats) -> pretrainedmodels'
    BNInception names."""
    sd: Dict[str, np.ndarray] = {}

    def unit(tree, tstats, dst):
        sd[f"{dst}.weight"] = _conv_k(tree["conv"]["kernel"])
        sd[f"{dst}.bias"] = _np(tree["conv"]["bias"])
        _bn(sd, f"{dst}_bn", tree["bn"], _sub_stats(tstats, "bn"))

    for src, dst in _BNINCEPTION_STEM:
        unit(p[src], _sub_stats(stats, src), dst)
    for key in sorted(k for k in p if k.startswith("inc_")):
        for src, dst in _BNINCEPTION_BRANCHES:
            if src in p[key]:  # the reduction blocks have no 1x1 nor pool_proj
                unit(p[key][src], _sub_stats(stats, key, src),
                     f"inception_{key[len('inc_'):]}_{dst}")
    return sd


def backbone_from_jax(p: Mapping, stats: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    """A backbone's params: the ViT, a video ResNet or BN-Inception."""
    if "cls_token" in p:
        return vit_from_jax(p)
    if "stem_conv" in p or "stem_conv1" in p:
        return video_resnet_from_jax(p, stats)
    if "inc_3a" in p:
        return bninception_from_jax(p, stats)
    raise NotImplementedError(f"no conversion for a backbone with {sorted(p)[:5]}")


def gpt2_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu GPT2Core params -> HF GPT2Model names (no wte)."""
    sd: Dict[str, np.ndarray] = {"wpe.weight": _np(p["wpe"])}

    def conv1d(dst, q):
        sd[f"{dst}.weight"] = _np(q["kernel"])
        sd[f"{dst}.bias"] = _np(q["bias"])

    for i in _indices(p, "h_"):
        src, dst = p[f"h_{i}"], f"h.{i}"
        _ln(sd, f"{dst}.ln_1", src["ln_1"])
        conv1d(f"{dst}.attn.c_attn", src["attn"]["qkv"])
        conv1d(f"{dst}.attn.c_proj", src["attn"]["proj"])
        _ln(sd, f"{dst}.ln_2", src["ln_2"])
        conv1d(f"{dst}.mlp.c_fc", src["mlp_fc"])
        conv1d(f"{dst}.mlp.c_proj", src["mlp_proj"])
    _ln(sd, "ln_f", p["ln_f"])
    return sd


def encoder_block_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu EncoderBlock params -> nn.TransformerEncoderLayer names."""
    sd: Dict[str, np.ndarray] = {
        "self_attn.in_proj_weight": _t(p["attn"]["qkv"]["kernel"]),
        "self_attn.in_proj_bias": _np(p["attn"]["qkv"]["bias"]),
    }
    _linear(sd, "self_attn.out_proj", p["attn"]["proj"])
    _linear(sd, "linear1", p["ffn_fc"])
    _linear(sd, "linear2", p["ffn_proj"])
    _ln(sd, "norm1", p["ln_1"])
    _ln(sd, "norm2", p["ln_2"])
    return sd


def transformer_agg_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu TransformerAgg params -> the reference Transformer's names.
    The mask embedding exists only when the JAX model was initialised in
    train mode with a cloze ratio; without it none is emitted."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "downproject", p["downproject"])
    for i in _indices(p, "layer_"):
        sd.update(_prefixed(f"transformer_encoder.layers.{i}.",
                            encoder_block_from_jax(p[f"layer_{i}"])))
    _ln(sd, "transformer_encoder.norm", p["norm"])
    if "mask_embed" in p:
        sd["extra_embeddings.weight"] = _np(p["mask_embed"]).reshape(1, -1)
    return sd


def _lstm_from_jax(sd: Dict, dst: str, p: Mapping) -> None:
    sd[f"{dst}.weight_ih_l0"] = np.concatenate([_t(p[f"i{g}"]["kernel"]) for g in "ifgo"])
    sd[f"{dst}.weight_hh_l0"] = np.concatenate([_t(p[f"h{g}"]["kernel"]) for g in "ifgo"])
    bias = np.concatenate([_np(p[f"h{g}"]["bias"]) for g in "ifgo"])
    sd[f"{dst}.bias_ih_l0"] = np.zeros_like(bias)
    sd[f"{dst}.bias_hh_l0"] = bias


def rulstm_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu RULSTMAgg params {rolling, unrolling} -> rolling_lstm.* and
    unrolling_lstm.* (torch nn.LSTM names, gates [i|f|g|o])."""
    sd: Dict[str, np.ndarray] = {}
    _lstm_from_jax(sd, "rolling_lstm", p["rolling"])
    _lstm_from_jax(sd, "unrolling_lstm", p["unrolling"])
    return sd


def agg_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    if "downproject" in p:
        return transformer_agg_from_jax(p)
    if "rolling" in p:
        return rulstm_from_jax(p)
    raise NotImplementedError(f"no conversion for an aggregator with {sorted(p)[:5]}")


def mlp_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """fc_<i> Dense layers (MLPFuture, MLPClassifier) -> a Sequential's
    Linears at model.<2i> (a ReLU between each two)."""
    sd: Dict[str, np.ndarray] = {}
    for i in _indices(p, "fc_"):
        _linear(sd, f"model.{2 * i}", p[f"fc_{i}"])
    return sd


def head_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """A classifier: LinearClassifier's `fc` or MLPClassifier's `fc_<i>`."""
    if "fc" in p:
        sd = {"weight": _t(p["fc"]["kernel"])}
        if "bias" in p["fc"]:
            sd["bias"] = _np(p["fc"]["bias"])
        return sd
    return mlp_from_jax(p)


def avth_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu AVTh params -> the port's AVTh: the linear encoder and
    decoder, or the embedding (`encoder_embed`, cluster-id inputs) as
    `encoder.weight` and the tied `decoder.weight`."""
    sd = {f"gpt_model.{k}": v for k, v in gpt2_from_jax(p["gpt"]).items()}
    if "encoder_embed" in p:
        sd["encoder.weight"] = _np(p["encoder_embed"]["embedding"])
        sd["decoder.weight"] = sd["encoder.weight"]
    else:
        sd["encoder.weight"] = _t(p["encoder"]["kernel"])
        sd["decoder.weight"] = _t(p["decoder"]["kernel"])
    return sd


def _prefixed(prefix: str, sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"{prefix}{k}": v for k, v in sd.items()}


# AVTModel's top-level subtrees besides the classifiers_<task> ones
_AVT_KEYS = ("backbone", "future_predictor", "temporal_aggregator",
             "temporal_aggregator_after_future_pred", "mapper_to_inter",
             "reset_temp_agg_feat_dim", "project_mlp", "regression_head")


def avt_from_jax(p: Mapping, stats: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    """avt_tpu AVTModel params (and the backbone's batch_stats) -> the
    reference BaseModel's names."""
    handled = set(_AVT_KEYS)
    sd: Dict[str, np.ndarray] = {}
    if "backbone" in p:
        sd.update(_prefixed("backbone.model.", backbone_from_jax(
            p["backbone"], _sub_stats(stats, "backbone"))))
    if "future_predictor" in p:
        fp = p["future_predictor"]
        sd.update(_prefixed("future_predictor.",
                            avth_from_jax(fp) if "gpt" in fp else mlp_from_jax(fp)))
    for agg in ("temporal_aggregator", "temporal_aggregator_after_future_pred"):
        if agg in p:
            sd.update(_prefixed(f"{agg}.", agg_from_jax(p[agg])))
    for name in ("mapper_to_inter", "reset_temp_agg_feat_dim", "regression_head"):
        if name in p:
            _linear(sd, name, p[name])
    if "project_mlp" in p:
        _linear(sd, "project_mlp.0", p["project_mlp"]["fc1"])
        _linear(sd, "project_mlp.2", p["project_mlp"]["fc2"])
    for key, sub in p.items():
        m = re.fullmatch(r"classifiers_(.+)", key)
        if m:
            handled.add(key)
            sd.update(_prefixed(f"classifiers.{m.group(1)}.", head_from_jax(sub)))
    leftovers = sorted(set(p) - handled)
    if leftovers:
        raise NotImplementedError(f"no conversion for {leftovers} yet")
    return sd


def params_from_jax(params: Mapping) -> StateDict:
    """A JAX package parameter tree (full AVTModel, ViT, VideoResNet,
    BNInceptionVideo, GPT2Core, AVTh, TransformerAgg, RULSTMAgg,
    EncoderBlock, MLPFuture or MLPClassifier), or its variables
    `{"params": ..., "batch_stats": ...}` (the BatchNorms' running
    statistics), -> the port's state_dict of f32 CPU tensors. An AVTModel
    on the identity backbone (the feature path) has no `backbone` subtree
    and maps to no `backbone.` names."""
    stats = None
    if "params" in params and set(params) <= {"params", "batch_stats"}:
        params, stats = params["params"], params.get("batch_stats")
    if any(k in _AVT_KEYS or k.startswith("classifiers_") for k in params):
        sd = avt_from_jax(params, stats)
    elif "cls_token" in params or "stem_conv" in params or "stem_conv1" in params \
            or "inc_3a" in params:
        sd = backbone_from_jax(params, stats)
    elif "wpe" in params:
        sd = gpt2_from_jax(params)
    elif "gpt" in params:
        sd = avth_from_jax(params)
    elif "downproject" in params or "rolling" in params:
        sd = agg_from_jax(params)
    elif "ffn_fc" in params:
        sd = encoder_block_from_jax(params)
    elif "fc_0" in params:
        sd = mlp_from_jax(params)
    else:
        raise ValueError(f"unrecognised parameter tree (keys {sorted(params)[:5]})")
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Loads a JAX package parameter tree into `model`: strict, but for the
    Transformer aggregator's mask embedding, which a JAX model has only when
    it was initialised in train mode (the model's own draw is kept then),
    and the BatchNorms' `num_batches_tracked`, which JAX does not count."""
    sd = params_from_jax(params)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing
               if not k.endswith(("extra_embeddings.weight", "num_batches_tracked"))]
    if missing or unexpected:
        raise RuntimeError(f"load_jax_params: missing {missing[:5]}, unexpected "
                           f"{unexpected[:5]}")
    return model


# the parameter-shaped trees of optax's states: SGD's trace, Adam's moments,
# Adafactor's factored second moments
_STATE_TREES = ("trace", "mu", "nu", "row", "col", "v")


def _masked(x) -> bool:
    return type(x).__name__ == "MaskedNode"  # optax's leaf for another group's parameter


def _without_batch_stats(tree):
    """A parameter-shaped state tree without its `batch_stats` collection:
    JAX freezes the running statistics (their optimizer state is masked in
    every group), and the port's are buffers, which no optimizer holds."""
    if isinstance(tree, Mapping) and "batch_stats" in tree:
        return {k: v for k, v in tree.items() if k != "batch_stats"}
    return tree


def _merge(trees):
    """One tree from the per-group trees of an optax multi_transform state,
    in each of which the other groups' leaves are masked."""
    if isinstance(trees[0], Mapping):
        return {k: _merge([t[k] for t in trees]) for k in trees[0]}
    real = [t for t in trees if not _masked(t)]
    if not real:
        raise ValueError("a parameter is masked in every group (frozen); its state has no "
                         "counterpart in the port's optimizer")
    return real[0]


def _group_states(state) -> Dict[str, list]:
    """group label -> the optax states (NamedTuples) of that group's chain,
    found through chains (tuples), MaskedState and MultiTransformState."""
    out: Dict[str, list] = {}

    def walk(node, label):
        if hasattr(node, "_fields"):
            if "inner_states" in node._fields:
                for lab, sub in node.inner_states.items():
                    walk(sub, lab)
                return
            out.setdefault(label, []).append(node)
            for f in node._fields:
                if f not in _STATE_TREES:
                    walk(getattr(node, f), label)
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x, label)

    walk(state, None)
    return out


def _factored_from_jax(row: Mapping, col: Mapping, v: Mapping):
    """Adafactor's row / col / v trees -> {port name: tensor} each. A leaf
    the JAX side keeps as a 0-d placeholder is left out. The port factors a
    linear weight, the transpose of the JAX kernel, over its own last two
    axes, so its row and col are JAX's col and row; it factors a conv weight
    in the flax kernel's layout, so its row and col are JAX's own."""
    leaves: list = []

    def probe(node):  # each leaf -> a (2, 3, 4, 5) array holding its index
        if isinstance(node, Mapping):
            return {k: probe(x) for k, x in node.items()}
        leaves.append(node)
        return np.full((2, 3, 4, 5), len(leaves) - 1, np.float32)

    placed = params_from_jax(probe(row))
    n = len(leaves)
    probe(col), probe(v)
    out = {"row": {}, "col": {}, "v": {}}
    for name, x in placed.items():
        if name.endswith("bias_ih_l0"):  # an LSTM's buffer: no optimizer state
            continue
        i = int(x.reshape(-1)[0])
        r, c, full = leaves[i], leaves[n + i], leaves[2 * n + i]
        layout = tuple(x.shape)
        if np.ndim(full) > 0:
            out["v"][name] = torch.from_numpy(_np(full))
        elif layout in ((2, 3, 4, 5), (5, 4, 2, 3)):  # the same layout, or a conv kernel
            out["row"][name], out["col"][name] = (torch.from_numpy(_np(a)) for a in (r, c))
        elif layout == (5, 4, 3, 2) and np.ndim(r) == 1:  # a linear kernel, transposed
            out["row"][name], out["col"][name] = (torch.from_numpy(_np(a)) for a in (c, r))
        else:
            raise NotImplementedError(f"{name}: no conversion of the factored second moments "
                                      f"of a re-laid-out {np.ndim(r) + 1}-d kernel")
    return out


def opt_state_from_jax(state) -> dict:
    """The state of avt_tpu's `build_optimizer` transformation (an optax
    multi_transform, optionally behind gradient clipping) -> the port
    optimizer's state, for its `load_state_dict` (which rounds into each
    buffer's own type): the step count, SGD's `momentum`, Adam's and AdamW's
    `mu` and `nu`, Adafactor's `row`, `col` and `v`, each as {parameter
    name: f32 tensor}, and each group's plateau multiplier (`{"plateau":
    {group label: mult}}`). Parameter trees have the parameters' layout, so
    `params_from_jax`'s re-layout applies. A frozen parameter has no state
    in optax and raises."""
    groups = {k: v for k, v in _group_states(state).items() if k not in (None, "frozen")}
    found: Dict[str, list] = {}
    out: dict = {"plateau": {}}
    count = None
    for label, states in groups.items():
        for st in states:
            for f in _STATE_TREES:
                if f in st._fields:
                    found.setdefault(f, []).append(_without_batch_stats(getattr(st, f)))
            if "mult" in st._fields:
                out["plateau"][label] = float(np.asarray(st.mult))
            if count is None and "count" in st._fields:  # the chain's counts move together
                count = int(np.asarray(st.count))
    out["count"] = int(count or 0)
    if "trace" in found:
        out["momentum"] = params_from_jax(_merge(found["trace"]))
    for f in ("mu", "nu"):
        if f in found:
            out[f] = params_from_jax(_merge(found[f]))
    if "row" in found:
        out.update(_factored_from_jax(*(_merge(found[f]) for f in ("row", "col", "v"))))
    return out
