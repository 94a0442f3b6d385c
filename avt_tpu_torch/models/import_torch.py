"""Partial model init from torch checkpoints (`train.init_from_model`).

Counterpart of avt_tpu/models/import_torch.py (`load_torch_state_dict`,
`merge_params`, `init_from_model`), itself the reference's init_model
(func/train.py:457-497, 669-688). The port's parameters keep the
reference's torch names (timm ViT under `backbone.model.`, HF GPT-2 under
`future_predictor.gpt_model.`, `classifiers.<task>`), so a checkpoint loads
by name with no layout change. What loads is what the JAX package's
converters load: for each layout, the same leaves are taken from the file
(timm's `head.*` and `pre_logits.*`, which `timm_vit_to_flax` never
converts, are dropped; so are HF GPT-2's `wte` and attention masks), each
is copied where the model has that name at that shape (cast to the
model's dtype), and a shape mismatch or an unknown name is skipped with a
warning. The spec forms, the module names and every error are JAX's.

Layouts read: a reference AVT checkpoint (`backbone.`, `future_predictor.`,
`classifiers.` keys, a Transformer or RULSTM aggregator under
`temporal_aggregator.` and `temporal_aggregator_after_future_pred.`), which
is also the port's own run checkpoint (`<run>/checkpoint`,
train/checkpoint.py's `{"model": state_dict, ...}`); a raw timm ViT; a raw
HF GPT-2; an original RULSTM checkpoint (`rolling_lstm.*` and
`unrolling_lstm.*`, bare nn.LSTM layers or OpenLSTM's `.lstm.` nesting;
its classifier is taken only by a prefix spec, as a bare Linear); a bare
`nn.Linear`; pretrainedmodels' BN-Inception (`conv1_7x7_s2.weight`, its
`last_linear` dropped); a torchvision video ResNet (`stem.0.weight`, its
`fc` dropped); a VISSL trunk (`_feature_blocks.` keys inside
`classy_state_dict`, unwrapped). The conv layouts load their convs and each
BatchNorm's weight, bias and running statistics (not `num_batches_tracked`,
which JAX does not hold). An LSTM's tensors load as the file holds them
(both biases; the JAX package folds them into one, which sums to the same
gates). A directory is an avt_tpu (orbax) checkpoint, which the port does
not read.

One layout loads here that the JAX package refuses: an AVT checkpoint whose
`backbone.model.` holds a conv backbone (the port's own run checkpoint of
such a model) loads it by name, where `avt_checkpoint_to_flax` reads
`backbone.model.` only as a timm ViT.
"""
from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

LOG = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]

_VIT_BLOCK = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
              "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
              "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
_GPT2_BLOCK = ("ln_1.weight", "ln_1.bias", "attn.c_attn.weight", "attn.c_attn.bias",
               "attn.c_proj.weight", "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
               "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")


def _tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def load_torch_state_dict(fpath: str) -> StateDict:
    """A torch checkpoint's state_dict, unwrapped from the reference's
    formats (func/train.py:467-477): a raw state_dict, {'model': sd} (also
    the port's own run checkpoint), {'state_dict': sd} or VISSL's
    {'classy_state_dict': ...}."""
    obj = torch.load(fpath, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        if "classy_state_dict" in obj:
            obj = obj["classy_state_dict"]["base_model"]["model"]["trunk"]
        elif "model" in obj and isinstance(obj["model"], dict):
            obj = obj["model"]
        elif "state_dict" in obj:
            obj = obj["state_dict"]
    return {k: _tensor(v) for k, v in obj.items()}


def _depth(sd: Mapping, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def timm_vit_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The leaves of a timm ViT state_dict that `timm_vit_to_flax` takes
    (the classifier `head.*` and `pre_logits.*` are not among them); a
    missing one raises KeyError, as there."""
    out = {k: sd[k] for k in ("cls_token", "pos_embed", "patch_embed.proj.weight",
                              "patch_embed.proj.bias")}
    for i in range(_depth(sd, r"blocks\.(\d+)\.")):
        out.update({f"blocks.{i}.{n}": sd[f"blocks.{i}.{n}"] for n in _VIT_BLOCK})
    out.update({k: sd[k] for k in ("norm.weight", "norm.bias")})
    return out


def gpt2_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The leaves of an HF GPT2Model state_dict that `gpt2_to_flax` takes
    (not `wte` nor the attention masks)."""
    out = {"wpe.weight": sd["wpe.weight"]}
    for i in range(_depth(sd, r"h\.(\d+)\.")):
        out.update({f"h.{i}.{n}": sd[f"h.{i}.{n}"] for n in _GPT2_BLOCK})
    out.update({k: sd[k] for k in ("ln_f.weight", "ln_f.bias")})
    return out


_LSTM = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
_ENCODER_LAYER = ("self_attn.in_proj_weight", "self_attn.in_proj_bias",
                  "self_attn.out_proj.weight", "self_attn.out_proj.bias", "linear1.weight",
                  "linear1.bias", "linear2.weight", "linear2.bias", "norm1.weight",
                  "norm1.bias", "norm2.weight", "norm2.bias")


def rulstm_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The LSTM leaves of an original RULSTM state_dict that `rulstm_to_flax`
    takes, under the port's names (OpenLSTM's `.lstm.` nesting removed);
    the classifier is not among them."""
    sd = {k.replace(".lstm.", "."): v for k, v in sd.items()}
    return {f"{lstm}.{n}": sd[f"{lstm}.{n}"]
            for lstm in ("rolling_lstm", "unrolling_lstm") for n in _LSTM}


def transformer_agg_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The leaves of the reference's Transformer aggregator that
    `transformer_agg_to_flax` takes (not the positional table)."""
    keys = ["downproject.weight", "downproject.bias", "transformer_encoder.norm.weight",
            "transformer_encoder.norm.bias"]
    i = 0
    while f"transformer_encoder.layers.{i}.self_attn.in_proj_weight" in sd:
        keys += [f"transformer_encoder.layers.{i}.{n}" for n in _ENCODER_LAYER]
        i += 1
    if "extra_embeddings.weight" in sd:
        keys.append("extra_embeddings.weight")
    return {k: sd[k] for k in keys}


def conv_backbone_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The leaves of a conv backbone's file that `video_resnet_to_flax` and
    `bninception_to_flax` take: every tensor but the classifier
    (torchvision's `fc`, pretrainedmodels' `last_linear`) and the
    BatchNorms' `num_batches_tracked`, which JAX does not hold. A VISSL
    trunk's `_feature_blocks.` prefix is removed first."""
    if any(k.startswith("_feature_blocks.") for k in sd):
        sd = _sub(sd, "_feature_blocks.")
    return {k: v for k, v in sd.items()
            if not k.startswith(("fc.", "last_linear.")) and not k.endswith("num_batches_tracked")}


def backbone_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A backbone's leaves by its layout: video ResNet, BN-Inception or timm
    ViT."""
    if "stem.0.weight" in sd or "conv1_7x7_s2.weight" in sd:
        return conv_backbone_leaves(sd)
    return timm_vit_leaves(sd)


def _sub(sd: Mapping, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _with_prefix(prefix: str, sd: Mapping) -> StateDict:
    return {prefix + k: v for k, v in sd.items()}


def avt_checkpoint_leaves(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The leaves of a reference AVT state_dict that `avt_checkpoint_to_flax`
    converts, under the port's names."""
    out: StateDict = {}
    backbone = _sub(sd, "backbone.model.")
    if backbone:
        out.update(_with_prefix("backbone.model.", backbone_leaves(backbone)))
    gpt = _sub(sd, "future_predictor.gpt_model.")
    if gpt:
        out.update(_with_prefix("future_predictor.gpt_model.", gpt2_leaves(gpt)))
    if "future_predictor.encoder.weight" in sd:
        enc = sd["future_predictor.encoder.weight"]
        dec = sd.get("future_predictor.decoder.weight")
        if enc.ndim == 2 and dec is not None:
            # linear encoder and decoder, or an nn.Embedding with the decoder
            # tied to it (cluster-id inputs): the port's AVT-h has both names
            out["future_predictor.encoder.weight"] = enc
            out["future_predictor.decoder.weight"] = dec
    for key, val in sd.items():
        # the MLP future predictor's Linears and the classifiers, as JAX's
        # converter matches them
        if re.match(r"future_predictor\.model\.(\d+)\.(weight|bias)", key):
            out[key] = val
        m = re.match(r"classifiers\.([^.]+)\.(weight|bias)", key)
        if m:
            out[f"classifiers.{m.group(1)}.{m.group(2)}"] = val
    for name in ("mapper_to_inter", "reset_temp_agg_feat_dim"):
        for kind in ("weight", "bias"):
            if f"{name}.{kind}" in sd:
                out[f"{name}.{kind}"] = sd[f"{name}.{kind}"]
    for src in ("project_mlp.0", "project_mlp.2", "regression_head"):
        if f"{src}.weight" in sd:
            out[f"{src}.weight"] = sd[f"{src}.weight"]
            out[f"{src}.bias"] = sd[f"{src}.bias"]
    for agg in ("temporal_aggregator", "temporal_aggregator_after_future_pred"):
        sub = _sub(sd, agg + ".")
        if not sub:
            continue
        if "downproject.weight" in sub:
            out.update(_with_prefix(agg + ".", transformer_agg_leaves(sub)))
        elif any("rolling_lstm" in k for k in sub):
            out.update(_with_prefix(agg + ".", rulstm_leaves(sub)))
        else:
            LOG.warning("Unrecognized %s. layout: %s", agg, sorted(sub)[:5])
    handled = {"backbone", "future_predictor", "classifiers", "mapper_to_inter",
               "reset_temp_agg_feat_dim", "project_mlp", "regression_head",
               "temporal_aggregator", "temporal_aggregator_after_future_pred",
               "cls_map_verb_action", "cls_map_noun_action"}
    leftovers = sorted({k.split(".")[0] for k in sd} - handled)
    if leftovers:
        LOG.warning("avt checkpoint: no conversion for module(s) %s; they keep the model's "
                    "init", leftovers)
    return out


def convert_checkpoint(sd: Mapping[str, torch.Tensor]) -> Tuple[StateDict, bool]:
    """Detects the checkpoint's layout, as the JAX package's
    `_convert_checkpoint` does. Returns (its leaves, whether they are a
    whole model's or one module's)."""
    keys = set(sd)
    if any(k.startswith(("backbone.", "future_predictor.", "classifiers.", "mapper_to_inter.",
                         "reset_temp_agg_feat_dim.")) for k in keys):
        return avt_checkpoint_leaves(sd), True
    if "cls_token" in keys and "patch_embed.proj.weight" in keys:
        return timm_vit_leaves(sd), False
    if "wpe.weight" in keys:
        return gpt2_leaves(sd), False
    if "conv1_7x7_s2.weight" in keys:  # pretrainedmodels BN-Inception
        return conv_backbone_leaves(sd), False
    if any("rolling_lstm" in k for k in keys):
        return rulstm_leaves(sd), False
    if "stem.0.weight" in keys or "_feature_blocks.stem.0.weight" in keys:
        return conv_backbone_leaves(sd), False  # torchvision or VISSL video ResNet
    if "weight" in keys and keys <= {"weight", "bias"}:  # a bare nn.Linear
        return {k: sd[k] for k in ("weight", "bias") if k in sd}, False
    raise ValueError(f"init_from_model: unrecognized checkpoint layout (keys like "
                     f"{sorted(keys)[:5]})")


def merge_params(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                 prefix: str = "") -> StateDict:
    """`target` with each leaf of `source` (named relative to `prefix`) in
    place of the target's of that name and shape, cast to the target's
    dtype. A shape mismatch is skipped with a warning (func/train.py:489-494:
    'removing keys ... since size mismatch'), an unknown name too."""
    out = dict(target)
    for key, val in source.items():
        name = prefix + key
        if name not in out:
            LOG.warning("Unexpected key %s in checkpoint; skipped", name)
            continue
        tgt = out[name]
        if tuple(tgt.shape) != tuple(val.shape):
            LOG.warning("Shape mismatch at %s: ckpt %s vs model %s; skipped", name,
                        tuple(val.shape), tuple(tgt.shape))
            continue
        out[name] = val.to(dtype=tgt.dtype)
    return out


def _module_to_flax_name(module: str) -> str:
    """The JAX package's parameter subtree of a reference module path:
    'backbone.model' and 'backbone' -> 'backbone', 'classifiers.<task>' ->
    'classifiers_<task>', anything else as it is."""
    if module in ("backbone.model", "backbone"):
        return "backbone"
    m = re.match(r"^classifiers\.(.+)$", module)
    if m:
        return f"classifiers_{m.group(1)}"
    return module


def _flax_name(port_name: str) -> str:
    """The JAX package's top-level subtree that holds a port parameter."""
    if port_name.startswith("backbone.model."):
        return "backbone"
    m = re.match(r"^classifiers\.([^.]+)\.", port_name)
    if m:
        return f"classifiers_{m.group(1)}"
    return port_name.split(".")[0]


def _port_prefix(flax_name: str) -> str:
    if flax_name == "backbone":
        return "backbone.model."
    if flax_name.startswith("classifiers_"):
        return f"classifiers.{flax_name[len('classifiers_'):]}."
    return flax_name + "."


def init_from_model(model: torch.nn.Module, specs, loader=load_torch_state_dict) -> List[str]:
    """Loads the checkpoints of `specs` into `model` in place, in order
    (func/train.py:669-688); returns the names of the parameters loaded.

    specs: a list of [path], [module, path] or [module, ckpt_prefix, path];
    module names are the reference's torch paths ('backbone.model',
    'classifiers.action'), None or '' for the whole model; ckpt_prefix is
    stripped from the checkpoint's keys first. A spec that cannot resolve
    raises: a requested pretrained init that silently does not happen is
    the worst outcome."""
    state = model.state_dict()
    merged = dict(state)
    for spec in specs:
        if len(spec) == 1:
            module, ckpt_prefix, path = None, None, spec[0]
        elif len(spec) == 2:
            module, ckpt_prefix, path = spec[0], None, spec[1]
        else:
            module, ckpt_prefix, path = spec
        if os.path.isdir(str(path)):
            raise ValueError(
                f"init_from_model: {path} is a directory, an avt_tpu (orbax) checkpoint; the "
                "port reads torch checkpoints, its own run's is the file <run>/checkpoint")
        sd = loader(path)
        if ckpt_prefix:
            sd = _sub(sd, ckpt_prefix)
            if not sd:
                raise ValueError(f"init_from_model: prefix {ckpt_prefix!r} matches no keys in "
                                 f"{path}")
        leaves, is_full_tree = convert_checkpoint(sd)
        if not leaves:
            raise ValueError(f"init_from_model: nothing converted from {path} "
                             f"(spec module={module!r})")
        if module:
            flax_name = _module_to_flax_name(module)
            present = sorted({_flax_name(n) for n in merged})
            if flax_name not in present:
                raise KeyError(f"init_from_model: module {module!r} (flax {flax_name!r}) not in "
                               f"model params {present}")
            prefix = _port_prefix(flax_name)
            sub = _sub(leaves, prefix) if is_full_tree else leaves
            if is_full_tree and not sub:
                sub = leaves  # the JAX package merges the whole tree then
            merged = merge_params(merged, sub, prefix)
        else:
            if not is_full_tree:
                raise ValueError(f"init_from_model: {path} is a module-level checkpoint; give "
                                 "the spec a module name to load it into")
            merged = merge_params(merged, leaves)
    loaded = [k for k in state if merged[k] is not state[k]]
    with torch.no_grad():
        for k in loaded:
            state[k].copy_(merged[k])
    LOG.info("init_from_model: %d of %d tensors loaded from %s", len(loaded), len(state),
             [str(s[-1]) for s in specs])
    return loaded
