"""JAX package parameters -> the port's state_dict.

The inverse of avt_tpu/models/import_torch.py (`timm_vit_to_flax`,
`gpt2_to_flax`, `avt_checkpoint_to_flax`), kept here as the port's own copy
of the name mapping. The input is a flax parameter tree as nested dicts of
numpy arrays (a `{"params": ...}` wrapper is unwrapped); the output uses the
reference's torch names: timm ViT, HF GPT-2 (Conv1D (in, out) weights),
`classifiers.<task>`.

Layout changes: flax Dense kernel (in, out) -> torch Linear weight (out, in);
flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw); LayerNorm
scale -> weight. GPT-2's Conv1D weights keep the flax layout.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")  # a writable copy


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x).T)


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


def avth_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu AVTh params (linear encoder/decoder mode) -> the port's AVTh."""
    sd = {f"gpt_model.{k}": v for k, v in gpt2_from_jax(p["gpt"]).items()}
    sd["encoder.weight"] = _t(p["encoder"]["kernel"])
    sd["decoder.weight"] = _t(p["decoder"]["kernel"])
    return sd


def _prefixed(prefix: str, sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def avt_from_jax(p: Mapping) -> Dict[str, np.ndarray]:
    """avt_tpu AVTModel params -> the reference BaseModel's names."""
    handled = {"backbone", "future_predictor"}
    sd: Dict[str, np.ndarray] = {}
    if "backbone" in p:
        sd.update(_prefixed("backbone.model.", vit_from_jax(p["backbone"])))
    if "future_predictor" in p:
        sd.update(_prefixed("future_predictor.", avth_from_jax(p["future_predictor"])))
    for key, sub in p.items():
        m = re.fullmatch(r"classifiers_(.+)", key)
        if m:
            handled.add(key)
            _linear(sd, f"classifiers.{m.group(1)}", sub["fc"])
    leftovers = sorted(set(p) - handled)
    if leftovers:
        raise NotImplementedError(f"no conversion for {leftovers} yet")
    return sd


def params_from_jax(params: Mapping) -> StateDict:
    """A JAX package parameter tree (full AVTModel, ViT, GPT2Core or AVTh)
    -> the port's state_dict of f32 CPU tensors. An AVTModel on the identity
    backbone (the feature path) has no `backbone` subtree and maps to no
    `backbone.` names."""
    if set(params) == {"params"}:
        params = params["params"]
    if "backbone" in params or "future_predictor" in params:
        sd = avt_from_jax(params)
    elif "cls_token" in params:
        sd = vit_from_jax(params)
    elif "wpe" in params:
        sd = gpt2_from_jax(params)
    elif "gpt" in params:
        sd = avth_from_jax(params)
    else:
        raise ValueError(f"unrecognised parameter tree (keys {sorted(params)[:5]})")
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Loads a JAX package parameter tree into `model` (strict)."""
    sd = params_from_jax(params)
    model.load_state_dict(sd, strict=True)
    return model


def opt_state_from_jax(trace: Mapping, count: int = 0) -> dict:
    """An optax momentum tree (`TraceState.trace`) -> the port's SGD state
    (`{"count": count, "momentum": {name: f32 tensor}}`, for
    `SGD.load_state_dict`, which rounds into the buffers' own type). A trace
    has the parameters' tree, so `params_from_jax`'s re-layout applies; the
    leaves of frozen parameters, which optax masks out, are filled in by the
    caller."""
    return {"count": int(count), "momentum": params_from_jax(trace)}
