"""How the benchmark drives avt_tpu_torch's AVT (the ViT-B/16 flagship or
the identity-backbone feature path, as models/flagship.py build_avt
composes them): the model on the
benchmark's weights, the train step and the serving forward as a user
builds them, the launches each path must make, and the program's side of
the comparison.

Everything of the program is imported inside the functions, so that the
reference and the tests can import this module's neighbours without it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from portbench.reference import avt as reference
from portbench.work import avt_flops

# the port's dispatch: the packed kernel from 64 tokens (the ViT's 197), the
# flash kernels from 128 (ops/attention.py KERNEL_MIN_SEQ), on CUDA only
PACKED_MIN_TOKENS, FLASH_MIN_TOKENS = 64, 128
# the CPU events whose device time the readers take: the port's custom ops
# and the ranges the benchmark wraps around the optimizer and preprocessing
PROFILED_OPS = ("avt_tpu_torch::packed_short_attention",
                "avt_tpu_torch::packed_short_attention_bwd", "avt_tpu_torch::flash_attention",
                "avt_tpu_torch::flash_attention_bwd", "portbench.optimizer",
                "portbench.preprocess")
KERNELS = ("short_attention_fwd", "short_attention_bwd", "flash_attention_fwd",
           "flash_attention_bwd", "fused_qkv_attention_fwd")


def _dtype(name: str) -> Optional[torch.dtype]:
    return None if name == "float32" else getattr(torch, name)


def param_specs(cfg: dict):
    return reference.param_specs(cfg["model"])


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The AVT model of the configuration, composed as build_avt composes it
    (the ViT at the configuration's sizes, or the identity backbone; AVT-h
    returning the past too, its next-feature MSE; identity aggregators; a
    linear classifier), loaded with `weights`, in eval mode."""
    import functools

    from avt_tpu_torch.losses.mse import mse
    from avt_tpu_torch.models import AVTh, AVTModel, IdentityAgg, LinearClassifier, ViT
    from avt_tpu_torch.models.backbones import IdentityBackbone

    m = cfg["model"]
    dtype, C, A = _dtype(m["compute_dtype"]), m["backbone_dim"], m["num_actions"]
    if m["backbone"] == "avt_b":
        backbone = ViT(img_size=m["img_size"], patch_size=m["patch_size"],
                       embed_dim=m["vit_width"], depth=m["vit_depth"], num_heads=m["vit_heads"],
                       mlp_ratio=m["vit_mlp_ratio"], dtype=dtype,
                       gelu_approx=m["vit_gelu"] == "tanh", device=device)
    else:
        backbone = IdentityBackbone()
    pd = m["gpt_pdrop"]
    head = AVTh(in_features=C, inter_dim=m["inter_dim"], n_layer=m["n_layer"],
                n_head=m["n_head"], n_positions=m["n_positions"], embd_pdrop=pd, attn_pdrop=pd,
                resid_pdrop=pd, output_len=m["output_len"], avg_last_n=m["avg_last_n"],
                return_past_too=True, future_pred_loss=functools.partial(mse, reduction="none"),
                dtype=dtype, device=device)
    model = AVTModel(backbone=backbone, temporal_aggregator=IdentityAgg(in_features=C),
                     future_predictor=head,
                     temporal_aggregator_after_future_pred=IdentityAgg(in_features=C),
                     classifiers={"action": LinearClassifier(C, A, device=device)},
                     num_classes=(("action", A),), backbone_dim=C, dropout=m["dropout"],
                     classifier_on_past=m["classifier_on_past"])
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _preprocessor(cfg: dict, device, train: bool):
    from avt_tpu_torch.data.transforms import VideoPreprocessor

    pre = cfg["preprocess"]
    dt = _dtype(pre["compute_dtype"]) or torch.float32
    out = _dtype(pre.get("out_dtype", pre["compute_dtype"])) or torch.float32
    common = dict(crop_size=pre["crop"], scale_w=-1, mean=tuple(pre["mean"]),
                  std=tuple(pre["std"]), compute_dtype=dt, out_dtype=out, device=device)
    if train:
        lo, hi = pre["train_scale"]
        return VideoPreprocessor(scale_h=f"{lo}-{hi}", flip_p=pre["flip_p"], **common)
    return VideoPreprocessor(scale_h=pre["eval_scale"], eval_num_crops=pre["eval_crops"],
                             eval_flip_crops=pre["eval_flip_crops"], **common)


def optimizer(cfg: dict):
    """The configuration's optimizer module (portbench/optimizers)."""
    return importlib.import_module(f"portbench.optimizers.{cfg['optimizer']['name']}")


def train_program(cfg: dict, model, device, first_iter: int, frames: Optional[List] = None):
    """(step(batch, generator), optimizer): make_train_step over the
    configuration's optimizer from build_optimizer, its count at
    `first_iter`; the optimizer's step and the preprocessing run under the
    profiler ranges `portbench.optimizer` and `portbench.preprocess`. Where
    `frames` is a list, the first step's preprocessed video (B, T, 3, S, S)
    goes into it, on the host."""
    from torch.profiler import record_function

    from avt_tpu_torch.train.optim import build_optimizer
    from avt_tpu_torch.train.step import make_train_step

    o, m = cfg["optimizer"], cfg["model"]
    kwargs = optimizer(cfg).program_kwargs(o)
    opt, _ = build_optimizer(
        model, lr_wd=[["__all__", o["lr"], o["wd"]]], optimizer_name=o["name"],
        scheduler_name=o["scheduler"], iters_per_epoch=o["iters_per_epoch"],
        num_epochs=o["num_epochs"], warmup_epochs=o["warmup_epochs"], bias_bn_wd_scale=1.0,
        optimizer_kwargs=kwargs)
    opt.count = first_iter
    opt_step = opt.step

    def ranged_step():
        with record_function("portbench.optimizer"):
            opt_step()

    opt.step = ranged_step
    preprocess = None
    if m["backbone"] == "avt_b":
        pp = _preprocessor(cfg, device, train=True)

        def preprocess(clips, generator):
            with record_function("portbench.preprocess"):
                video = pp.train_fn(clips, generator)  # (B, 3, T, S, S)
            if frames is not None and not frames:
                frames.append(video.detach().transpose(1, 2).float().cpu())
            return video.transpose(1, 2)[:, :, :, None]  # T subclips of one frame

    step = make_train_step(model, opt, cfg["loss_wts"], {"action": m["num_actions"]},
                           preprocess_fn=preprocess)
    return step, opt


def serve_program(cfg: dict, model):
    """The serving forward: make_eval_forward with eval_fn's crops."""
    from avt_tpu_torch.serve import make_eval_forward

    device = next(model.parameters()).device
    model.eval()
    return make_eval_forward(model, _preprocessor(cfg, device, train=False))


def serve_request(fwd, frames, batch: int):
    """One request: batch_predict's host loop, logits on the host."""
    from avt_tpu_torch.serve import batch_predict

    return batch_predict(fwd, frames, batch)["logits/action"]


def program_batch(cfg: dict, batch: dict) -> dict:
    """The benchmark's batch in the program's layout: uint8 frames (B, T, H,
    W, 3), or features (B, T, C) as (B, T, C, 1, 1, 1) subclips."""
    video = batch["video"]
    if cfg["model"]["backbone"] != "avt_b":
        video = video[..., None, None, None]
    return {"video": video, "target": {"action": batch["target"]},
            "target_subclips": {"action": batch["target_subclips"]}}


def views(cfg: dict) -> int:
    pre = cfg["preprocess"]
    return pre["eval_crops"] * (2 if pre["eval_flip_crops"] else 1)


def clip_flops(cfg: dict, traffic: dict, mode: str) -> float:
    """Model FLOPs of one clip trained or served."""
    m, T = cfg["model"], traffic["length"]
    if mode == "train":
        return avt_flops.train_clip_flops(m, T)
    return avt_flops.serve_clip_flops(m, T, views(cfg))


def packed_call(cfg: dict, traffic: dict, mode: str, clips: int):
    """(N, T, H, D, dtype) of the packed-attention launches a ViT block
    makes over `clips` clips: every frame (of every view, served); None
    without a ViT."""
    m = cfg["model"]
    if m["backbone"] != "avt_b":
        return None
    frames = clips * traffic["length"]
    if mode != "train":
        frames *= views(cfg)
    tokens = (m["img_size"] // m["patch_size"]) ** 2 + 1
    H = m["vit_heads"]
    return frames, tokens, H, m["vit_width"] // H, m["compute_dtype"]


def flash_call(cfg: dict, traffic: dict, mode: str, clips: int):
    """(B, T, H, D, dtype) of the flash launches (causal) an AVT-h layer
    makes over `clips` clips; None where the context is too short for the
    kernels."""
    m, T = cfg["model"], traffic["length"]
    if T < FLASH_MIN_TOKENS:
        return None
    B = clips * (1 if mode == "train" else views(cfg))
    H = m["n_head"]
    return B, T, H, m["inter_dim"] // H, m["compute_dtype"]


def expected_launches(cfg: dict, length: int, mode: str, device) -> Dict[str, int]:
    """The kernel launches of one train step or one serving forward call."""
    out = {k: 0 for k in KERNELS}
    if torch.device(device).type != "cuda":
        return out
    m = cfg["model"]
    if m["backbone"] == "avt_b":
        tokens = (m["img_size"] // m["patch_size"]) ** 2 + 1
        if tokens >= PACKED_MIN_TOKENS:
            out["short_attention_fwd"] = m["vit_depth"]
            out["short_attention_bwd"] = m["vit_depth"] if mode == "train" else 0
    if length >= FLASH_MIN_TOKENS:
        out["flash_attention_fwd"] = m["n_layer"]
        out["flash_attention_bwd"] = m["n_layer"] if mode == "train" else 0
    return out


def launch_counts() -> Dict[str, int]:
    from avt_tpu_torch.ops import _build

    return dict(_build.launch_counts)


def reset_launch_counts() -> None:
    from avt_tpu_torch.ops import _build

    _build.reset_launch_counts()


def step_readings(step, opt, model, weights, batches, draws, cfg: dict,
                  frames: Optional[List] = None) -> dict:
    """The program's side of the train comparison, over its first steps:
    each step's loss, step 1's action logits (past, then future, as the
    classifier made them), |g| a leaf of step 1 read back from the
    optimizer's state after it, |p - p0| a leaf after the last, and step
    1's preprocessed frames where `frames` collects them."""
    losses, logits = [], []
    params = dict(model.named_parameters())
    hook = model.classifiers["action"].register_forward_hook(
        lambda module, args, out: logits.append(out.detach().float().flatten()))
    opt_mod, o = optimizer(cfg), cfg["optimizer"]
    for k, (batch, d) in enumerate(zip(batches, draws)):
        gen = torch.Generator(device=batch["video"].device).manual_seed(k)
        with d.patched():
            metrics = step(batch, gen)
        losses.append(float(metrics["loss"]))
        if k == 0:
            hook.remove()
            with torch.no_grad():
                grads = {n: float(opt_mod.first_gradient(opt, n, weights[n], o).norm())
                         for n in params}
    with torch.no_grad():
        change = {n: float((p - weights[n]).norm()) for n, p in params.items()}
    return {"losses": losses, "logits": torch.cat(logits), "grad_norms": grads,
            "change_norms": change, "frames": frames[0] if frames else None}
