"""The flagship: AVT-b (ViT-B/16) backbone + AVT-h head, expts/01.

Counterpart of avt_tpu/models/flagship.py:build_avt for backbone="avt_b".
Weights are drawn from the JAX package's distributions (not its values):
N(0, 0.01) for the ViT, AVT-h encoder/decoder and classifier linears,
trunc-normal(0.02) for cls_token and pos_embed, flax's lecun-normal for the
patch embedding, N(0, 0.02) for the GPT-2 weights and wpe; biases 0,
LayerNorms at weight 1, bias 0.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avt_tpu_torch.losses.mse import mse
from avt_tpu_torch.models.base import AVTModel
from avt_tpu_torch.models.classifiers import LinearClassifier
from avt_tpu_torch.models.future import AVTh
from avt_tpu_torch.models.layers import init_normal_, lecun_normal_, trunc_normal_
from avt_tpu_torch.models.temporal_agg import IdentityAgg
from avt_tpu_torch.models.vit import ViT
from avt_tpu_torch.utils.device import resolve_device


def _feat_loss(pred, tgt):
    return mse(pred, tgt, reduction="none")


def init_weights(model: AVTModel, generator: torch.Generator) -> None:
    """Draws every parameter of a flagship-shaped model afresh."""
    with torch.no_grad():
        vit = model.backbone["model"]
        init_normal_(vit, 0.01, generator)
        trunc_normal_(vit.cls_token, 0.02, generator)
        trunc_normal_(vit.pos_embed, 0.02, generator)
        w = vit.patch_embed.proj.weight
        lecun_normal_(w, w[0].numel(), generator)
        nn.init.zeros_(vit.patch_embed.proj.bias)
        fp = model.future_predictor
        init_normal_(fp.gpt_model, 0.02, generator)
        nn.init.normal_(fp.encoder.weight, std=0.01, generator=generator)
        nn.init.normal_(fp.decoder.weight, std=0.01, generator=generator)
        init_normal_(model.classifiers, 0.01, generator)


def build_avt(
    *,
    num_actions: int = 3806,
    backbone: str = "avt_b",
    inter_dim: int = 2048,
    n_layer: int = 6,
    n_head: int = 4,
    output_len: int = 1,
    avg_last_n: int = 1,
    dropout: float = 0.2,
    classifier_on_past: bool = True,
    vit_dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
) -> AVTModel:
    """The AVT-b + AVT-h flagship, in eval mode, on `device` (CUDA unless
    device="cpu" is asked for). `generator` (on that device) or `seed` makes
    the weights reproducible."""
    if backbone != "avt_b":
        raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        if seed is None:
            generator.seed()
        else:
            generator.manual_seed(seed)
    bb_dim = 768
    model = AVTModel(
        backbone=ViT(dtype=vit_dtype, device=device),
        temporal_aggregator=IdentityAgg(in_features=bb_dim),
        future_predictor=AVTh(
            in_features=bb_dim, inter_dim=inter_dim, n_layer=n_layer, n_head=n_head,
            output_len=output_len, avg_last_n=avg_last_n, return_past_too=True,
            future_pred_loss=_feat_loss,
            dtype=vit_dtype,  # head compute matches the backbone dtype
            device=device,
        ),
        temporal_aggregator_after_future_pred=IdentityAgg(in_features=bb_dim),
        classifiers={"action": LinearClassifier(bb_dim, num_actions, device=device)},
        num_classes=(("action", num_actions),),
        backbone_dim=bb_dim,
        dropout=dropout,
        classifier_on_past=classifier_on_past,
    )
    init_weights(model, generator)
    return model.eval()
