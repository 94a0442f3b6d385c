"""The flagship: AVT-b (ViT-B/16) backbone + AVT-h head, expts/01, and its
feature-path variant, the identity backbone + AVT-h of expts/02.

Counterpart of avt_tpu/models/flagship.py:build_avt. Weights are drawn from
the JAX package's distributions (not its values): N(0, 0.01) for the ViT,
AVT-h encoder/decoder and classifier linears, and for every other Linear of
the reference (the MLP heads, the Transformer aggregator's, AVTModel's
optional heads); trunc-normal(0.02) for cls_token and pos_embed, flax's
lecun-normal for the patch embedding, N(0, 0.02) for the GPT-2 weights and
wpe, the MLA-MoE core's weights (RMSNorms at 1, the router's choice bias
at 0) and the cloze mask embedding, xavier-uniform for the Transformer
aggregator's in_proj_weight; flax's LSTM cell defaults for the RULSTM:
lecun-normal input kernels, orthogonal recurrent ones (each gate's block);
biases 0, LayerNorms at weight 1, bias 0. The conv backbones: the video
ResNets' convs from variance_scaling(2, fan_out, normal) (torchvision's
kaiming_normal_; a depthwise conv's fan_out is O * kt * kh * kw),
BN-Inception's from flax's lecun-normal with zero biases; every BatchNorm at
weight 1, bias 0, running mean 0, running var 1.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avt_tpu_torch.losses.mse import mse
from avt_tpu_torch.models.backbones import IdentityBackbone
from avt_tpu_torch.models.base import AVTModel
from avt_tpu_torch.models.bninception import BNInceptionVideo
from avt_tpu_torch.models.classifiers import LinearClassifier
from avt_tpu_torch.models.future import AVTh
from avt_tpu_torch.models.layers import (
    EncoderSelfAttention,
    GPT2Core,
    init_normal_,
    lecun_normal_,
    trunc_normal_,
)
from avt_tpu_torch.models.mla_moe import init_mla_moe_
from avt_tpu_torch.models.temporal_agg import IdentityAgg, LSTMLayer, TransformerAgg
from avt_tpu_torch.models.video_resnet import VideoResNet
from avt_tpu_torch.models.vit import ViT
from avt_tpu_torch.utils.device import resolve_device


def _feat_loss(pred, tgt):
    return mse(pred, tgt, reduction="none")


def _init_lstm(lstm: LSTMLayer, generator: torch.Generator) -> None:
    """flax's OptimizedLSTMCell defaults, gate by gate: lecun-normal input
    kernels, orthogonal recurrent kernels, zero biases."""
    lecun_normal_(lstm.weight_ih_l0, lstm.weight_ih_l0.shape[1], generator)
    for gate in lstm.weight_hh_l0.chunk(4, dim=0):
        nn.init.orthogonal_(gate, generator=generator)
    nn.init.zeros_(lstm.bias_ih_l0)
    nn.init.zeros_(lstm.bias_hh_l0)


def init_aggregator(agg: nn.Module, generator: torch.Generator) -> None:
    """A temporal aggregator's parameters: N(0, 0.01) Linears, the RULSTM's
    LSTM cells, xavier-uniform in_proj weights, N(0, 0.02) mask embedding."""
    init_normal_(agg, 0.01, generator)
    for sub in agg.modules():
        if isinstance(sub, LSTMLayer):
            _init_lstm(sub, generator)
        elif isinstance(sub, EncoderSelfAttention):
            nn.init.xavier_uniform_(sub.in_proj_weight, generator=generator)
            nn.init.zeros_(sub.in_proj_bias)
    if isinstance(agg, TransformerAgg) and hasattr(agg, "extra_embeddings"):
        nn.init.normal_(agg.extra_embeddings.weight, std=0.02, generator=generator)


def init_conv_backbone(backbone: nn.Module, generator: torch.Generator) -> None:
    """A video ResNet's or BN-Inception's convs and BatchNorms, drawn as the
    JAX package draws them."""
    for sub in backbone.modules():
        if isinstance(sub, nn.modules.batchnorm._BatchNorm):
            sub.reset_parameters()  # weight 1, bias 0, running mean 0, var 1
        elif isinstance(sub, nn.Conv3d):  # the video ResNets: fan_out normal
            fan_out = sub.weight.shape[0] * sub.weight[0, 0].numel()
            nn.init.normal_(sub.weight, std=(2.0 / fan_out) ** 0.5, generator=generator)
        elif isinstance(sub, nn.Conv2d):  # BN-Inception: flax's default conv init
            lecun_normal_(sub.weight, sub.weight[0].numel(), generator)
            nn.init.zeros_(sub.bias)


def init_weights(model: AVTModel, generator: torch.Generator) -> None:
    """Draws every parameter of the model afresh, each module's with the
    JAX package's distribution (the backbone's when it has parameters)."""
    with torch.no_grad():
        vit = model.backbone["model"]
        if isinstance(vit, ViT):
            init_normal_(vit, 0.01, generator)
            trunc_normal_(vit.cls_token, 0.02, generator)
            trunc_normal_(vit.pos_embed, 0.02, generator)
            w = vit.patch_embed.proj.weight
            lecun_normal_(w, w[0].numel(), generator)
            nn.init.zeros_(vit.patch_embed.proj.bias)
        elif isinstance(vit, (VideoResNet, BNInceptionVideo)):
            init_conv_backbone(vit, generator)
        fp = model.future_predictor
        if isinstance(fp, AVTh):
            core = fp.core()
            if isinstance(core, GPT2Core):
                init_normal_(core, 0.02, generator)
            else:
                init_mla_moe_(core, 0.02, generator)
            if fp.quantized_input:  # flax's Embed init; the decoder is tied to it
                nn.init.normal_(fp.encoder.weight, std=fp.inter_dim ** -0.5,
                                generator=generator)
            else:
                nn.init.normal_(fp.encoder.weight, std=0.01, generator=generator)
                nn.init.normal_(fp.decoder.weight, std=0.01, generator=generator)
        else:
            init_normal_(fp, 0.01, generator)
        for agg in (model.temporal_aggregator, model.temporal_aggregator_after_future_pred):
            init_aggregator(agg, generator)
        init_normal_(model.classifiers, 0.01, generator)
        for name in ("mapper_to_inter", "reset_temp_agg_feat_dim", "project_mlp",
                     "regression_head"):
            if hasattr(model, name):
                init_normal_(getattr(model, name), 0.01, generator)


def build_avt(
    *,
    num_actions: int = 3806,
    backbone: str = "avt_b",
    backbone_dim: Optional[int] = None,
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
    """The AVT-b + AVT-h flagship (backbone="avt_b") or its feature-path
    variant (backbone="identity": `backbone_dim`-d features, 1024 by
    default), in eval mode, on `device` (CUDA unless device="cpu" is asked
    for). `generator` (on that device) or `seed` makes the weights
    reproducible."""
    if backbone not in ("avt_b", "identity"):
        raise NotImplementedError(
            f"build_avt builds backbone='avt_b' or 'identity', not {backbone!r}: a conv "
            "backbone is built from a config by avt_tpu_torch.config.build.build_model")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        if seed is None:
            generator.seed()
        else:
            generator.manual_seed(seed)
    if backbone == "avt_b":
        bb, bb_dim = ViT(dtype=vit_dtype, device=device), 768
    else:
        bb, bb_dim = IdentityBackbone(), backbone_dim or 1024
    model = AVTModel(
        backbone=bb,
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
