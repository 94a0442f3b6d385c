"""Model zoo: the AVT-b + AVT-h flagship and its feature path (identity
backbone + AVT-h, with its rollouts, KV cache, attention maps and
cluster-id inputs), the conv backbones (the video ResNets and
BN-Inception), the Mean, RULSTM and Transformer aggregators, the MLP
and identity future predictors, the Moonlight-16B-A3B decoder as an AVT-h
core, the MLP classifier and the k-means centroids."""
from avt_tpu_torch.models.backbones import IdentityBackbone
from avt_tpu_torch.models.base import AVTModel
from avt_tpu_torch.models.bninception import BNInceptionVideo
from avt_tpu_torch.models.classifiers import LinearClassifier, MLPClassifier
from avt_tpu_torch.models.cluster import KmeansAssigner, kmeans_fit, load_centroids
from avt_tpu_torch.models.flagship import build_avt
from avt_tpu_torch.models.future import AVTh, IdentityFuture, MLPFuture
from avt_tpu_torch.models.layers import (
    EncoderBlock,
    GPT2Block,
    GPT2Core,
    SelfAttention,
    gelu_new,
    position_stable_dropout,
    sincos_positional_encoding,
)
from avt_tpu_torch.models.mla_moe import MLAMoECore
from avt_tpu_torch.models.norm import batch_norm
from avt_tpu_torch.models.temporal_agg import IdentityAgg, MeanAgg, RULSTMAgg, TransformerAgg
from avt_tpu_torch.models.video_resnet import (
    VIDEO_RESNETS,
    BasicBlock3D,
    Bottleneck3D,
    Conv2Plus1D,
    Conv3DDepthwise,
    Conv3DSimple,
    IPConv3DDepthwise,
    VideoResNet,
    ip_csn_50,
    ip_csn_152,
    ir_csn_152,
    r2plus1d_18,
    r2plus1d_34,
    r2plus1d_152,
    r3d_18,
)
from avt_tpu_torch.models.vit import ViT, ViTAttention, ViTBlock

__all__ = [
    "AVTModel", "AVTh", "BNInceptionVideo", "BasicBlock3D", "Bottleneck3D", "Conv2Plus1D",
    "Conv3DDepthwise", "Conv3DSimple", "EncoderBlock", "GPT2Block", "GPT2Core",
    "IPConv3DDepthwise", "IdentityAgg", "IdentityBackbone", "IdentityFuture", "KmeansAssigner",
    "LinearClassifier", "MLAMoECore", "MLPClassifier", "MLPFuture", "MeanAgg", "RULSTMAgg",
    "SelfAttention",
    "TransformerAgg", "VIDEO_RESNETS", "VideoResNet", "ViT", "ViTAttention", "ViTBlock",
    "batch_norm", "build_avt", "gelu_new", "ip_csn_152", "ip_csn_50", "ir_csn_152",
    "kmeans_fit", "load_centroids", "position_stable_dropout", "r2plus1d_152", "r2plus1d_18",
    "r2plus1d_34", "r3d_18", "sincos_positional_encoding",
]
