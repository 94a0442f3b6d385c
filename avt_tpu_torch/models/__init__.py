"""Model zoo: the AVT-b + AVT-h flagship and its feature path (identity
backbone + AVT-h, with its rollouts, KV cache, attention maps and
cluster-id inputs), the Mean, RULSTM and Transformer aggregators, the MLP
and identity future predictors, the MLP classifier and the k-means
centroids."""
from avt_tpu_torch.models.backbones import IdentityBackbone
from avt_tpu_torch.models.base import AVTModel
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
from avt_tpu_torch.models.temporal_agg import IdentityAgg, MeanAgg, RULSTMAgg, TransformerAgg
from avt_tpu_torch.models.vit import ViT, ViTAttention, ViTBlock

__all__ = [
    "AVTModel", "AVTh", "EncoderBlock", "GPT2Block", "GPT2Core", "IdentityAgg",
    "IdentityBackbone", "IdentityFuture", "KmeansAssigner", "LinearClassifier",
    "MLPClassifier", "MLPFuture", "MeanAgg", "RULSTMAgg", "SelfAttention", "TransformerAgg",
    "ViT", "ViTAttention", "ViTBlock", "build_avt", "gelu_new", "kmeans_fit",
    "load_centroids", "position_stable_dropout", "sincos_positional_encoding",
]
