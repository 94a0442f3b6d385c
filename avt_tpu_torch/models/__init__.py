"""Model zoo: the modules of the AVT-b + AVT-h flagship and of its feature
path (identity backbone + AVT-h)."""
from avt_tpu_torch.models.backbones import IdentityBackbone
from avt_tpu_torch.models.base import AVTModel
from avt_tpu_torch.models.classifiers import LinearClassifier
from avt_tpu_torch.models.flagship import build_avt
from avt_tpu_torch.models.future import AVTh
from avt_tpu_torch.models.layers import GPT2Block, GPT2Core, SelfAttention, gelu_new
from avt_tpu_torch.models.temporal_agg import IdentityAgg
from avt_tpu_torch.models.vit import ViT, ViTAttention, ViTBlock

__all__ = [
    "AVTModel", "AVTh", "GPT2Block", "GPT2Core", "IdentityAgg", "IdentityBackbone",
    "LinearClassifier", "SelfAttention", "ViT", "ViTAttention", "ViTBlock", "build_avt",
    "gelu_new",
]
