"""Frame-level ViT backbone (AVT-b).

Counterpart of avt_tpu/models/vit.py: timm's vit_base_patch16_224 run per
frame (time folded into the batch); the per-frame feature is the class token
after the final LayerNorm, returned f32 as (B, C', T, 1, 1). Parameter names
are timm's, so a timm or reference AVT checkpoint loads unchanged.

Under `dtype=torch.bfloat16` the compute follows flax's `dtype=` semantics
(see layers.dense): params stay f32, GELU is the tanh form (exact erf in
f32), and on CUDA the attention reads the packed qkv projection in place
through the hand-written kernel. Dropout (0 in every shipped configuration)
is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avt_tpu_torch.models.layers import dense, layer_norm
from avt_tpu_torch.ops.attention import fused_qkv_attention


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        # the projection runs in x's type (cast by the caller's LayerNorm),
        # its bias added in that type before the attention
        kernel = self.qkv.weight.to(x.dtype).t()  # (C, 3C), cast while contiguous
        out = fused_qkv_attention(x, kernel, self.qkv.bias, self.num_heads)
        return dense(out, self.proj.weight, self.proj.bias, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        # exact erf GELU in f32, the tanh form under bf16 (avt_tpu's default)
        self.gelu = "tanh" if dtype == torch.bfloat16 else "none"
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps, device=device)
        self.attn = ViTAttention(dim, num_heads, dtype=dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.norm1, self.dtype))
        h = layer_norm(x, self.norm2, self.dtype)
        h = dense(h, self.mlp.fc1.weight, self.mlp.fc1.bias, self.dtype)
        h = F.gelu(h, approximate=self.gelu)
        h = dense(h, self.mlp.fc2.weight, self.mlp.fc2.bias, self.dtype)
        return x + h


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, device=None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                              device=device)


class ViT(nn.Module):
    """Frame-level ViT: (B, 3, T, H, W) -> (B, embed_dim, T, 1, 1)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim, device=device))
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim, device=device)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, ln_eps, dtype, device=device)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=ln_eps, device=device)

    output_dim = property(lambda self: self.embed_dim)

    def forward(self, video):
        B, C, T, H, W = video.shape
        x = video.transpose(1, 2).reshape(B * T, C, H, W)  # fold time into batch
        if self.dtype is not None:
            x = x.to(self.dtype)
        proj = self.patch_embed.proj
        dt = x.dtype
        x = F.conv2d(x, proj.weight.to(dt), stride=self.patch_size) + proj.bias.to(dt)[:, None, None]
        x = x.flatten(2).transpose(1, 2)  # (B*T, patches, C'), patches row-major
        cls = self.cls_token.to(dt).expand(B * T, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        x = layer_norm(x, self.norm, self.dtype)
        feat = x[:, 0].float()  # class token, back to f32
        return feat.reshape(B, T, self.embed_dim).transpose(1, 2)[..., None, None]
