"""Frame-level ViT backbone (AVT-b).

Counterpart of avt_tpu/models/vit.py: timm's vit_base_patch16_224 run per
frame (time folded into the batch); the per-frame feature is the class token
after the final LayerNorm, returned f32 as (B, C', T, 1, 1). Parameter names
are timm's, so a timm or reference AVT checkpoint loads unchanged.

Under `dtype=torch.bfloat16` the compute follows flax's `dtype=` semantics
(see layers.dense): params stay f32, GELU is the tanh form (exact erf in
f32; `gelu_approx` picks one), and on CUDA the attention reads the packed
qkv projection in place through the hand-written kernel. `drop_rate` (0 in
every shipped configuration) drops out the embedded tokens and each block's
attention and MLP outputs in train mode, as the JAX package's ViT does.

Under tensor parallelism (parallel/mesh.py) an attention whose `tp` is a
mesh runs its local heads off its local packed qkv projection (the kernels
unchanged, so the packed kernel's bias gradient is the local columns'), and
an MLP its local hidden units; the dropouts act on replicated activations,
where every model peer draws the same full mask.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avt_tpu_torch.models.layers import dense, dropout, layer_norm
from avt_tpu_torch.ops.attention import fused_qkv_attention
from avt_tpu_torch.parallel.mesh import copy_to_model, local_bias, row_dense


class ViTAttention(nn.Module):
    """qkv projection + attention, then proj. `use_kernel` is
    `fused_qkv_attention`'s (None: the split path)."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.use_kernel = None
        self.tp = None

    def forward(self, x):
        tp = self.tp
        heads = self.num_heads // (tp.n_model if tp else 1)
        # the projection runs in x's type (cast by the caller's LayerNorm),
        # its bias added in that type before the attention
        kernel = self.qkv.weight.to(x.dtype).t()  # (C, 3C), cast while contiguous
        options = {} if self.use_kernel is None else {"use_kernel": self.use_kernel}
        out = fused_qkv_attention(copy_to_model(x, tp), kernel,
                                  local_bias(self.qkv.bias, tp, qkv=True), heads, **options)
        return row_dense(out, self.proj.weight, self.proj.bias, self.dtype, tp)


class Mlp(nn.Module):
    """fc1, GELU, fc2; with `tp` a mesh, fc1's local rows and fc2's
    matching columns."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)
        self.tp = None

    def forward(self, h, dtype: Optional[torch.dtype], gelu: str):
        tp = self.tp
        h = dense(copy_to_model(h, tp), self.fc1.weight, local_bias(self.fc1.bias, tp), dtype)
        return row_dense(F.gelu(h, approximate=gelu), self.fc2.weight, self.fc2.bias, dtype, tp)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, gelu_approx: Optional[bool] = None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        # None: exact erf GELU in f32, the tanh form under bf16 (avt_tpu's default)
        if gelu_approx is None:
            gelu_approx = dtype == torch.bfloat16
        self.gelu = "tanh" if gelu_approx else "none"
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps, device=device)
        self.attn = ViTAttention(dim, num_heads, dtype=dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        def drop(t):
            return dropout(t, self.drop_rate, generator, self.training)

        x = x + drop(self.attn(layer_norm(x, self.norm1, self.dtype)))
        h = self.mlp(layer_norm(x, self.norm2, self.dtype), self.dtype, self.gelu)
        return x + drop(h)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, device=None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                              device=device)


class ViT(nn.Module):
    """Frame-level ViT: (B, 3, T, H, W) -> (B, embed_dim, T, 1, 1)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, ln_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, gelu_approx: Optional[bool] = None,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        self.dtype = dtype
        n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim, device=device))
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim, device=device)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, ln_eps, drop_rate, dtype, gelu_approx,
                     device=device)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=ln_eps, device=device)

    output_dim = property(lambda self: self.embed_dim)

    def forward(self, video, generator: Optional[torch.Generator] = None):
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
        x = dropout(x, self.drop_rate, generator, self.training)
        for block in self.blocks:
            x = block(x, generator)
        x = layer_norm(x, self.norm, self.dtype)
        feat = x[:, 0].float()  # class token, back to f32
        return feat.reshape(B, T, self.embed_dim).transpose(1, 2)[..., None, None]
