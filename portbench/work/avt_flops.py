"""Model FLOPs of one clip of an AVT configuration, counted from its shapes
(2 FLOPs a multiply-add; LayerNorms, softmax and elementwise left out).

Forward: the ViT on every frame (patch embedding, per block the qkv
projection, QK^T and PV, the output projection and the MLP), AVT-h on the
T tokens (encoder and decoder, per layer 12 C^2 of linears a token and the
causal attention's kept pairs), the past classifier on every token and
the classifier once. A train step counts 3 forwards (backward = 2 x
forward, no recompute); serving counts the forward of every view.
"""
from __future__ import annotations


def causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def vit_frame_flops(model: dict) -> int:
    E, P, L = model["vit_width"], model["patch_size"], model["vit_depth"]
    n = (model["img_size"] // P) ** 2
    T = n + 1
    hidden = E * model["vit_mlp_ratio"]
    block = 2 * T * (3 * E * E + E * E + 2 * E * hidden) + 4 * T * T * E
    return 2 * n * 3 * P * P * E + L * block


def head_clip_flops(model: dict, T: int) -> int:
    """AVT-h, the past classifier and the classifier on T tokens of one clip."""
    C, F, A = model["inter_dim"], model["backbone_dim"], model["num_actions"]
    linears = model["n_layer"] * 12 * C * C + 2 * F * C + F * A  # a token
    attention = model["n_layer"] * 4 * C * causal_pairs(T)
    return 2 * T * linears + attention + 2 * F * A


def forward_clip_flops(model: dict, T: int) -> int:
    """One view of one clip of T frames (or features)."""
    vit = T * vit_frame_flops(model) if model["backbone"] == "avt_b" else 0
    return vit + head_clip_flops(model, T)


def train_clip_flops(model: dict, T: int) -> int:
    return 3 * forward_clip_flops(model, T)


def serve_clip_flops(model: dict, T: int, views: int) -> int:
    return views * forward_clip_flops(model, T)
