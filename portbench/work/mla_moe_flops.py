"""Model FLOPs of one clip of the Moonlight-16B-A3B head on AVT's feature
path, counted from the configuration's shapes (2 FLOPs a multiply-add;
norms, RoPE, softmax, the router's top-k and elementwise left out).

Forward on T tokens: AVT's encoder and decoder, the past classifier on
every token and the classifier once; a layer's latent attention (q, the
latent kv and its expansion, the output projection a token; QK^T over 192
and PV over 128 for the causal attention's kept pairs); the dense layer's
SwiGLU; a MoE layer's router over all the router's experts, the shared
experts, and the held experts at their expected pairs: experts_per_token x
held / router experts a token (a uniform router's share; the work of the
pairs routed here is what the held experts do). A train step counts 3
forwards (backward = 2 x forward, no recompute).
"""
from __future__ import annotations

from portbench.work.avt_flops import causal_pairs


def layer_token_flops(cfg: dict) -> dict:
    """2 x multiply-adds a token of each kind of layer, attention's scores
    and values left out."""
    C, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rot, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    attn = C * H * (nope + rot) + C * (rank + rot) + rank * H * (nope + dv) + H * dv * C
    held = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / cfg["n_router_experts"]
    moe = (C * cfg["n_router_experts"]
           + 3 * C * cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
           + held * 3 * C * cfg["moe_intermediate_size"])
    return {"attention": 2 * attn, "dense_ffn": 2 * 3 * C * cfg["intermediate_size"],
            "moe_ffn": 2 * moe}


def forward_clip_flops(cfg: dict, T: int) -> float:
    m = cfg["model"]
    C, F, A = cfg["hidden_size"], m["backbone_dim"], m["num_actions"]
    per = layer_token_flops(cfg)
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    H, qk = cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    token = (L * per["attention"] + dense * per["dense_ffn"] + (L - dense) * per["moe_ffn"]
             + 2 * (2 * F * C + F * A))
    scores = L * 2 * H * causal_pairs(T) * (qk + cfg["v_head_dim"])
    return T * token + scores + 2 * F * A


def train_clip_flops(cfg: dict, T: int) -> float:
    return 3 * forward_clip_flops(cfg, T)
