"""Plain PyTorch reference of the Moonlight-16B-A3B decoder (DeepSeek-V3's
block) as AVT-h's core, written from the published config and DeepSeek-V3's
public modelling code, with nothing of avt_tpu or of the port: the tests
hold avt_tpu_torch/models/mla_moe.py to it, and
portbench/reference/avt_mla_moe.py is a copy of it with each product's
operands rounded to a precision.

Parameters are a dict of f32 tensors under the port's names relative to
the core (`layers.<i>.self_attn.q_proj.weight`, ...; the held experts
stacked, `layers.<i>.mlp.experts.gate_proj` (held, I, C)). Every product is
`mm(a, b)`. Where the port's program differs on purpose:
  RoPE      DeepSeek-V3's form: the pairs de-interleaved, then rotate_half;
  experts   each held expert runs densely over every token, weighted by its
            routing weight (0 where it was not chosen): no sort, no gather,
            no grouped product;
  attention the softmax written out over the whole (T, T) scores.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_deinterleaved(x, positions, theta):
    """DeepSeek-V3's apply_rotary_pos_emb on (..., T, heads, d): the pairs
    (2i, 2i + 1) de-interleaved to [evens, odds], then x cos + rotate_half(x)
    sin with the frequencies repeated over the two halves."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]  # (T, 1, d)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * emb.cos() + half * emb.sin()


def latent_attention(P, pre, a, positions, cfg, mm):
    B, T, _ = a.shape
    H, nope, rot = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, rank, eps = cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = mm(a, P[pre + "q_proj.weight"].t()).reshape(B, T, H, nope + rot)
    c = mm(a, P[pre + "kv_a_proj_with_mqa.weight"].t())
    c_kv, k_pe = c[..., :rank], c[..., rank:]
    kv = mm(rms_norm(c_kv, P[pre + "kv_a_layernorm.weight"], eps),
            P[pre + "kv_b_proj.weight"].t()).reshape(B, T, H, nope + dv)
    theta = cfg["rope_theta"]
    q = torch.cat([q[..., :nope], rope_deinterleaved(q[..., nope:], positions, theta)], -1)
    k_pe = rope_deinterleaved(k_pe[:, :, None], positions, theta).expand(B, T, H, rot)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, .)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(nope + rot)
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    o = mm(torch.softmax(s.masked_fill(~keep, float("-inf")), -1), v)
    return mm(o.transpose(1, 2).reshape(B, T, H * dv), P[pre + "o_proj.weight"].t())


def swiglu(a, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(a, w_gate.t())) * mm(a, w_up.t()), w_down.t())


def route(P, pre, a, cfg):
    """(routing weights over all n_router_experts (N, E), 0 where not
    chosen; the choice (N, k)) from f32 scores."""
    s = torch.sigmoid(a.float() @ P[pre + "gate.weight"].t())
    choice = torch.topk(s + P[pre + "gate.e_score_correction_bias"],
                        cfg["num_experts_per_tok"], dim=-1).indices
    chosen = s.gather(1, choice)
    w = cfg["routed_scaling_factor"] * chosen / (chosen.sum(-1, keepdim=True) + 1e-20)
    return torch.zeros_like(s).scatter(1, choice, w), choice


def moe(P, pre, a, cfg, mm):
    """The held experts' part, each expert dense over every token, plus the
    shared experts."""
    shape = a.shape
    x = a.reshape(-1, shape[-1])
    weights, _ = route(P, pre, x, cfg)
    held = P[pre + "experts.gate_proj"].shape[0]
    first = cfg["expert_rank"] * held
    out = swiglu(x, P[pre + "shared_experts.gate_proj.weight"],
                 P[pre + "shared_experts.up_proj.weight"],
                 P[pre + "shared_experts.down_proj.weight"], mm)
    for e in range(held):
        y = swiglu(x, P[pre + "experts.gate_proj"][e], P[pre + "experts.up_proj"][e],
                   P[pre + "experts.down_proj"][e], mm)
        out = out + weights[:, first + e, None] * y
    return out.reshape(shape)


def core(P: Params, x: torch.Tensor, cfg: dict, mm: Callable = torch.matmul,
         position_offset: int = 0) -> torch.Tensor:
    """The decoder stack over (B, T, C) inputs at positions position_offset
    on, then the final RMSNorm."""
    eps = cfg["rms_norm_eps"]
    positions = torch.arange(position_offset, position_offset + x.shape[1])
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        a = rms_norm(x, P[pre + "input_layernorm.weight"], eps)
        x = x + latent_attention(P, pre + "self_attn.", a, positions, cfg, mm)
        a = rms_norm(x, P[pre + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(a, P[pre + "mlp.gate_proj.weight"], P[pre + "mlp.up_proj.weight"],
                           P[pre + "mlp.down_proj.weight"], mm)
        else:
            x = x + moe(P, pre + "mlp.", a, cfg, mm)
    return rms_norm(x, P["norm.weight"], eps)
