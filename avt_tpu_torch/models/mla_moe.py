"""The Moonlight-16B-A3B decoder (DeepSeek-V3's block: multi-head latent
attention and a mixture of experts) as a core of AVT-h.

No counterpart in avt_tpu: the JAX package runs AVT-h on GPT-2's block only.
The equations follow the published config
(https://huggingface.co/moonshotai/Moonlight-16B-A3B, `model_type:
deepseek_v3`) and DeepSeek-V3's public modelling code. A layer takes h (B, T,
C) and adds

  attention  a = RMSNorm(h); q = a W_q (H heads of 128 + 64); c = a W_kva
             (512 + 64): c_kv and one rotary key k_pe for every head; kv =
             RMSNorm(c_kv) W_kvb (H heads of 128 + 128): k_nope and v; RoPE
             (theta 50000) on q_pe and k_pe at positions position_offset +
             0..T-1; o = softmax(q k^T / sqrt(192), causal) v with q =
             [q_nope, q_pe], k = [k_nope, k_pe]; h += concat(o) W_o;
  FFN        a = RMSNorm(h); the first `first_k_dense_replace` layers h +=
             SwiGLU(a) of width `intermediate_size`; the rest h += the held
             routed experts' part + the shared experts (one SwiGLU of width
             n_shared_experts x moe_intermediate_size).

The router scores all `n_router_experts` experts, s = sigmoid(a W_r^T) in
f32, chooses the top `num_experts_per_tok` of s + e_score_correction_bias
(the bias takes part in the choice only), and weights the chosen w_i =
routed_scaling_factor * s_i / (sum of the chosen s + 1e-20). The layer is
told which experts it holds (`experts_held` of them, experts expert_rank *
experts_held on): it computes only their part, sum over the chosen held
experts of w_i SwiGLU_i(a), as one rank of expert parallelism does before
the exchange; the pairs routed to the other experts are left out, and no
code stands in for them. Dispatch, the grouped products and the combine are
`_HeldExperts`: no token routed to a held expert is dropped, there is no
host sync, and the combine sums each token's choices in a fixed order (no
atomics), so a repeat gives the same bits.

RMSNorm is DeepSeek-V3's: x32 = x.float(), y = x32 * rsqrt(mean(x32^2) +
eps), w * y in the input's type. Under a compute dtype (`dtype`, bf16 for
Moonlight) the residual stream, the linears (models/layers.py `dense`: f32
parameters cast at use) and the experts run in it; the router, RMSNorm's
statistics, RoPE's rotation and the weighted sum of the experts run in
f32; the core's output comes back as f32, as GPT2Core's does.

Parameter names follow the HF checkpoint under `layers.<i>.`:
`self_attn.{q_proj,kv_a_proj_with_mqa,kv_a_layernorm,kv_b_proj,o_proj}`,
`mlp.{gate_proj,up_proj,down_proj}` (dense layers), `mlp.gate.weight` and
the buffer `mlp.gate.e_score_correction_bias`, `mlp.shared_experts.
{gate_proj,up_proj,down_proj}`, `input_layernorm`,
`post_attention_layernorm`, then `norm`. The held experts are stored
stacked, one tensor a projection: `mlp.experts.gate_proj` and `up_proj`
(experts_held, moe_intermediate_size, C) and `down_proj` (experts_held, C,
moe_intermediate_size), expert i of the stack being the checkpoint's
`mlp.experts.<expert_rank * experts_held + i>.<proj>.weight`.

Departures from the published model: no vocabulary or embedding (AVT feeds
frame features through its own encoder); the bias is a buffer that no step
updates (DeepSeek-V3's balance update of it is left out); no multi-token
prediction (Moonlight has none). Not supported: KV-cache rollouts, attention
maps and tensor parallelism (each raises).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avt_tpu_torch.models.layers import dense
from avt_tpu_torch.ops import dot_product_attention
from avt_tpu_torch.parallel.mesh import current_mesh
from avt_tpu_torch.utils.trace import count, span, tracing


class RMSNorm(nn.Module):
    """DeepSeek-V3's RMSNorm: statistics in f32, the product in x's type."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight.to(x.dtype) * y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotates the pairs (2i, 2i + 1) of x's last axis (..., T, heads, d) by
    angle position * theta^(-2i/d), in f32, rounded once to x's type.
    DeepSeek-V3's code de-interleaves the pairs before its rotate_half; it
    permutes q and k alike, so the scores are the same."""
    d = x.shape[-1]
    inv_freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angle = positions.float()[:, None] * inv_freq[None, :]  # (T, d/2)
    cos, sin = (f(angle)[:, None, :] for f in (torch.cos, torch.sin))  # (T, 1, d/2)
    pairs = x.float().unflatten(-1, (d // 2, 2))
    x0, x1 = pairs[..., 0], pairs[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


class LatentAttention(nn.Module):
    """DeepSeek-V3's multi-head latent attention without query compression
    (q_lora_rank null), causal: keys of qk_nope + qk_rope (192) and values
    of v_head_dim (128) through `dot_product_attention`, so on CUDA at 128
    tokens or more through the flash kernels at those two widths."""

    def __init__(self, dim: int, num_heads: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, rope_theta: float, eps: float,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_heads, self.dtype, self.theta = num_heads, dtype, rope_theta
        self.widths = (qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank)
        qk = qk_nope_head_dim + qk_rope_head_dim
        self.q_proj = nn.Linear(dim, num_heads * qk, bias=False, device=device)
        self.kv_a_proj_with_mqa = nn.Linear(dim, kv_lora_rank + qk_rope_head_dim, bias=False,
                                            device=device)
        self.kv_a_layernorm = RMSNorm(kv_lora_rank, eps, device=device)
        self.kv_b_proj = nn.Linear(kv_lora_rank, num_heads * (qk_nope_head_dim + v_head_dim),
                                   bias=False, device=device)
        self.o_proj = nn.Linear(num_heads * v_head_dim, dim, bias=False, device=device)

    def forward(self, a: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        B, T, _ = a.shape
        H, dt = self.num_heads, self.dtype
        nope, rot, dv, rank = self.widths
        q = dense(a, self.q_proj.weight, None, dt).view(B, T, H, nope + rot)
        c = dense(a, self.kv_a_proj_with_mqa.weight, None, dt)
        c_kv, k_pe = c.split([rank, rot], dim=-1)
        kv = dense(self.kv_a_layernorm(c_kv), self.kv_b_proj.weight, None, dt)
        k_nope, v = kv.view(B, T, H, nope + dv).split([nope, dv], dim=-1)
        q_nope, q_pe = q.split([nope, rot], dim=-1)
        k_pe = rope(k_pe[:, :, None], positions, self.theta)
        q = torch.cat([q_nope, rope(q_pe, positions, self.theta)], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, T, H, rot)], dim=-1)
        o = dot_product_attention(q, k, v, causal=True)
        return dense(o.reshape(B, T, H * dv), self.o_proj.weight, None, dt)


class SwiGLU(nn.Module):
    """down(silu(gate(a)) * up(a)), no biases."""

    def __init__(self, dim: int, hidden: int, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.gate_proj = nn.Linear(dim, hidden, bias=False, device=device)
        self.up_proj = nn.Linear(dim, hidden, bias=False, device=device)
        self.down_proj = nn.Linear(hidden, dim, bias=False, device=device)

    def forward(self, a):
        dt = self.dtype
        h = F.silu(dense(a, self.gate_proj.weight, None, dt)) * dense(a, self.up_proj.weight,
                                                                       None, dt)
        return dense(h, self.down_proj.weight, None, dt)


class _HeldExperts(torch.autograd.Function):
    """The held experts' part of a MoE layer, sum over k of w[:, k] *
    SwiGLU_{slot[:, k]}(a), a slot of n_held (an expert held elsewhere)
    adding nothing: a (N, C) tokens in the compute type, w (N, k) f32
    routing weights, slot (N, k) int64; the stacked weights w_gate, w_up
    (n_held, I, C), w_down (n_held, C, I) in a's type.

    Dispatch on the device: the (token, choice) pairs sorted by slot
    (stable), each held expert's count by a scatter-add and the group
    offsets by a cumsum, so the host reads nothing. The pairs' tokens are
    gathered into a buffer of N * k rows, the most the held experts can
    receive (none is dropped); the three products are torch._grouped_mm
    over the held experts' groups (rows past the last group are left
    undefined and masked out after). The combine gathers each pair's
    output back to its (token, choice) and adds the k choices in order, in
    f32: no atomics. The backward is the same dispatch run backwards:
    dX = dY W and dW_e = dY_e^T X_e are grouped products (the latter with
    the offsets on K), the token gradient the k choices' sum in order.

    The backward is written out, though torch._grouped_mm has a correct one
    of its own, for two reasons. Autograd's backward of the gather
    `a.index_select(0, order // k)` index-adds each token's k rows into its
    gradient with atomics, so a repeat would not give the same bits; here
    the k rows are summed in order. And it would save the gathered N * k
    rows of a; here they are gathered again from a."""

    @staticmethod
    def forward(ctx, a, w, slot, w_gate, w_up, w_down):
        N, k = slot.shape
        E = w_gate.shape[0]
        key = slot.reshape(-1)
        order = torch.argsort(key, stable=True)
        counts = torch.zeros(E + 1, dtype=torch.int64, device=a.device).scatter_add_(
            0, key, torch.ones_like(key))
        offs = counts[:E].cumsum(0).to(torch.int32)
        if tracing():  # the held experts' load, for expert_load.train
            count("avt.moe.pairs_held", offs[-1])
            count("avt.moe.pairs_max", counts[:E].max())
            count("avt.moe.tokens", N)
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(N * k, device=a.device))
        xs = a.index_select(0, order // k)
        g = torch._grouped_mm(xs, w_gate.transpose(1, 2), offs=offs)
        u = torch._grouped_mm(xs, w_up.transpose(1, 2), offs=offs)
        y = torch._grouped_mm(F.silu(g) * u, w_down.transpose(1, 2), offs=offs)
        keep = slot < E
        out = _choice_sum(y.index_select(0, inv).view(N, k, -1), keep, w)
        ctx.save_for_backward(a, w, keep, order, inv, offs, g, u, y, w_gate, w_up, w_down)
        return out.to(a.dtype)

    @staticmethod
    def backward(ctx, dout):
        a, w, keep, order, inv, offs, g, u, y, w_gate, w_up, w_down = ctx.saved_tensors
        N, k = keep.shape
        dt = a.dtype
        d32 = dout.float()
        yp = y.index_select(0, inv).view(N, k, -1)
        dw = torch.stack([torch.where(keep[:, j], (yp[:, j].float() * d32).sum(-1), 0.0)
                          for j in range(k)], dim=1)
        dyp = torch.stack([torch.where(keep[:, j, None], (w[:, j, None] * d32).to(dt), 0.0)
                           for j in range(k)], dim=1)
        dy = dyp.view(N * k, -1).index_select(0, order)
        dh = torch._grouped_mm(dy, w_down, offs=offs)
        act = F.silu(g)
        dg = torch.ops.aten.silu_backward(dh * u, g)
        du = dh * act
        xs = a.index_select(0, order // k)
        d_down = torch._grouped_mm(dy.t(), act * u, offs=offs)
        d_gate = torch._grouped_mm(dg.t(), xs, offs=offs)
        d_up = torch._grouped_mm(du.t(), xs, offs=offs)
        dxs = torch._grouped_mm(dg, w_gate, offs=offs) + torch._grouped_mm(du, w_up, offs=offs)
        da = _choice_sum(dxs.index_select(0, inv).view(N, k, -1), keep, None).to(dt)
        return da, dw, None, d_gate, d_up, d_down


def _choice_sum(x: torch.Tensor, keep: torch.Tensor, w: Optional[torch.Tensor]):
    """sum over j of keep[:, j] * (w[:, j]) * x[:, j] in f32, j in order; an
    entry not kept adds nothing, whatever x holds there."""
    out = None
    for j in range(x.shape[1]):
        term = x[:, j].float() if w is None else x[:, j].float() * w[:, j, None]
        term = torch.where(keep[:, j, None], term, 0.0)
        out = term if out is None else out + term
    return out


class MoEGate(nn.Module):
    """The router: weight (n_router_experts, C), the choice bias as a buffer."""

    def __init__(self, dim: int, n_router_experts: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_router_experts, dim, device=device))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(n_router_experts, device=device))


class HeldExperts(nn.Module):
    """The held experts' SwiGLU weights, stacked (the module docstring)."""

    def __init__(self, dim: int, hidden: int, n_held: int, device=None):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.zeros(n_held, hidden, dim, device=device))
        self.up_proj = nn.Parameter(torch.zeros(n_held, hidden, dim, device=device))
        self.down_proj = nn.Parameter(torch.zeros(n_held, dim, hidden, device=device))


class MoE(nn.Module):
    """DeepSeek-V3's MoE FFN on one rank of expert parallelism: the router
    over all n_router_experts, the held experts' part, the shared experts."""

    def __init__(self, dim: int, moe_intermediate_size: int, n_router_experts: int,
                 experts_held: int, expert_rank: int, num_experts_per_tok: int,
                 n_shared_experts: int, routed_scaling_factor: float,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if not 0 <= expert_rank * experts_held < (expert_rank + 1) * experts_held \
                <= n_router_experts:
            raise ValueError(f"experts {expert_rank * experts_held} to "
                             f"{(expert_rank + 1) * experts_held - 1} are not among the "
                             f"router's {n_router_experts}")
        self.dtype = dtype
        self.first = expert_rank * experts_held
        self.top_k, self.scale = num_experts_per_tok, routed_scaling_factor
        self.gate = MoEGate(dim, n_router_experts, device=device)
        self.experts = HeldExperts(dim, moe_intermediate_size, experts_held, device=device)
        self.shared_experts = SwiGLU(dim, n_shared_experts * moe_intermediate_size, dtype,
                                     device=device)

    def route(self, a: torch.Tensor):
        """(w (N, k) f32, the held slot of each choice (N, k), n_held where
        the expert is held elsewhere) of tokens a (N, C)."""
        s = torch.sigmoid(F.linear(a.float(), self.gate.weight))
        choice = torch.topk(s + self.gate.e_score_correction_bias, self.top_k, dim=-1).indices
        chosen = s.gather(1, choice)
        w = self.scale * chosen / (chosen.sum(-1, keepdim=True) + 1e-20)
        n_held = self.experts.gate_proj.shape[0]
        local = choice - self.first
        slot = torch.where((local >= 0) & (local < n_held), local, n_held)
        return w, slot

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        with span("avt.moe"):
            shape, dt = a.shape, self.dtype or a.dtype
            x = a.reshape(-1, shape[-1]).to(dt)
            w, slot = self.route(x)
            e = self.experts
            routed = _HeldExperts.apply(x, w, slot, e.gate_proj.to(dt), e.up_proj.to(dt),
                                        e.down_proj.to(dt))
            return (routed + self.shared_experts(x)).reshape(shape)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, attn_kw: dict, mlp: nn.Module, eps: float,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(dim, eps, device=device)
        self.self_attn = LatentAttention(dim, eps=eps, dtype=dtype, device=device, **attn_kw)
        self.post_attention_layernorm = RMSNorm(dim, eps, device=device)
        self.mlp = mlp

    def forward(self, h, positions):
        with span("avt.mla"):
            h = h + self.self_attn(self.input_layernorm(h), positions)
        return h + self.mlp(self.post_attention_layernorm(h))


class MLAMoECore(nn.Module):
    """The decoder stack without vocabulary: `layers` and a final `norm`.
    Sizes are the HF config's keys; hidden_size is AVT-h's inter_dim. Called
    as GPT2Core is: (inputs_embeds (B, T, C), position_offset) -> (B, T, C)
    f32; it has no dropout, and takes no KV cache or attention maps."""

    def __init__(self, hidden_size: int = 2048, num_hidden_layers: int = 27,
                 num_attention_heads: int = 16, kv_lora_rank: int = 512,
                 qk_nope_head_dim: int = 128, qk_rope_head_dim: int = 64,
                 v_head_dim: int = 128, intermediate_size: int = 11264,
                 moe_intermediate_size: int = 1408, n_router_experts: int = 64,
                 experts_held: int = 64, expert_rank: int = 0, num_experts_per_tok: int = 6,
                 n_shared_experts: int = 2, routed_scaling_factor: float = 2.446,
                 first_k_dense_replace: int = 1, rope_theta: float = 50000.0,
                 rms_norm_eps: float = 1e-5, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        attn_kw = dict(num_heads=num_attention_heads, kv_lora_rank=kv_lora_rank,
                       qk_nope_head_dim=qk_nope_head_dim, qk_rope_head_dim=qk_rope_head_dim,
                       v_head_dim=v_head_dim, rope_theta=rope_theta)

        def ffn(i):
            if i < first_k_dense_replace:
                return SwiGLU(hidden_size, intermediate_size, dtype, device=device)
            return MoE(hidden_size, moe_intermediate_size, n_router_experts, experts_held,
                       expert_rank, num_experts_per_tok, n_shared_experts,
                       routed_scaling_factor, dtype, device=device)

        self.layers = nn.ModuleList(
            DecoderLayer(hidden_size, attn_kw, ffn(i), rms_norm_eps, dtype, device=device)
            for i in range(num_hidden_layers))
        self.norm = RMSNorm(hidden_size, rms_norm_eps, device=device)

    def forward(self, inputs_embeds, position_offset: int = 0,
                generator: Optional[torch.Generator] = None, *, output_attentions: bool = False,
                dropout_key: Optional[torch.Tensor] = None, kv_caches=None,
                return_kv: bool = False):
        if output_attentions or kv_caches is not None or return_kv:
            raise NotImplementedError("the MLA-MoE core takes no KV cache and exports no "
                                      "attention maps")
        if current_mesh().n_model > 1:
            raise NotImplementedError("the MLA-MoE core runs without tensor parallelism")
        T = inputs_embeds.shape[1]
        positions = torch.arange(position_offset, position_offset + T,
                                 device=inputs_embeds.device)
        h = inputs_embeds if self.dtype is None else inputs_embeds.to(self.dtype)
        for layer in self.layers:
            h = layer(h, positions)
        return self.norm(h).float()


def init_mla_moe_(core: MLAMoECore, std: float, generator: torch.Generator) -> None:
    """N(0, std) for every weight of the core (the assumed initializer
    range), RMSNorm weights at 1, the choice bias at 0."""
    for name, p in core.named_parameters():
        if name.endswith("layernorm.weight") or name.endswith("norm.weight"):
            nn.init.ones_(p)
        else:
            nn.init.normal_(p, std=std, generator=generator)
    for b in core.buffers():
        nn.init.zeros_(b)
