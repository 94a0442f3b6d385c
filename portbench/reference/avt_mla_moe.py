"""Plain PyTorch reference of AVT-h with the Moonlight-16B-A3B decoder as
its core (DeepSeek-V3's block: multi-head latent attention, a mixture of
experts with shared experts), on AVT's feature path: the encoder, the
decoder stack, the decoder, the classifiers and the losses; the optimizer
and the LR schedule are the configuration's, from portbench/optimizers and
portbench/schedules.

Written from the published config and DeepSeek-V3's public modelling code,
with no import of the measured program: a copy of tests/plain_mla_moe.py
(the reference the port's CPU tests hold its layer to) with each product's
operands rounded to `precision` ("f32"; the control's "fp8"), in f32 with
TF32 off. Where the program differs on purpose: RoPE is DeepSeek-V3's
de-interleaved form; each held expert runs densely over every token,
weighted by its routing weight (0 where it was not chosen), with no sort,
gather or grouped product; the router scores in f32 from the reference's
own activations (a choice on a near-tie may differ from the program's);
attention is the softmax written out. As in the program, the experts held
elsewhere add nothing and the choice bias takes part in the choice only
and is never updated. The train steps follow portbench/reference/avt.py's:
the loss summed over blocks of clips, the benchmark's dropout draws.
"""
from __future__ import annotations

import contextlib
import importlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.avt import _dropout, _linear, _mode_over_frames, _nll_sum, mm

Params = Dict[str, torch.Tensor]
CORE = "future_predictor.model."
BUFFERS = ("e_score_correction_bias",)  # state that is not a parameter: no gradient, no step


# ------------------------------------------------------------------ layout
def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every parameter and buffer of the model
    (its state_dict names): N(0, 0.02) weights (the assumed initializer
    range), RMSNorm weights N(1, 0.02), the choice bias N(0, 0.1) (uneven
    load, as a trained router's)."""
    m = cfg["model"]
    C, F_in, A = cfg["hidden_size"], m["backbone_dim"], m["num_actions"]
    H = cfg["num_attention_heads"]
    nope, rot, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, I, held = cfg["kv_lora_rank"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    w = 0.02

    def norm(name, n):
        return (name, (n,), 1.0, 0.02)

    specs = [("future_predictor.encoder.weight", (C, F_in), 0.0, w),
             ("future_predictor.decoder.weight", (F_in, C), 0.0, w)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"{CORE}layers.{i}."
        a = p + "self_attn."
        specs += [norm(p + "input_layernorm.weight", C),
                  (a + "q_proj.weight", (H * (nope + rot), C), 0.0, w),
                  (a + "kv_a_proj_with_mqa.weight", (rank + rot, C), 0.0, w),
                  norm(a + "kv_a_layernorm.weight", rank),
                  (a + "kv_b_proj.weight", (H * (nope + dv), rank), 0.0, w),
                  (a + "o_proj.weight", (C, H * dv), 0.0, w),
                  norm(p + "post_attention_layernorm.weight", C)]
        f = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            n = cfg["intermediate_size"]
            specs += [(f + "gate_proj.weight", (n, C), 0.0, w),
                      (f + "up_proj.weight", (n, C), 0.0, w),
                      (f + "down_proj.weight", (C, n), 0.0, w)]
        else:
            n = cfg["n_shared_experts"] * I
            specs += [(f + "gate.weight", (cfg["n_router_experts"], C), 0.0, w),
                      (f + "gate.e_score_correction_bias", (cfg["n_router_experts"],), 0.0, 0.1),
                      (f + "experts.gate_proj", (held, I, C), 0.0, w),
                      (f + "experts.up_proj", (held, I, C), 0.0, w),
                      (f + "experts.down_proj", (held, C, I), 0.0, w),
                      (f + "shared_experts.gate_proj.weight", (n, C), 0.0, w),
                      (f + "shared_experts.up_proj.weight", (n, C), 0.0, w),
                      (f + "shared_experts.down_proj.weight", (C, n), 0.0, w)]
    specs += [norm(CORE + "norm.weight", C),
              ("classifiers.action.weight", (A, F_in), 0.0, w),
              ("classifiers.action.bias", (A,), 0.0, 0.01)]
    return specs


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFERS)


# ------------------------------------------------------------- the decoder
def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_deinterleaved(x, positions, theta):
    """DeepSeek-V3's apply_rotary_pos_emb on (..., T, heads, d): the pairs
    (2i, 2i + 1) de-interleaved to [evens, odds], then x cos + rotate_half(x)
    sin with the frequencies repeated over the two halves."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
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
    """(routing weights over all the router's experts (N, E), 0 where not
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
    on, then the final RMSNorm; P under the core's own names."""
    eps = cfg["rms_norm_eps"]
    positions = torch.arange(position_offset, position_offset + x.shape[1], device=x.device)
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


# --------------------------------------------------------------- the model
def heads(P: Params, cfg: dict, feats: torch.Tensor, precision: str, draw=None):
    """(logits (B, A), past logits (B, T, A), feat loss elements (B, T-1,
    C)) of (B, T, C) features; `draw(shape)` gives the next dropout draw in
    train mode (None: eval)."""
    m = cfg["model"]
    T = feats.shape[1]
    nxt = (lambda shape: draw(shape)) if draw is not None else (lambda shape: None)
    mmp = lambda a, b: mm(a, b, precision)  # noqa: E731
    x = _linear(feats, P["future_predictor.encoder.weight"], None, precision)
    inner = {n[len(CORE):]: p for n, p in P.items() if n.startswith(CORE)}
    decoded = _linear(core(inner, x, cfg, mmp), P["future_predictor.decoder.weight"], None,
                      precision)
    feat_err = (decoded[:, :T - 1] - feats[:, 1:]) ** 2
    past = torch.cat([feats[:, :1], decoded[:, :T - 1]], dim=1)
    past = _dropout(past, m["dropout"], nxt(past.shape))
    w, b = P["classifiers.action.weight"], P["classifiers.action.bias"]
    past_logits = _linear(past, w, b, precision)
    future = _dropout(decoded[:, T - 1], m["dropout"], nxt(decoded[:, T - 1].shape))
    return _linear(future, w, b, precision), past_logits, feat_err


def _block_loss(P, cfg, batch, rows, draws, precision, counts, outputs):
    """The step's loss restricted to `rows`, each term divided by its
    whole-batch count, so that the blocks' losses sum to the step's."""
    m = cfg["model"]
    b0, b1 = rows
    draw = draws.slice(b0, b1, batch["target"].shape[0])
    logits, past_logits, feat_err = heads(P, cfg, batch["video"][b0:b1], precision, draw)
    past_target = _mode_over_frames(batch["target_subclips"][b0:b1], m["num_actions"])
    wts = cfg["loss_wts"]
    outputs.append((past_logits.detach(), logits.detach()))
    return (wts["cls_action"] * _nll_sum(logits, batch["target"][b0:b1]) / counts[0]
            + wts["past_cls_action"] * _nll_sum(past_logits, past_target) / counts[1]
            + wts["feat"] * feat_err.sum() / counts[2])


@contextlib.contextmanager
def _f32_products():
    """cuBLAS's f32 products in f32 (TF32 off), restored after."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda, cudnn


def train_steps(P0: Params, cfg: dict, batches: Sequence[dict], draws_of: Callable,
                first_iter: int, precision: str = "f32",
                pre_precision: Sequence[str] = ("f32", "f32")) -> dict:
    """The configuration's train steps from weights P0 (copied), as
    portbench/reference/avt.py's train_steps: {'losses', 'grad_norms' (step
    1, every parameter), 'change_norms', 'logits' (step 1's past logits then
    logits), 'frames': None}. The choice bias is state, not a parameter: no
    gradient, no step, in neither norm. `pre_precision` is taken for the
    interface's sake (features: no preprocessing)."""
    o = cfg["optimizer"]
    optimizer = importlib.import_module(f"portbench.optimizers.{o['name']}")
    schedule = importlib.import_module(f"portbench.schedules.{o['scheduler']}")
    state = {n: p.detach().clone() for n, p in P0.items() if is_buffer(n)}
    params = {n: p.detach().clone().requires_grad_(True) for n, p in P0.items()
              if not is_buffer(n)}
    P = {**params, **state}
    opt = optimizer.Reference(params, o)
    block = cfg["reference"]["block_clips"]
    out = {"losses": [], "frames": None}
    with _f32_products():
        for k, batch in enumerate(batches):
            B, T = batch["target_subclips"].shape[:2]
            counts = (B, B * T, B * (T - 1) * cfg["model"]["backbone_dim"])
            draws = draws_of(k)
            loss, outputs = 0.0, []
            for p in params.values():
                p.grad = None
            for b0 in range(0, B, block):
                part = _block_loss(P, cfg, batch, (b0, min(B, b0 + block)), draws, precision,
                                   counts, outputs)
                part.backward()
                loss += float(part.detach())
                draws.rewind()
            out["losses"].append(loss)
            if k == 0:
                out["logits"] = torch.cat([torch.cat([o_[i] for o_ in outputs]).flatten()
                                           for i in (0, 1)])
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for n, p in params.items()}
            if k == 0:
                out["grad_norms"] = {n: float(g.norm()) for n, g in grads.items()}
            with torch.no_grad():
                opt.step(params, grads, schedule.lr_at(o, first_iter + k))
    with torch.no_grad():
        out["change_norms"] = {n: float((params[n] - P0[n]).norm()) for n in params}
    return out
