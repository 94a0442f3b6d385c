"""Plain PyTorch reference of AVT (Girdhar & Grauman, ICCV'21): the
frame-level ViT (AVT-b), the causal GPT-2 head (AVT-h), the linear action
classifier, the losses and the train and eval preprocessing; the
optimizer and the LR schedule are the configuration's, from
portbench/optimizers and portbench/schedules.

Written from the published architecture and the benchmark's configuration
files, with no import of the measured program: parameters are a dict of
f32 tensors under the checkpoint names both sides load (timm's ViT,
HF GPT-2's Conv1D layout (in, out)), every product is one `mm` whose
operands `precision` may round ("f32"; the controls' "tf32", "bf16",
"fp8"), and attention is the softmax written out. Train-mode randomness
(the crop and flip draws, the dropout masks) is read from `draws`, a
callable that hands out the benchmark's draws in the order a step consumes
them, so that both sides see the same ones.
"""
from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


# ------------------------------------------------------------------ layout
def param_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every parameter: the layout and the
    distribution the benchmark draws its weights from."""
    A, C_in = model["num_actions"], model["backbone_dim"]
    specs = []
    if model["backbone"] == "avt_b":
        E, P, L = model["vit_width"], model["patch_size"], model["vit_depth"]
        n_tok = (model["img_size"] // P) ** 2 + 1
        hidden = E * model["vit_mlp_ratio"]
        vit = "backbone.model."
        specs += [(vit + "cls_token", (1, 1, E), 0.0, 0.02),
                  (vit + "pos_embed", (1, n_tok, E), 0.0, 0.02),
                  (vit + "patch_embed.proj.weight", (E, 3, P, P), 0.0, (3 * P * P) ** -0.5),
                  (vit + "patch_embed.proj.bias", (E,), 0.0, 0.01)]
        for i in range(L):
            b = f"{vit}blocks.{i}."
            specs += [(b + "norm1.weight", (E,), 1.0, 0.02), (b + "norm1.bias", (E,), 0.0, 0.02),
                      (b + "attn.qkv.weight", (3 * E, E), 0.0, 0.02),
                      (b + "attn.qkv.bias", (3 * E,), 0.0, 0.01),
                      (b + "attn.proj.weight", (E, E), 0.0, 0.02),
                      (b + "attn.proj.bias", (E,), 0.0, 0.01),
                      (b + "norm2.weight", (E,), 1.0, 0.02), (b + "norm2.bias", (E,), 0.0, 0.02),
                      (b + "mlp.fc1.weight", (hidden, E), 0.0, 0.02),
                      (b + "mlp.fc1.bias", (hidden,), 0.0, 0.01),
                      (b + "mlp.fc2.weight", (E, hidden), 0.0, 0.02),
                      (b + "mlp.fc2.bias", (E,), 0.0, 0.01)]
        specs += [(vit + "norm.weight", (E,), 1.0, 0.02), (vit + "norm.bias", (E,), 0.0, 0.02)]
    D, n_pos = model["inter_dim"], model["n_positions"]
    fp = "future_predictor."
    specs += [(fp + "encoder.weight", (D, C_in), 0.0, 0.02),
              (fp + "decoder.weight", (C_in, D), 0.0, 0.02),
              (fp + "gpt_model.wpe.weight", (n_pos, D), 0.0, 0.02)]
    for i in range(model["n_layer"]):
        h = f"{fp}gpt_model.h.{i}."
        specs += [(h + "ln_1.weight", (D,), 1.0, 0.02), (h + "ln_1.bias", (D,), 0.0, 0.02),
                  (h + "attn.c_attn.weight", (D, 3 * D), 0.0, 0.02),
                  (h + "attn.c_attn.bias", (3 * D,), 0.0, 0.01),
                  (h + "attn.c_proj.weight", (D, D), 0.0, 0.02),
                  (h + "attn.c_proj.bias", (D,), 0.0, 0.01),
                  (h + "ln_2.weight", (D,), 1.0, 0.02), (h + "ln_2.bias", (D,), 0.0, 0.02),
                  (h + "mlp.c_fc.weight", (D, 4 * D), 0.0, 0.02),
                  (h + "mlp.c_fc.bias", (4 * D,), 0.0, 0.01),
                  (h + "mlp.c_proj.weight", (4 * D, D), 0.0, 0.02),
                  (h + "mlp.c_proj.bias", (D,), 0.0, 0.01)]
    specs += [(fp + "gpt_model.ln_f.weight", (D,), 1.0, 0.02),
              (fp + "gpt_model.ln_f.bias", (D,), 0.0, 0.02),
              ("classifiers.action.weight", (A, C_in), 0.0, 0.02),
              ("classifiers.action.bias", (A,), 0.0, 0.01)]
    return specs


# ------------------------------------------------------------- precision
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, to nearest (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as a product operand of `precision`, back in f32."""
    if precision == "f32":
        return x
    if precision == "tf32":
        return _tf32(x.float())
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":  # per-tensor scale to the format's range
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with each operand of the forward and the backward products
    rounded to `precision`."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return torch.matmul(quantize(a, precision), quantize(b, precision))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        gq = quantize(g, p)
        ga = torch.matmul(gq, quantize(b, p).transpose(-1, -2))
        gb = torch.matmul(quantize(a, p).transpose(-1, -2), gq)
        if gb.dim() > b.dim():  # b was broadcast over a's leading dims
            gb = gb.reshape(-1, *b.shape).sum(0)
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, precision)


# ----------------------------------------------------------------- layers
def _linear(x, w, b, precision, in_out=False):
    """x @ W (+ b); W is (out, in), or (in, out) with in_out."""
    y = mm(x, w if in_out else w.t(), precision)
    return y if b is None else y + b


def _layer_norm(x, P, name, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def _attention(q, k, v, causal, precision):
    """softmax(q k^T / sqrt(D)) v over (N, H, T, D) tensors."""
    s = mm(q, k.transpose(-1, -2), precision) / math.sqrt(q.shape[-1])
    if causal:
        T = s.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v, precision)


def _split_heads(x, H):
    N, T, C = x.shape
    return x.reshape(N, T, H, C // H).transpose(1, 2)


def _merge_heads(x):
    N, H, T, D = x.shape
    return x.transpose(1, 2).reshape(N, T, H * D)


def _dropout(x, rate, draw):
    """Keep where the draw is >= rate, kept values divided by 1 - rate."""
    if draw is None or rate == 0.0:
        return x
    return torch.where(draw >= rate, x / (1.0 - rate), torch.zeros_like(x))


def vit_features(P: Params, model: dict, frames: torch.Tensor, precision: str) -> torch.Tensor:
    """(N, 3, S, S) normalised frames -> (N, width) class tokens after the
    final LayerNorm (no dropout: drop_rate is 0 in every configuration)."""
    E, patch, H = model["vit_width"], model["patch_size"], model["vit_heads"]
    vit = "backbone.model."
    w = P[vit + "patch_embed.proj.weight"].reshape(E, -1)
    patches = F.unfold(frames, patch, stride=patch).transpose(1, 2)  # (N, L, 3*p*p)
    x = _linear(patches, w, P[vit + "patch_embed.proj.bias"], precision)
    cls = P[vit + "cls_token"].expand(x.shape[0], 1, E)
    x = torch.cat([cls, x], dim=1) + P[vit + "pos_embed"]
    gelu = model["vit_gelu"]
    for i in range(model["vit_depth"]):
        b = f"{vit}blocks.{i}."
        h = _layer_norm(x, P, b + "norm1", 1e-6)
        qkv = _linear(h, P[b + "attn.qkv.weight"], P[b + "attn.qkv.bias"], precision)
        q, k, v = (_split_heads(t, H) for t in qkv.chunk(3, dim=-1))
        a = _merge_heads(_attention(q, k, v, False, precision))
        x = x + _linear(a, P[b + "attn.proj.weight"], P[b + "attn.proj.bias"], precision)
        h = _layer_norm(x, P, b + "norm2", 1e-6)
        h = F.gelu(_linear(h, P[b + "mlp.fc1.weight"], P[b + "mlp.fc1.bias"], precision),
                   approximate=gelu)
        x = x + _linear(h, P[b + "mlp.fc2.weight"], P[b + "mlp.fc2.bias"], precision)
    x = _layer_norm(x, P, vit + "norm", 1e-6)
    return x[:, 0]


def avth_heads(P: Params, model: dict, feats: torch.Tensor, precision: str,
               draw: Optional[Callable] = None):
    """AVT-h over (B, T, C) frame features with output_len 1, avg_last_n 1,
    past classification: (logits (B, A), past logits (B, T, A), feat loss
    elements (B, T-1, C)). `draw(shape)` gives the next dropout draw in
    train mode (None: eval)."""
    fp, pd = "future_predictor.gpt_model.", model["gpt_pdrop"]
    H = model["n_head"]
    B, T, _ = feats.shape
    nxt = (lambda shape: draw(shape)) if draw is not None else (lambda shape: None)
    x = _linear(feats, P["future_predictor.encoder.weight"], None, precision)
    x = x + P[fp + "wpe.weight"][:T]
    x = _dropout(x, pd, nxt(x.shape))
    for i in range(model["n_layer"]):
        h_ = f"{fp}h.{i}."
        h = _layer_norm(x, P, h_ + "ln_1", 1e-5)
        qkv = _linear(h, P[h_ + "attn.c_attn.weight"], P[h_ + "attn.c_attn.bias"], precision,
                      in_out=True)
        q, k, v = (_split_heads(t, H) for t in qkv.chunk(3, dim=-1))
        a = _merge_heads(_attention(q, k, v, True, precision))
        a = _dropout(a, pd, nxt(a.shape))
        a = _linear(a, P[h_ + "attn.c_proj.weight"], P[h_ + "attn.c_proj.bias"], precision,
                    in_out=True)
        x = x + _dropout(a, pd, nxt(a.shape))
        h = _layer_norm(x, P, h_ + "ln_2", 1e-5)
        h = F.gelu(_linear(h, P[h_ + "mlp.c_fc.weight"], P[h_ + "mlp.c_fc.bias"], precision,
                           in_out=True), approximate="tanh")
        h = _linear(h, P[h_ + "mlp.c_proj.weight"], P[h_ + "mlp.c_proj.bias"], precision,
                    in_out=True)
        x = x + _dropout(h, pd, nxt(h.shape))
    x = _layer_norm(x, P, fp + "ln_f", 1e-5)
    decoded = _linear(x, P["future_predictor.decoder.weight"], None, precision)  # (B, T, C)
    feat_err = (decoded[:, :T - 1] - feats[:, 1:]) ** 2
    past = torch.cat([feats[:, :1], decoded[:, :T - 1]], dim=1)
    past = _dropout(past, model["dropout"], nxt(past.shape))
    w, b = P["classifiers.action.weight"], P["classifiers.action.bias"]
    past_logits = _linear(past, w, b, precision)
    future = _dropout(decoded[:, T - 1], model["dropout"], nxt(decoded[:, T - 1].shape))
    return _linear(future, w, b, precision), past_logits, feat_err


def _mode_over_frames(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The most frequent label of the last axis, the smallest on a tie, -1
    (ignore) counting as a label."""
    counts = F.one_hot(labels.long() + 1, num_classes + 1).sum(dim=-2)
    return counts.argmax(dim=-1) - 1


def _nll_sum(logits, target):
    """Summed cross entropy of the kept (target != -1) rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, target.clamp_min(0)[..., None])[..., 0]
    return torch.where(target >= 0, nll, torch.zeros_like(nll)).sum()


# ---------------------------------------------------------- preprocessing
def _scale_translate_weights(in_size, out_size, scale, shift):
    """(B, in, out) weights of a linear (triangle) resampling that maps
    input pixel x to scale * x - shift, the filter widened by 1 / scale when
    it shrinks (jax.image.scale_and_translate, method 'linear', antialias)."""
    dev = scale.device
    inv = (1.0 / scale)[:, None]
    sample = (torch.arange(out_size, device=dev) + 0.5) * inv + shift[:, None] * inv - 0.5
    width = torch.clamp_min(inv, 1.0)[:, None]
    pixels = torch.arange(in_size, device=dev, dtype=torch.float32)
    dist = sample[:, None, :] - pixels[None, :, None]
    w = torch.clamp_min(1.0 - (dist / width).abs(), 0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total > 1e-4, w / total.clamp_min(1e-30), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def train_frames(frames: torch.Tensor, pre: dict, draw: Callable,
                 precision: Sequence[str] = ("f32", "f32")) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (B, T, 3, S, S) normalised frames: per clip
    a smaller side s ~ floor(U[lo, hi + 1)), a crop offset (floor(U * room))
    in each axis, a flip with probability flip_p; the resize and crop as one
    resampling, then /255, the flip and the normalisation. `precision`:
    (the resampling's products' operands, the frames handed on) rounded."""
    B, T, H, W, _ = frames.shape
    lo, hi = pre["train_scale"]
    S = pre["crop"]
    s = torch.floor(draw((B,)) * (hi + 1.0 - lo) + lo)
    f = s / min(H, W)
    i = torch.floor(draw((B,)) * torch.clamp_min(H * f - S, 0.0))
    j = torch.floor(draw((B,)) * torch.clamp_min(W * f - S, 0.0))
    flip = draw((B,)) < pre["flip_p"]
    wh = _scale_translate_weights(H, S, f, i)  # (B, H, S)
    ww = _scale_translate_weights(W, S, f, j)
    q = lambda t: quantize(t, precision[0])  # noqa: E731
    x = torch.einsum("bthwc,bwj->bthjc", q(frames.float()), q(ww))
    x = torch.einsum("bthjc,bhi->btijc", q(x), q(wh)) / 255.0
    x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
    return quantize(_normalise(x, pre), precision[1]).permute(0, 1, 4, 2, 3)


def _normalise(x, pre):
    mean = torch.tensor(pre["mean"], device=x.device)
    std = torch.tensor(pre["std"], device=x.device)
    return (x - mean) / std


def eval_views(frames: torch.Tensor, pre: dict) -> List[torch.Tensor]:
    """(B, T, H, W, 3) uint8 -> the views (B, T, 3, S, S): the smaller side
    resized to eval_scale (bilinear, no antialias), three crops (top-left,
    centre, bottom-right) and their horizontal flips."""
    B, T, H, W, _ = frames.shape
    side, S = pre["eval_scale"], pre["crop"]
    f = side / min(H, W)
    nh, nw = max(int(H * f), side), max(int(W * f), side)
    x = frames.reshape(B * T, H, W, 3).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False) / 255.0
    x = x.reshape(B, T, 3, nh, nw)
    pos = [(0, 0), (int(round((nh - S) / 2.0)), int(round((nw - S) / 2.0))), (nh - S, nw - S)]
    crops = [x[..., a:a + S, b:b + S] for a, b in pos]
    crops += [c.flip(-1) for c in crops]
    mean = torch.tensor(pre["mean"], device=x.device)[:, None, None]
    std = torch.tensor(pre["std"], device=x.device)[:, None, None]
    return [(c - mean) / std for c in crops]


# ------------------------------------------------------------- the model
def clip_features(P, model, video, precision):
    """(B, T, 3, S, S) frames -> (B, T, width) through the ViT, or (B, T, C)
    features unchanged (identity backbone)."""
    if model["backbone"] != "avt_b":
        return video
    B, T = video.shape[:2]
    return vit_features(P, model, video.reshape((B * T,) + video.shape[2:]), precision).reshape(
        B, T, -1)


def eval_logits(P: Params, cfg: dict, frames: torch.Tensor, precision: str = "f32"
                ) -> torch.Tensor:
    """logits/action (B, A) of uint8 clips, averaged over the eval views."""
    model = cfg["model"]
    with torch.no_grad():
        logits = [avth_heads(P, model, clip_features(P, model, v, precision), precision)[0]
                  for v in eval_views(frames, cfg["preprocess"])]
    return torch.stack(logits).mean(dim=0)


def _block_loss(P, cfg, batch, rows, draws, precision, counts, outputs, pre_precision):
    """The step's loss restricted to `rows`, each term divided by its
    whole-batch count, so that the blocks' losses sum to the step's; the
    block's (past logits, logits, frames or None) go to `outputs`."""
    model = cfg["model"]
    b0, b1 = rows
    draw = draws.slice(b0, b1, batch["target"].shape[0])
    video, frames = batch["video"][b0:b1], None
    if model["backbone"] == "avt_b":
        video = frames = train_frames(video, cfg["preprocess"], draw, pre_precision)
    feats = clip_features(P, model, video, precision)
    logits, past_logits, feat_err = avth_heads(P, model, feats, precision, draw)
    past_target = _mode_over_frames(batch["target_subclips"][b0:b1], model["num_actions"])
    wts = cfg["loss_wts"]
    outputs.append((past_logits.detach(), logits.detach(),
                    None if frames is None else frames.detach().cpu()))
    return (wts["cls_action"] * _nll_sum(logits, batch["target"][b0:b1]) / counts[0]
            + wts["past_cls_action"] * _nll_sum(past_logits, past_target) / counts[1]
            + wts["feat"] * feat_err.sum() / counts[2])


def train_steps(P0: Params, cfg: dict, batches: Sequence[dict], draws_of: Callable,
                first_iter: int, precision: str = "f32",
                pre_precision: Sequence[str] = ("f32", "f32")) -> dict:
    """The configuration's train steps from weights P0 (copied), one per
    batch, the loss summed over blocks of `cfg['reference']['block_clips']`
    clips: {'losses': [step loss], 'grad_norms': {leaf: |g| of step 1},
    'change_norms': {leaf: |p_end - p0|}, 'logits': step 1's past logits
    then logits, flattened, 'frames': step 1's preprocessed frames (B, T,
    3, S, S) on the host, or None}. draws_of(k) gives step k's draws:
    `.slice(b0, b1, B)` a callable shape -> the next draw's rows b0:b1,
    `.rewind()` back to the first draw for the next block. `precision`
    rounds the model's products, `pre_precision` the preprocessing's
    products and its frames (train_frames)."""
    o = cfg["optimizer"]
    optimizer = importlib.import_module(f"portbench.optimizers.{o['name']}")
    schedule = importlib.import_module(f"portbench.schedules.{o['scheduler']}")
    P = {n: p.detach().clone().requires_grad_(True) for n, p in P0.items()}
    opt = optimizer.Reference(P, o)
    block = cfg["reference"]["block_clips"]
    out = {"losses": []}
    for k, batch in enumerate(batches):
        B, T = batch["target_subclips"].shape[:2]
        counts = (B, B * T, B * (T - 1) * cfg["model"]["backbone_dim"])
        draws = draws_of(k)
        loss, outputs = 0.0, []
        for p in P.values():
            p.grad = None
        for b0 in range(0, B, block):
            part = _block_loss(P, cfg, batch, (b0, min(B, b0 + block)), draws, precision, counts,
                               outputs, pre_precision)
            part.backward()
            loss += float(part.detach())
            draws.rewind()
        out["losses"].append(loss)
        if k == 0:
            out["logits"] = torch.cat([torch.cat([o[i] for o in outputs]).flatten()
                                       for i in (0, 1)])
            out["frames"] = (None if outputs[0][2] is None
                             else torch.cat([o[2] for o in outputs]))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in P.items()}
        if k == 0:
            out["grad_norms"] = {n: float(g.norm()) for n, g in grads.items()}
        with torch.no_grad():
            opt.step(P, grads, schedule.lr_at(o, first_iter + k))
    with torch.no_grad():
        out["change_norms"] = {n: float((P[n] - P0[n]).norm()) for n in P}
    return out
