"""The Moonlight-16B-A3B decoder as AVT-h's core (models/mla_moe.py) at tiny
widths on the CPU, held to the plain reference tests/plain_mla_moe.py: the
latent attention, RoPE against DeepSeek-V3's de-interleaved form, the
router, the grouped dispatch against the dense experts, the whole head's
forward and gradients, the experts' shares against the uncut layer, the
config, and the flash kernels' plain versions at two head widths."""
import functools
import math
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

import plain_mla_moe as plain
from avt_tpu_torch import train_net
from avt_tpu_torch.config import Composer, parse_override, parse_overrides_file
from avt_tpu_torch.config.build import build_model
from avt_tpu_torch.losses.mse import mse
from avt_tpu_torch.models import AVTh, MLAMoECore
from avt_tpu_torch.models import mla_moe
from avt_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
CFG = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=16,
           qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, intermediate_size=48,
           moe_intermediate_size=16, n_router_experts=8, experts_held=8, expert_rank=0,
           num_experts_per_tok=3, n_shared_experts=2, routed_scaling_factor=2.446,
           first_k_dense_replace=1, rope_theta=50000.0, rms_norm_eps=1e-5)


def _core(seed=0, **over):
    cfg = {**CFG, **over}
    core = MLAMoECore(**cfg)
    gen = torch.Generator().manual_seed(seed)
    mla_moe.init_mla_moe_(core, 0.2, gen)
    with torch.no_grad():  # norms and the choice bias away from their defaults
        for name, p in core.named_parameters():
            if name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        for b in core.buffers():
            b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    return core, cfg


def _params(module):
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def _close(got, want, tol):
    assert float((got - want).detach().norm() / want.detach().norm()) < tol


def test_latent_attention_matches_plain():
    core, cfg = _core()
    a = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(1))
    positions = torch.arange(3, 12)
    got = core.layers[0].self_attn(a, positions)
    want = plain.latent_attention(_params(core), "layers.0.self_attn.", a, positions, cfg,
                                  torch.matmul)
    _close(got, want, 1e-6)


def test_rope_matches_deinterleaved_form():
    """The pairs rotated in place give DeepSeek-V3's de-interleaved vectors
    permuted alike for q and k: the same scores."""
    g = torch.Generator().manual_seed(2)
    q, k = torch.randn(2, 7, 3, 16, generator=g), torch.randn(2, 7, 1, 16, generator=g)
    pos = torch.arange(40, 47)
    ours = [mla_moe.rope(x, pos, 50000.0) for x in (q, k)]
    theirs = [plain.rope_deinterleaved(x, pos, 50000.0) for x in (q, k)]
    perm = torch.cat([torch.arange(0, 16, 2), torch.arange(1, 16, 2)])
    for o, t in zip(ours, theirs):
        torch.testing.assert_close(o[..., perm], t, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ours[0] @ ours[1].transpose(-1, -2),
                               theirs[0] @ theirs[1].transpose(-1, -2), rtol=1e-5, atol=1e-5)


def test_routing_bias_normalisation_scaling():
    """The bias picks the experts and weighs nothing; the weights are the
    chosen sigmoid scores normalised and scaled; the scores are f32 from a
    bf16 input."""
    core, cfg = _core()
    moe = core.layers[1].mlp
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        moe.gate.e_score_correction_bias.copy_(torch.tensor([0, 0, 0, 0, 0, 0, 5.0, 5.0]))
    w, slot = moe.route(x)
    assert ((slot == 6) | (slot == 7)).any(dim=1).all()  # the bias forces both into the choice
    s = torch.sigmoid(x @ moe.gate.weight.t())
    chosen = s.gather(1, slot)
    torch.testing.assert_close(w, 2.446 * chosen / chosen.sum(-1, keepdim=True))
    torch.testing.assert_close(w.sum(-1), torch.full((64,), 2.446))
    want, _ = plain.route(_params(core), "layers.1.mlp.", x, cfg)
    torch.testing.assert_close(torch.zeros_like(want).scatter(1, slot, w), want)
    wb, slot_b = moe.route(x.bfloat16())
    assert wb.dtype == torch.float32
    torch.testing.assert_close(wb, moe.route(x.bfloat16().float())[0], rtol=0, atol=0)


def _dense_experts(a, w, slot, wg, wu, wd):
    out = torch.zeros(a.shape, dtype=torch.float32)
    for j in range(slot.shape[1]):
        for e in range(wg.shape[0]):
            y = plain.swiglu(a, wg[e], wu[e], wd[e], torch.matmul)
            out = out + torch.where((slot[:, j] == e)[:, None], w[:, j, None] * y, 0.0)
    return out


def test_grouped_dispatch_matches_dense_experts():
    """Uneven groups, an empty expert and choices held elsewhere (slot 4):
    the forward, every gradient and a repeat's bits."""
    g = torch.Generator().manual_seed(4)
    N, k, E, C, hidden = 11, 3, 4, 16, 8
    slot = torch.tensor([0, 0, 1, 3, 4, 0, 4, 4, 3, 1, 0] * 3).reshape(k, N).t().contiguous()
    assert not (slot == 2).any()
    leaves = [torch.randn(N, C, generator=g), torch.rand(N, k, generator=g),
              0.3 * torch.randn(E, hidden, C, generator=g),
              0.3 * torch.randn(E, hidden, C, generator=g),
              0.3 * torch.randn(E, C, hidden, generator=g)]
    a, w, wg, wu, wd = [x.requires_grad_() for x in leaves]
    out = mla_moe._HeldExperts.apply(a, w, slot, wg, wu, wd)
    again = mla_moe._HeldExperts.apply(a, w, slot, wg, wu, wd)
    assert torch.equal(out, again)
    ref = _dense_experts(a, w, slot, wg, wu, wd)
    _close(out, ref, 1e-6)
    r = torch.randn(N, C, generator=g)
    got = torch.autograd.grad((out * r).sum(), [a, w, wg, wu, wd])
    want = torch.autograd.grad((ref * r).sum(), [a, w, wg, wu, wd])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    assert got[2][2].abs().max() == 0  # the empty expert


def _head(core):
    head = AVTh(in_features=24, inter_dim=32, output_len=1, avg_last_n=1,
                return_past_too=True, future_pred_loss=functools.partial(mse, reduction="none"),
                core=core)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lin in (head.encoder, head.decoder):
            lin.weight.normal_(std=0.2, generator=gen)
    return head


def test_head_forward_and_gradients_match_plain():
    """AVT-h with the core: the past, the future, the feature loss and every
    gradient against the plain reference, in f32, at 2e-5."""
    core, cfg = _core(seed=6)
    head = _head(core).train()
    feats = torch.randn(3, 8, 24, generator=torch.Generator().manual_seed(7))
    past, future, losses, _ = head(feats)
    P = _params(core)
    enc, dec = head.encoder.weight, head.decoder.weight
    decoded = plain.core(P, feats @ enc.t(), cfg) @ dec.t()
    torch.testing.assert_close(future, decoded[:, -1:].mean(1), rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(past, torch.cat([feats[:, :1], decoded[:, :-1]], 1),
                               rtol=2e-5, atol=2e-6)
    want_loss = (decoded[:, :-1] - feats[:, 1:]) ** 2
    torch.testing.assert_close(losses["feat"], want_loss, rtol=2e-5, atol=2e-6)
    r = torch.randn(future.shape, generator=torch.Generator().manual_seed(8))
    leaves = [p for p in head.parameters()]
    got = torch.autograd.grad(losses["feat"].sum() + (future * r).sum(), leaves)
    want = torch.autograd.grad(want_loss.sum() + (decoded[:, -1] * r).sum(), leaves)
    for (name, _), x, y in zip(head.named_parameters(), got, want):
        assert float((x - y).norm()) <= 2e-5 * float(y.norm()) + 1e-7, name


def test_shares_of_the_experts_add_up_to_the_uncut_layer():
    """8 experts in 4 shares of 2: each share's routed part, plus the shared
    experts once, is the uncut layer."""
    core, cfg = _core(seed=9)
    full = core.layers[1].mlp
    x = torch.randn(2, 10, 32, generator=torch.Generator().manual_seed(10))
    shared = full.shared_experts(x)
    total = shared.clone()
    for rank in range(4):
        part = mla_moe.MoE(32, 16, 8, 2, rank, 3, 2, 2.446)
        state = {n: (v[2 * rank:2 * rank + 2] if n.startswith("experts.") else v)
                 for n, v in full.state_dict().items()}
        part.load_state_dict(state)
        total = total + (part(x) - shared)
    _close(total, full(x), 1e-6)
    want = plain.moe(_params(core), "layers.1.mlp.", x, cfg, torch.matmul)
    _close(full(x), want, 1e-6)


def test_config_composes_and_builds():
    """expts/02 with model/future_predictor=avth_mla_moe: Moonlight's
    published sizes with 13 layers and 8 held experts, bf16; at tiny widths
    it builds through build_model and trains a step."""
    expt = parse_overrides_file(str(ROOT / "expts" / "02_ek100_avt_tsn.txt"))
    composer = Composer(train_net.CONF_DIR)
    cfg = composer.compose("config", expt + [parse_override("model/future_predictor=avth_mla_moe")])
    fp = cfg["model"]["future_predictor"]
    assert fp["inter_dim"] == 2048 and fp["dtype"] == "bfloat16"
    assert {k: fp["core"][k] for k in ("num_hidden_layers", "n_router_experts", "experts_held",
                                       "num_experts_per_tok", "kv_lora_rank")} == \
        {"num_hidden_layers": 13, "n_router_experts": 64, "experts_held": 8,
         "num_experts_per_tok": 6, "kv_lora_rank": 512}
    tiny = [f"model.future_predictor.core.{k}={v}" for k, v in CFG.items()
            if k not in ("hidden_size",)] + ["+model.future_predictor.inter_dim=32",
                                              "model.backbone_dim=24"]
    cfg = composer.compose("config", expt + [parse_override(o) for o in
                                             ["model/future_predictor=avth_mla_moe"] + tiny])
    model = build_model(cfg, {"action": 11}, {}, device="cpu")
    core = model.future_predictor.core()
    assert isinstance(core, MLAMoECore) and core.dtype == torch.bfloat16
    assert core.layers[1].mlp.experts.gate_proj.shape == (8, 16, 32)
    model.train()
    video = torch.randn(2, 6, 24, 1, 1, 1)
    outputs, losses = model(video)
    loss = outputs["logits/action"].float().logsumexp(-1).sum() + losses["feat"].float().sum()
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.future_predictor.parameters())


def test_train_net_trains_the_head(tmp_path, monkeypatch):
    """`train_net.cli` with expts/02's file and
    model/future_predictor=avth_mla_moe (tiny widths, on the CPU): the
    model it builds has the MLA-MoE core, one epoch trains and evaluates."""
    monkeypatch.setenv("AVT_PLATFORM", "cpu")
    tree = chip_smoke.write_ek100_tree(str(tmp_path / "ek100"), train_videos=2, eval_videos=1,
                                       actions_per_video=4, first_action_s=12, dim=24, seed=3)
    tiny = [f"model.future_predictor.core.{k}={v}" for k, v in CFG.items() if k != "hidden_size"]
    built = []
    real = train_net.build_model

    def recorded(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    with mock.patch.object(train_net, "build_model", recorded):
        (metric,) = train_net.cli(
            ["--config-file", str(ROOT / "expts" / "02_ek100_avt_tsn.txt"), "--run-dir",
             str(tmp_path / "run"), "model/future_predictor=avth_mla_moe"] + tree + tiny
            + ["model.backbone_dim=24", "+model.future_predictor.inter_dim=32",
               "train.batch_size=4", "eval.batch_size=4", "train.num_epochs=1",
               "data_train.workers=0", "data_eval.workers=0"])
    assert math.isfinite(metric)
    core = built[0].future_predictor.core()
    assert isinstance(core, MLAMoECore) and core.dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_versions_at_two_widths(causal):
    """The kernels' plain versions at (q, k) 24 wide and v 16 wide over 130
    keys (two 128-key blocks): against float64 attention with scale
    1/sqrt(24), and its gradients."""
    g = torch.Generator().manual_seed(11)
    q, k = torch.randn(2, 130, 2, 24, generator=g), torch.randn(2, 130, 2, 24, generator=g)
    v, dout = torch.randn(2, 130, 2, 16, generator=g), torch.randn(2, 130, 2, 16, generator=g)
    out, lse = tfa.flash_attention_reference(q, k, v, causal)
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / math.sqrt(24)
    if causal:
        s = s.masked_fill(~torch.ones(130, 130, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)
    assert out.shape == (2, 130, 2, 16)
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1), rtol=1e-5, atol=1e-5)
    grads = tfa.flash_attention_bwd_reference(q, k, v, dout, out, lse, causal)
    wants = torch.autograd.grad(want, (q64, k64, v64), dout.double())
    for x, y in zip(grads, wants):
        assert x.shape == y.shape
        torch.testing.assert_close(x.double(), y, rtol=1e-4, atol=1e-4)
    got = tfa.flash_attention(q.requires_grad_(), k, v, causal)
    torch.testing.assert_close(got, out)
