"""The port's spans (avt_tpu_torch/utils/trace.py) under a CPU
torch.profiler: a train step with a VideoPreprocessor, an SSL step, a
`batch_predict` and two chunks and a tail of the train loop emit exactly
their `avt.` spans, nested as each step or request holds its phases; the
spans are function-scope ranges (no device mirror), open nothing with no
profiler running, enter no exported program, and leave every number a
step returns unchanged. The port opens ranges through trace.py alone."""
import functools
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avt_tpu_torch.data.transforms import VideoPreprocessor
from avt_tpu_torch.losses import MultiDimSimclrInfoNCE, mse
from avt_tpu_torch.models import (
    AVTh,
    AVTModel,
    IdentityAgg,
    IdentityBackbone,
    IdentityFuture,
    LinearClassifier,
    MeanAgg,
    ViT,
)
from avt_tpu_torch.ops import _build
from avt_tpu_torch.serve import batch_predict, export_eval_forward, make_eval_forward
from avt_tpu_torch.train import build_optimizer, make_multi_step, make_ssl_train_step
from avt_tpu_torch.train import make_train_step
from avt_tpu_torch.train.loop import train_one_epoch
from avt_tpu_torch.utils import trace
from avt_tpu_torch.utils.device import upload

ROOT = Path(__file__).resolve().parents[1]
N_CLS, B, T, C = 5, 2, 3, 16
FRAMES = (36, 48, 3)
LOSS_WTS = {"cls_action": 1.0, "past_cls_action": 1.0, "feat": 1.0}
OPT = dict(lr_wd=[["__all__", 0.1, 1e-4]], optimizer_name="sgd", scheduler_name="cosine",
           iters_per_epoch=5, num_epochs=3, warmup_epochs=1,
           optimizer_kwargs={"nesterov": True, "momentum": 0.9})


def _avt(backbone, width):
    """AVT with dropout on: `backbone`, a 1-layer AVT-h, a linear classifier."""
    head = AVTh(in_features=width, inter_dim=16, n_layer=1, n_head=2, n_positions=16,
                embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1, output_len=1, avg_last_n=1,
                return_past_too=True, future_pred_loss=functools.partial(mse, reduction="none"))
    return AVTModel(backbone=backbone, temporal_aggregator=IdentityAgg(in_features=width),
                    future_predictor=head,
                    temporal_aggregator_after_future_pred=IdentityAgg(in_features=width),
                    classifiers={"action": LinearClassifier(width, N_CLS)},
                    num_classes=(("action", N_CLS),), backbone_dim=width, dropout=0.2,
                    classifier_on_past=True)


def _flagship():
    torch.manual_seed(0)
    return _avt(ViT(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                    mlp_ratio=2, device="cpu"), 32)


def _features_model():
    torch.manual_seed(0)
    return _avt(IdentityBackbone(), C)


def _preprocessor(train: bool):
    common = dict(crop_size=32, scale_w=-1, mean=(0.5,) * 3, std=(0.5,) * 3, device="cpu")
    if train:
        return VideoPreprocessor(scale_h="33-38", **common)
    return VideoPreprocessor(scale_h=34, eval_num_crops=3, eval_flip_crops=True, **common)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, T) + FRAMES, dtype=np.uint8)


def _targets(n, seed=1):
    rng = np.random.default_rng(seed)
    return ({"action": torch.from_numpy(rng.integers(0, N_CLS, n))},
            {"action": torch.from_numpy(rng.integers(0, N_CLS, (n, T)))})


def _video_step():
    model = _flagship()
    opt, _ = build_optimizer(model, **OPT)
    pp = _preprocessor(train=True)

    def preprocess(clips, generator):
        return pp.train_fn(clips, generator).transpose(1, 2)[:, :, :, None]

    step = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS}, preprocess_fn=preprocess)
    target, tsub = _targets(B)
    batch = {"video": torch.from_numpy(_frames(B)), "target": target,
             "target_subclips": tsub}
    return model, lambda: step(batch, torch.Generator().manual_seed(3))


def _ssl_step():
    torch.manual_seed(0)
    model = AVTModel(backbone=IdentityBackbone(), temporal_aggregator=MeanAgg(C),
                     future_predictor=IdentityFuture(C),
                     temporal_aggregator_after_future_pred=IdentityAgg(C),
                     classifiers={"action": LinearClassifier(C, N_CLS)},
                     num_classes=(("action", N_CLS),), backbone_dim=C, project_dim_for_nce=8)
    opt, _ = build_optimizer(model, **OPT)
    crit = MultiDimSimclrInfoNCE(temperature=0.1)
    step = make_ssl_train_step(model, opt, {"cls_action": 1.0, "reg": 1.0}, {"action": N_CLS},
                               crit, nfutures=1)
    g = torch.Generator().manual_seed(4)
    batch = {"video": torch.randn((B, 1, C, T, 1, 1), generator=g),
             "future_0_video": torch.randn((B, 1, C, T, 1, 1), generator=g),
             "target": _targets(B)[0]}
    return model, lambda: step(batch, torch.Generator().manual_seed(3))


def _serve():
    model = _flagship().eval()
    fwd = make_eval_forward(model, _preprocessor(train=False))
    frames = _frames(3)
    return model, lambda: batch_predict(fwd, frames, batch_size=2)


class _Loader:
    """5 feature batches an epoch."""

    def __init__(self):
        rng = np.random.default_rng(2)
        self.batches = [{"video": rng.standard_normal((B, T, C, 1, 1, 1)).astype(np.float32),
                         "target": {"action": rng.integers(0, N_CLS, B)},
                         "target_subclips": {"action": rng.integers(0, N_CLS, (B, T))}}
                        for _ in range(5)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _loop():
    model = _features_model()
    opt, _ = build_optimizer(model, **OPT)
    step = make_train_step(model, opt, LOSS_WTS, {"action": N_CLS})
    loader = _Loader()
    return model, lambda: train_one_epoch(step, model, opt, loader, epoch=0,
                                          multi_step=make_multi_step(step, 2), unroll_steps=2,
                                          print_freq=100, print_large_freq=0)


TRAIN_PHASES = {("avt.train.forward", "avt.train.step"): 1,
                ("avt.train.backward", "avt.train.step"): 1,
                ("avt.train.optimizer", "avt.train.step"): 1, ("avt.train.step", None): 1}
CASES = {
    "train": (_video_step, {**TRAIN_PHASES, ("avt.preprocess.train", "avt.train.step"): 1}),
    "ssl": (_ssl_step, TRAIN_PHASES),
    "serve": (_serve, {("avt.serve.request", None): 1,
                       ("avt.preprocess.eval", "avt.serve.request"): 2,
                       ("avt.serve.forward", "avt.serve.request"): 2,
                       ("avt.serve.download", "avt.serve.request"): 2}),
    # 5 batches in chunks of 2: two chunks and a tail of 1, then the empty wait
    "loop": (_loop, {**{k: 5 * n for k, n in TRAIN_PHASES.items()},
                     ("avt.loop.data_wait", None): 4, ("avt.loop.drain", None): 3}),
}


def _spans(fn):
    """(name, parent span's name or None) of each avt. range `fn` opens
    under a CPU profiler, with their events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [e for e in prof.events() if e.name.startswith("avt.")]
    found = Counter()
    for e in events:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("avt."):
            parent = parent.cpu_parent
        found[(e.name, parent.name if parent is not None else None)] += 1
    return found, events


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_and_their_nesting(case):
    build, want = CASES[case]
    _, run = build()
    found, events = _spans(run)
    assert found == Counter(want)
    # function-scope ranges: Kineto gives them no device mirror
    assert not any(e.is_user_annotation for e in events)


@pytest.mark.parametrize("case", ["train", "ssl", "serve"])
def test_spans_change_no_number(case):
    """The same step or request with the profiler's spans and without:
    its outputs, the parameters after it and the kernel launch counts
    equal bit for bit."""
    build = CASES[case][0]
    results = []
    for traced in (True, False):
        _build.reset_launch_counts()
        model, run = build()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                out = run()
        else:
            out = run()
        results.append((out, {k: p.detach().clone() for k, p in model.named_parameters()},
                        dict(_build.launch_counts)))
    (out_a, params_a, launches_a), (out_b, params_b, launches_b) = results
    assert out_a.keys() == out_b.keys() and launches_a == launches_b
    for k in out_a:
        assert np.array_equal(np.asarray(out_a[k]), np.asarray(out_b[k])), k
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k


def test_no_profiler_opens_nothing(monkeypatch):
    assert trace.span("avt.train.step") is trace.OFF
    with trace.OFF as entered:
        assert entered is trace.OFF

    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    for case in ("train", "serve"):
        CASES[case][0]()[1]()


@pytest.mark.parametrize("frames,device,opened", [
    pytest.param("numpy", "meta", 1, id="host-to-device"),
    pytest.param("numpy", "cpu", 0, id="host-stays"),
    pytest.param("meta", "meta", 0, id="on-the-device"),
])
def test_upload_span_only_for_a_copy_from_the_host(frames, device, opened):
    x = np.zeros((2, 3), np.uint8)
    if frames == "meta":
        x = torch.from_numpy(x).to("meta")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = upload(x, device)
    assert out.device.type == device and tuple(out.shape) == (2, 3)
    assert sum(e.name == "avt.preprocess.upload" for e in prof.events()) == opened


def _export(model, pp):
    return export_eval_forward(model, (2, T) + FRAMES, preprocessor=pp, platforms=["cpu"])


@pytest.mark.parametrize("against", ["span_off", "profiler_running"])
def test_export_holds_no_span(monkeypatch, against):
    """An exported serving program holds no profiler op, and equals (graph
    and outputs, bit for bit) one exported with `trace.span` patched to its
    no-op, or one exported while a profiler runs."""
    model, pp = _flagship().eval(), _preprocessor(train=False)
    program = _export(model, pp)
    if against == "span_off":
        monkeypatch.setattr(trace, "span", lambda name: trace.OFF)
        other = _export(model, pp)
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            other = _export(model, pp)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert str(program.graph) == str(other.graph)
    frames = torch.from_numpy(_frames(2, seed=7))
    a, b = program.module()(frames), other.module()(frames)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_the_port_opens_ranges_through_trace_alone():
    opener = re.compile(r"record_function|_RecordFunctionFast|profiler\.profile")
    offenders = [str(f.relative_to(ROOT)) for f in (ROOT / "avt_tpu_torch").rglob("*.py")
                 if opener.search(f.read_text()) and f.name != "trace.py"]
    assert offenders == []


def test_count_is_a_no_op_without_a_profiler():
    trace.count("avt.test.n", torch.tensor(3))
    trace.count("avt.test.m", 2)
    assert trace.counters() == {}


def test_count_accumulates_under_a_profiler_with_no_host_read(monkeypatch):
    """Device values add on the device, numbers on the host; nothing is read
    back until `counters()`, which resets them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a counter read a tensor back inside the pass")

    with profile(activities=[ProfilerActivity.CPU]):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__float__", "__int__", "cpu"):
                m.setattr(torch.Tensor, name, refuse)
            for v in (3, 4):
                trace.count("avt.test.n", torch.tensor(v))
                trace.count("avt.test.m", v)
    assert trace.counters() == {"avt.test.n": 7.0, "avt.test.m": 7.0}
    assert trace.counters() == {}


def _mla_moe_head():
    from avt_tpu_torch.models import MLAMoECore
    from avt_tpu_torch.models.mla_moe import init_mla_moe_

    core = MLAMoECore(hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
                      kv_lora_rank=8, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                      intermediate_size=32, moe_intermediate_size=8, n_router_experts=8,
                      experts_held=4, expert_rank=1, num_experts_per_tok=2)
    init_mla_moe_(core, 0.2, torch.Generator().manual_seed(0))
    return AVTh(in_features=C, inter_dim=16, output_len=1, avg_last_n=1, return_past_too=True,
                core=core)


def test_moe_and_mla_spans_and_counters():
    """Each layer's attention opens avt.mla and each MoE FFN avt.moe (the
    dense first layer none); the MoE layers count their tokens, the pairs
    routed to the held experts and the largest expert's pairs."""
    head = _mla_moe_head()
    feats = torch.randn(B, 5, C, generator=torch.Generator().manual_seed(1))
    found, _ = _spans(lambda: head(feats))
    assert found == Counter({("avt.mla", None): 3, ("avt.moe", None): 2})
    counted = trace.counters()
    assert counted["avt.moe.tokens"] == 2 * B * 5
    assert 0 < counted["avt.moe.pairs_max"] <= counted["avt.moe.pairs_held"] <= 2 * B * 5 * 2
    head(feats)  # no profiler: nothing counted
    assert trace.counters() == {}
