#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (avt_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repo root, on a machine with a GPU

1. Card and build: prints the card's name and power limit, turns TF32 off,
   builds every kernel from the sources in the checkout (nvcc, sm_90a).
2. Kernels: holds each kernel against its plain PyTorch version at the
   serving path's shapes (tolerances below) and times both, the library call
   that computes the same function, and the card's bound for the work.
3. Serving: the full-width flagship (ViT-B/16 + AVT-h, 3806 actions, bf16)
   answers requests of uint8 clips through `batch_predict` at batch 4, 3
   crops + flips each; the logits must be finite, (n, 3806), the same for a
   clip in a full batch and in a padded tail, and close to the same model
   with plain attention; every kernel of the path must have been launched.
Prints one JSON line of kernel results, then {"ok": true, "device": ...}.
It also prints the device time of one batch-32 forward by kernel group.
Exits non-zero on any failure, and without a CUDA device.
"""
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from avt_tpu_torch import VideoPreprocessor, batch_predict, build_avt, make_eval_forward
from avt_tpu_torch.ops import _build
from avt_tpu_torch.ops import flash_attention as fa

# H100 SXM peaks (NVIDIA data sheet, dense): the bound is the larger of
# bytes over memory rate and operations over the type's peak rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor cores / FMA units
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
NUM_ACTIONS = 3806
VIT_BLOCKS = 12  # one packed-attention launch per ViT block per forward
BATCH = 4
CLIP = (10, 256, 342, 3)  # frames of one clip: T, H, W, RGB (bench.py's eval input)


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=10, reps=5):
    """Device time of one fn() call in ms: CUDA events around `iters` calls
    back to back (so host overhead hides behind the queue), median of `reps`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def attention_inputs(N, T, H, D, dtype, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((N, T, 3 * H * D), np.float32))
    bias = torch.from_numpy(rng.standard_normal(3 * H * D, np.float32))
    return qkv.to("cuda", dtype), bias.to("cuda")


def attention_bound_ms(N, T, H, D, dtype):
    s = torch.finfo(dtype).bits // 8
    C = H * D
    nbytes = (N * T * 3 * C + 3 * C + N * T * C) * s  # qkv, bias in; out
    flops = 4 * N * H * T * T * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_attention(N, T, H, D, dtype, causal, seed):
    """Kernel (bias form, as the ViT calls it) against the plain version."""
    qkv, bias = attention_inputs(N, T, H, D, dtype, seed)
    out = fa.packed_qkv_bias_attention(qkv, bias, H, causal)
    torch.cuda.synchronize()
    ref = fa.packed_short_attention_reference(qkv + bias.to(dtype), H, causal)
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out, ref, atol=TOL[dtype], rtol=TOL[dtype])
    log(f"short_attention_fwd N={N} T={T} H={H} D={D} {str(dtype)[6:]} causal={causal}: "
        f"max_abs_err={err:.3g} (tolerance {TOL[dtype]})")
    return err


def time_attention(N, T, H, D, dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(N, T, 3 * H * D, generator=gen, device="cuda", dtype=dtype)
    bias = torch.randn(3 * H * D, generator=gen, device="cuda")
    C = H * D
    q, k, v = (x.view(N, T, H, D).transpose(1, 2) for x in qkv.split(C, dim=-1))
    kernel_ms = cuda_ms(lambda: fa.packed_qkv_bias_attention(qkv, bias, H))
    plain_ms = cuda_ms(lambda: fa.packed_short_attention_reference(qkv + bias.to(dtype), H),
                       iters=2, reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound_ms, bound_by = attention_bound_ms(N, T, H, D, dtype)
    res = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"short_attention_fwd timing N={N} T={T} H={H} D={D}: "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in res.items()))
    return res


def kernel_group(name):
    low = name.lower()
    for key, group in (("short_attn", "attention kernel"), ("gemm", "matmul"),
                       ("nvjet", "matmul"), ("xmma", "matmul"), ("fprop", "conv"),
                       ("nchwtonhwc", "conv"), ("layer_norm", "layer norm"),
                       ("gelu", "gelu"), ("index", "resize gather"),
                       ("memcpy", "host-to-device copy"), ("copy", "copy/cast"),
                       ("cat", "copy/cast")):
        if key in low:
            return group
    return "other elementwise"


def profile_forward(fwd, batch):
    """Device time by kernel group over one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    batch_predict(fwd, batch, len(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        batch_predict(fwd, batch, len(batch))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    log(f"profile, batch {len(batch)}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.2f} ms ({100 * ms / busy_ms:.1f}% of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")
    t_start = time.time()

    # 1. card and build -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build()
    log(f"built {sorted(_build.KERNELS)} in {time.time() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 2. every kernel against its plain version -----------------------------
    main_err = check_attention(240, 197, 12, 64, torch.bfloat16, False, seed=0)
    check_attention(240, 197, 12, 64, torch.float32, False, seed=0)
    check_attention(4, 100, 4, 32, torch.bfloat16, True, seed=2)
    timing = time_attention(240, 197, 12, 64, torch.bfloat16)  # one serving batch
    bench_timing = time_attention(1920, 197, 12, 64, torch.bfloat16)  # bench eval batch

    # 3. serving: the full-width flagship through its entry points ----------
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_avt(num_actions=NUM_ACTIONS, vit_dtype=torch.bfloat16, generator=gen)
    pp = VideoPreprocessor(crop_size=224, scale_h=248, scale_w=-1, mean=(0.5,) * 3,
                           std=(0.5,) * 3, eval_num_crops=3, eval_flip_crops=True,
                           compute_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    fwd = make_eval_forward(model, pp)
    forwards = [0]

    def counted(chunk):
        forwards[0] += 1
        return fwd(chunk)

    clips = np.random.default_rng(0).integers(0, 256, size=(10,) + CLIP, dtype=np.uint8)
    batch_predict(fwd, clips[:BATCH], BATCH)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    requests = [(0, 4), (0, 8), (4, 10), (6, 10)]  # (4, 10) ends in a padded tail
    results, latencies = [], []
    _build.reset_launch_counts()
    t0 = time.time()
    for lo, hi in requests:
        t_req = time.time()
        results.append(batch_predict(counted, clips[lo:hi], BATCH)["logits/action"])
        latencies.append(time.time() - t_req)
    served_s = time.time() - t0
    launches = dict(_build.launch_counts)
    n_served = sum(hi - lo for lo, hi in requests)
    for (lo, hi), logits in zip(requests, results):
        check(logits.shape == (hi - lo, NUM_ACTIONS), f"logits shape {logits.shape}")
        check(np.isfinite(logits).all(), f"non-finite logits for clips {lo}:{hi}")
    want = VIT_BLOCKS * forwards[0]
    check(launches["short_attention_fwd"] == want, f"launches {launches}, want {want}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the serving path")
    # the same clip in a full batch and in a padded tail (and in two batches)
    tail_vs_full = np.abs(results[2][4:6] - results[3][2:4]).max()
    np.testing.assert_allclose(results[2][4:6], results[3][2:4], atol=1e-2, rtol=2e-2)
    np.testing.assert_allclose(results[1][:4], results[0], atol=1e-2, rtol=2e-2)
    np.testing.assert_allclose(results[2][:4], results[1][4:8], atol=1e-2, rtol=2e-2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"served {len(requests)} requests, {n_served} clips in {forwards[0]} forwards of "
        f"{BATCH} clips x 6 views x 10 frames; request latency s: "
        + ", ".join(f"{x:.4f}" for x in latencies)
        + f"; {n_served / served_s:.2f} clips/s; peak memory {peak_gb:.2f} GB; "
        f"launches {launches}; padded-tail vs full-batch max |diff| {tail_vs_full:.3g}")

    empty = batch_predict(fwd, clips[:0], BATCH)["logits/action"]
    check(empty.shape == (0, NUM_ACTIONS), f"empty request gave {empty.shape}")

    # the same model with plain attention in place of the kernel, one clip
    logits = batch_predict(fwd, clips[:1], 1)["logits/action"]

    def plain(qkv, bias, num_heads, causal=False):
        return fa.packed_short_attention_reference(qkv + bias.to(qkv.dtype), num_heads, causal)

    with mock.patch.object(fa, "packed_qkv_bias_attention", plain):
        plain_logits = batch_predict(fwd, clips[:1], 1)["logits/action"]
    scale = np.abs(plain_logits).max()
    diff = np.abs(logits - plain_logits).max()
    log(f"kernel vs plain attention, whole model, 1 clip: max |diff| {diff:.3g} "
        f"(logit scale {scale:.3g}; limit 5e-2 of the scale)")
    check(diff <= 5e-2 * scale, f"kernel vs plain attention logits differ by {diff}")

    # steady throughput at the serving batch and at bench.py's eval batch (32)
    for bs in (BATCH, 32):
        batch = np.concatenate([clips] * 4)[:bs]
        batch_predict(fwd, batch, bs)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            batch_predict(fwd, batch, bs)
        dt = (time.time() - t0) / 3
        log(f"steady forward, batch {bs}: {dt * 1e3:.2f} ms, {bs / dt:.2f} clips/s")
    profile_forward(fwd, np.concatenate([clips] * 4)[:32])

    spec = _build.KERNELS["short_attention_fwd"]
    kernels = [dict(
        name="short_attention_fwd", route=spec["route"], source=spec["source"],
        replaces=spec["replaces"], launches=launches["short_attention_fwd"],
        launches_per_forward=VIT_BLOCKS, shape=[240, 197, 12, 64], dtype="bfloat16",
        max_abs_err=main_err, ms=timing["kernel_ms"], **timing,
        bench_shape={"shape": [1920, 197, 12, 64], **bench_timing},
    )]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
