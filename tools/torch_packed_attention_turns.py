#!/usr/bin/env python3
"""Times the port's packed attention kernels and the fused qkv projection +
attention kernel in turns on one GPU.

    python3 tools/torch_packed_attention_turns.py [--f32] [--source LABEL=DIR] ...
                                                  [--unchecked LABEL=DIR] ...

Builds `short_attention_fwd.cu` and `short_attention_bwd.cu` (the packed
kernels, bf16) and `fused_qkv_attention_fwd.cu` (bf16 and f32) from each DIR
(a copy of `avt_tpu_torch/ops/csrc`: a parent commit's, or an edited copy,
unpacked into a git-ignored directory) and from this checkout ("change"),
each into a library of its own, and prints each library's registers and
spills and each template's blocks an SM at T=197. Holds each against the
plain PyTorch version (packed: head-pair and unpaired head dims, causal and
not; fused: `chip_smoke.check_fused` on out and qkv; bits on a repeat), then
times them at the ViT's shapes in turns (the sources in the order given,
change, then the same in reverse, so each label gets two numbers from one
card), the packed backward also by side from a profile
(`chip_smoke.packed_side_ms`), the fused kernel with `chip_smoke.time_fused`
(its plain, library and split times once, in the first turn). A source
given with --unchecked is timed without the checks (a phase skip). With
--f32 the packed kernels' f32 forms are checked (f32 tolerance) and timed
instead, at expts/01's shapes (the forward at 30 and 180 frames, the
backward with db at 30), and the fused kernel is left out. Ends with one
JSON line of the times. Needs a CUDA device; run it from the repository root.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from avt_tpu_torch.ops import _build  # noqa: E402
from avt_tpu_torch.ops import flash_attention as fa  # noqa: E402

BF16 = torch.bfloat16
# (N, T, H, D, causal, bias): the forward with the bias, the backward with db
CHECKS = ((8, 197, 12, 64, False, True), (5, 197, 12, 64, True, True),
          (3, 300, 12, 64, True, False), (8, 197, 24, 32, True, False),
          (8, 197, 6, 128, False, True), (2, 17, 6, 128, True, False))
FWD_SHAPES = {  # label: (N, T, H, D, bias), the bias form as the ViT calls it
    "N160": (160, 197, 12, 64, True), "N240": (240, 197, 12, 64, True),
    "N1920": (1920, 197, 12, 64, True),
    "D32": (160, 197, 24, 32, False), "D128": (160, 197, 6, 128, False),
}
# (N, T, H, dtype, causal): a serving and a train batch, f32, causal, and
# the tile edges of the fused kernel (64-row warpgroups, 256-row tiles)
FUSED_CHECKS = ((240, 197, 12, BF16, False), (160, 197, 12, BF16, False),
                (240, 197, 12, torch.float32, False), (4, 100, 4, BF16, True),
                (3, 300, 4, BF16, True), (3, 300, 2, torch.float32, True),
                (2, 65, 2, BF16, False), (2, 257, 2, BF16, True))
FUSED_SHAPES = {  # label: (N, T, H, dtype)
    "N160": (160, 197, 12, BF16), "N240": (240, 197, 12, BF16),
    "f32 N240": (240, 197, 12, torch.float32),
}
BWD_SHAPES = {  # label: (N, T, H, D, with_db)
    "db N160": (160, 197, 12, 64, True), "db N240": (240, 197, 12, 64, True),
    "no-db D64": (160, 197, 12, 64, False), "no-db D32": (160, 197, 24, 32, False),
    "no-db D128": (160, 197, 6, 128, False),
}
# --f32: expts/01's f32 ViT, a train step of 3 clips x 10 frames and an eval
# batch of 3 clips x 6 views x 10 frames
F32_FWD_SHAPES = {"N30": (30, 197, 12, 64, True), "N180": (180, 197, 12, 64, True)}
F32_BWD_SHAPES = {"db N30": (30, 197, 12, 64, True)}


def check_source(label, csrc, dtype=BF16):
    """Both kernels of one source directory against the plain versions."""
    tol = cs.TOL[dtype]
    for N, T, H, D, causal, with_bias in CHECKS:
        qkv, dout, bias = cs.bwd_inputs(N, T, H, D, dtype, seed=31)
        bias = bias if with_bias else None
        ref_in = qkv if bias is None else qkv + bias
        out = fa._launch(qkv, bias, H, causal, csrc)
        torch.testing.assert_close(out, fa.packed_short_attention_reference(ref_in, H, causal),
                                   atol=tol, rtol=tol)
        dqkv, db = fa._launch_bwd(qkv, bias, dout, H, causal, with_bias, csrc)
        ref, ref_db = fa.packed_short_attention_bwd_reference(ref_in, dout, H, causal, with_bias)
        cs.check(cs.rel_err(dqkv, ref) <= tol and (db is None or cs.rel_err(db, ref_db) <= tol),
                 f"{label}: the backward at {(N, T, H, D, causal, with_bias)}")
        again, db_again = fa._launch_bwd(qkv, bias, dout, H, causal, with_bias, csrc)
        cs.check(torch.equal(fa._launch(qkv, bias, H, causal, csrc), out)
                 and torch.equal(again, dqkv) and (db is None or torch.equal(db_again, db)),
                 f"{label}: bits differ on a repeat at {(N, T, H, D, causal, with_bias)}")
    cs.log(f"{label}: forward and backward match the plain versions, same bits on a repeat")


def check_fused_source(label, csrc):
    """The fused kernel of one source directory against its plain version."""
    for N, T, H, dtype, causal in FUSED_CHECKS:
        cs.check_fused(N, T, H, dtype, causal, seed=35, csrc=csrc)
    cs.log(f"{label}: the fused kernel matches its plain version, same bits on a repeat")


def time_fused_turns(sources):
    """label -> "fused <shape>" -> {"ms": [first turn, second turn]}, the
    first label's first turn also with the yardsticks."""
    labels = list(sources) + list(sources)[::-1]
    results = {label: {} for label in sources}
    for shape, (N, T, H, dtype) in FUSED_SHAPES.items():
        for i, label in enumerate(labels):
            res = cs.time_fused(N, T, H, dtype, sources[label], yardsticks=i == 0)
            entry = results[label].setdefault(f"fused {shape}", {"ms": []})
            entry["ms"].append(res.pop("kernel_ms"))
            entry.update(res)
        cs.log(f"fused {shape}: " + "; ".join(
            f"{label} {'/'.join(f'{x:.4f}' for x in results[label][f'fused {shape}']['ms'])}"
            for label in sources))
    return results


def time_turns(sources, dtype=BF16):
    """label -> shape -> {"ms": [first turn, second turn], backward sides}."""
    labels = list(sources) + list(sources)[::-1]
    results = {label: {} for label in sources}
    fwd_shapes, bwd_shapes = ((FWD_SHAPES, BWD_SHAPES) if dtype == BF16
                              else (F32_FWD_SHAPES, F32_BWD_SHAPES))
    for shape, (N, T, H, D, flag) in fwd_shapes.items():
        qkv, _, bias = cs.bwd_inputs(N, T, H, D, dtype, seed=33)
        bias = bias if flag else None
        for label in labels:
            res = results[label].setdefault(f"fwd {shape}", {"ms": []})
            res["ms"].append(cs.cuda_ms(lambda: fa._launch(qkv, bias, H, False, sources[label])))
        cs.log(f"fwd {shape}: " + "; ".join(
            f"{label} {'/'.join(f'{x:.4f}' for x in results[label][f'fwd {shape}']['ms'])}"
            for label in sources))
    for shape, (N, T, H, D, with_db) in bwd_shapes.items():
        qkv, dout, bias = cs.bwd_inputs(N, T, H, D, dtype, seed=34)
        bias = bias if with_db else None
        for label in labels:
            def run(csrc=sources[label]):
                return fa._launch_bwd(qkv, bias, dout, H, False, with_db, csrc)

            res = results[label].setdefault(f"bwd {shape}", {"ms": []})
            res["ms"].append(cs.cuda_ms(run))
            if "query_ms" not in res:
                res.update(cs.packed_side_ms(run))
        cs.log(f"bwd {shape}: " + "; ".join(
            f"{label} {'/'.join(f'{x:.4f}' for x in res['ms'])} ("
            + ", ".join(f"{k} {v:.4f}" for k, v in res.items() if k != "ms") + ")"
            for label, res in ((lb, results[lb][f"bwd {shape}"]) for lb in sources)))
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=DIR",
                    help="a directory holding a copy of avt_tpu_torch/ops/csrc, timed "
                         "under LABEL before this checkout's sources")
    ap.add_argument("--unchecked", action="append", default=[], metavar="LABEL=DIR",
                    help="as --source, but timed without the checks: a phase skip, an "
                         "edited copy that leaves out a part of the work")
    ap.add_argument("--f32", action="store_true",
                    help="the packed kernels' f32 forms at expts/01's shapes, no fused kernel")
    args = ap.parse_args()
    dtype = torch.float32 if args.f32 else BF16
    if not torch.cuda.is_available():
        sys.exit("torch_packed_attention_turns: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    cs.log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False

    sources, unchecked = {}, set()
    for spec in args.source + args.unchecked:
        label, _, csrc = spec.partition("=")
        sources[label] = Path(csrc).resolve()
        if spec in args.unchecked:
            unchecked.add(label)
    sources["change"] = _build.CSRC
    kernels = (fa.KERNEL, fa.BWD_KERNEL) if args.f32 else (fa.KERNEL, fa.BWD_KERNEL, fa.FUSED_KERNEL)
    for label, csrc in sources.items():
        for name, text in _build.build(kernels, csrc).items():
            cs.log_registers(f"{label} {name}", text)
        cs.log(f"{label}:")
        # another source may predate the packed kernels' storage-type argument
        cs.log_residency(csrc, f32=label == "change")
    for label, csrc in sources.items():
        if label in unchecked:
            cs.log(f"{label}: not checked (timed only)")
            continue
        check_source(label, csrc, dtype)
        if not args.f32:
            check_fused_source(label, csrc)
    results = time_turns(sources, dtype)
    if not args.f32:
        for label, res in time_fused_turns(sources).items():
            results[label].update(res)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
