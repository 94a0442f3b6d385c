"""Readings that a cell's limits are set from, in one process (the kernels
built and loaded once):

    python3 -m portbench.calibrate --workload W --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults half_batch,crop_offset] \
        [--control model] [--preprocess-dtype float32]

For each --seeds seed the program's numbers (a run with a short window);
for each --control-seeds seed the control's (the reference in the next
precision below the configuration's, in the program's place, against the
reference), judged against the cell's committed limits as a run judges
the program, and each fault's (planted under the program). `--control
model` lowers the model's products only, not the preprocessing's;
`--preprocess-dtype` runs the program's preprocessing in another type
(a second witness). One JSON line a reading. Not part of a benchmark run.
"""
import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from portbench.drivers import train_steps
from portbench.harness import cell as cells, correct, faults, traffic as gen
from portbench.harness.seeded import Draws, make_weights, sub_seed

LOWER = {"bfloat16": "fp8", "float32": "tf32"}  # the next precision below


def control_numbers(cell, seed, device, control="full"):
    """The control's numbers: the reference with its products' operands in
    the precision below the configuration's (the preprocessing's products
    and the frames it hands on too, unless `control` is 'model'), against
    the reference."""
    cfg, tr, ref = cell.cfg, cell.traffic, cell.reference
    low = LOWER[cfg["model"]["compute_dtype"]]
    pre = cfg["preprocess"]
    pre_low = ("f32", "f32")
    if control == "full" and "compute_dtype" in pre:
        pre_low = (LOWER[pre["compute_dtype"]], LOWER[pre.get("out_dtype", pre["compute_dtype"])])
    _, weights = make_weights(cell.family.param_specs(cfg), seed, device)
    if cell.driver.MODE == "train":
        pool = gen.train_pool(cfg, tr, seed, device)[:train_steps.CHECK_STEPS]
        draws = [Draws(seed, k, device) for k in range(len(pool))]
        first = train_steps.first_iter(cfg)
        want = ref.train_steps(weights, cfg, pool, lambda k: draws[k], first)
        got = ref.train_steps(weights, cfg, pool, lambda k: draws[k], first, precision=low,
                              pre_precision=pre_low)
        return correct.train_numbers(got, want)
    pool = gen.serve_pool(cfg, tr, seed, device)
    rng = np.random.default_rng(sub_seed(seed, 3))
    picks = sorted(set(int(i) for i in rng.choice(len(pool), tr["check_requests"])))
    frames = [torch.from_numpy(pool[i]).to(device) for i in picks]
    want = [ref.eval_logits(weights, cfg, f).cpu().numpy() for f in frames]
    got = [ref.eval_logits(weights, cfg, f, precision=low).cpu().numpy() for f in frames]
    return {"logit_gap": correct.logit_gap(got, want)}


def judged(cell, numbers):
    """(correct, checks) of the control's numbers under the cell's limits."""
    return correct.judge(numbers, {k: v for k, v in cell.limits.items() if k in numbers})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--control", default="full", choices=("full", "model"))
    ap.add_argument("--preprocess-dtype", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    program = cell
    if args.preprocess_dtype:
        program = copy.copy(cell)
        program.cfg = copy.deepcopy(cell.cfg)
        program.cfg["preprocess"]["compute_dtype"] = args.preprocess_dtype
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    for seed in ints(args.seeds):
        t = time.time()
        r = cells.run(program, seed, 0.01, False, args.device)
        print(json.dumps({"kind": "program", "seed": seed, "correct": r["correct"],
                          "numbers": {k: c["value"] for k, c in r["checks"].items()},
                          "notes": r["notes"], "detail": r["detail"], "s": time.time() - t}),
              flush=True)
    for seed in ints(args.control_seeds):
        t = time.time()
        numbers = control_numbers(cell, seed, args.device, args.control)
        ok, _ = judged(cell, numbers)
        print(json.dumps({"kind": f"control_{args.control}", "seed": seed, "correct": ok,
                          "numbers": numbers, "s": time.time() - t}), flush=True)
        for name in [f for f in args.faults.split(",") if f]:
            r = cells.run(program, seed, 0.01, False, args.device, tamper=faults.FAULTS[name])
            print(json.dumps({"kind": name, "seed": seed, "correct": r["correct"],
                              "numbers": {k: c["value"] for k, c in r["checks"].items()}}),
                  flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
