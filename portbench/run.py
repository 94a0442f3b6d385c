"""Runs one cell of the benchmark and prints its result as the last line of
standard output:

    python3 -m portbench.run --workload <config>.<traffic> --seed N \
        --seconds S --trace 0|1

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics (the window timed alike with the profiler off, then a profile
pass). Each number compared with the reference is printed beside its limit
as the last lines of standard error and under `checks`, the line's last
key. Without enough CUDA devices, or with JAX loaded, it prints no result
and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "avt_tpu"}  # whole top-level module names


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def card(chips: int):
    """(name, power limit) of the card, or None when there are not `chips`
    CUDA devices."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader", "-i", "0"], capture_output=True,
                               text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return torch.cuda.get_device_name(0), limit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of anything that compiles at run time stay inside the checkout
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))

    from portbench.harness import cell as cells

    cell = cells.load_cell(args.workload)
    chips = next(w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                 if w["name"] == args.workload)["chips"]
    found = card(chips)
    if found is None:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); none usable here",
              file=sys.stderr)
        return 2
    name, power_limit = found
    res = cells.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: modules loaded that the port must not use: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": name, "count": chips,
              "memory_peak_bytes": int(res["peak_bytes"]), "power_limit": power_limit}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    prof = res["profile"]
    if prof is not None:
        device.update(busy_s=prof.busy_s, window_s=prof.window_s)
        line["breakdown"] = {"device_ops": prof.device_ops(), "idle_gaps": prof.idle_gaps()}
    line["checks"] = res["checks"]
    for note in res["notes"]:
        print(f"portbench: {note}", file=sys.stderr)
    for key, c in res["checks"].items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
