"""One run of one cell: set-up, the window, the profile pass of a traced
run, the comparison with the reference, and the result.

A cell is found by name: BENCHMARK.json's workload names its configuration
(configs/<config>.json, whose `family` names families/<family>.py and
reference/<family>.py, and whose optimizer and schedule name
optimizers/<name>.py and schedules/<name>.py) and its traffic mix
(traffic/<mix>.json, whose `driver` names drivers/<driver>.py); its limits
are limits/<workload>.json, and each metric is read by
metrics/<metric>.py.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import correct, profile as profiling, traffic as gen
from portbench.harness.roofline import PEAK_FLOPS
from portbench.harness.seeded import make_weights

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"


@dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    family: ModuleType = field(repr=False, default=None)
    reference: ModuleType = field(repr=False, default=None)
    driver: ModuleType = field(repr=False, default=None)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or _read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = _read_json(ROOT / conf["file"])
    cell = Cell(workload, cfg, _read_json(PKG / "traffic" / f"{entry['traffic']}.json"),
                _read_json(PKG / "limits" / f"{workload}.json"),
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])
    return attach(cell)


def attach(cell: Cell) -> Cell:
    fam = cell.cfg["family"]
    cell.family = importlib.import_module(f"portbench.families.{fam}")
    cell.reference = importlib.import_module(f"portbench.reference.{fam}")
    cell.driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    return cell


def reader(metric: str) -> Callable:
    """metrics/<metric>.py's `read(run)`."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the per-layer readers read: the cell, the window (profiler off)
    and the profile pass."""
    cell: Cell
    window: dict
    profile: Optional[profiling.Profile]
    setup_s: float = 0.0
    peak_bytes: int = 0
    unit_clips: List[int] = field(default_factory=list)  # of each profiled unit

    @property
    def model(self) -> dict:
        return self.cell.cfg["model"]

    @property
    def dtype(self) -> str:
        return self.model["compute_dtype"]

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def mode(self) -> str:
        return self.cell.driver.MODE

    def clip_flops(self) -> float:
        """Model FLOPs of one clip trained or served."""
        return self.cell.family.clip_flops(self.cell.cfg, self.cell.traffic, self.mode)

    def clip_s(self) -> float:
        """The window's seconds a clip."""
        return self.window["seconds"] / self.window["clips"]


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


class Clock:
    """Set-up's phases on the host clock, from the process's start."""

    def __init__(self, t_start: float):
        self.t_start, self.phases = t_start, {}

    def mark(self, phase: str) -> float:
        now = time.perf_counter() - self.t_start
        self.phases[phase] = now - sum(self.phases.values())
        return now

    def note(self) -> str:
        return "set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in self.phases.items())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, tamper: Optional[Callable] = None) -> dict:
    """One run; returns {'correct', 'attempted', 'failed', 'metrics',
    'peak_bytes', 'profile', 'checks', 'notes', 'detail'}. `tamper(kind, obj, model)`
    (tests and fault readings only) may replace the program's step or
    serving forward before anything runs."""
    clock = Clock(time.perf_counter() if t_start is None else t_start)
    clock.mark("imports")
    fam, drv, cfg, tr = cell.family, cell.driver, cell.cfg, cell.traffic
    specs = fam.param_specs(cfg)
    flat, weights = make_weights(specs, seed, device)
    model = fam.build_model(cfg, weights, device)
    gen.sync(device)
    clock.mark("weights and model")
    session = drv.setup(cell, seed, device, model, weights, tamper, clock)
    del flat, weights, model
    _free(device)
    setup_s = clock.mark("warm-up")
    notes: List[str] = [clock.note()]

    fam.reset_launch_counts()
    _reset_peak(device)
    window = drv.window(session, seconds)
    peak = _peak_bytes(device)
    notes.append(_pace(window))
    launches = fam.launch_counts()
    per_call = fam.expected_launches(cfg, tr["length"], drv.MODE, device)
    want = {k: v * window["calls"] for k, v in per_call.items()}
    launch_off = sum(abs(launches.get(k, 0) - v) for k, v in want.items())
    if launch_off:
        notes.append(f"launches {launches}, want {want}")

    prof, prof_clips = None, []
    if trace:
        units = tr["profile_units"]
        prof = profiling.profile(lambda i: drv.unit(session, i), units, fam.PROFILED_OPS)
        prof_clips = [drv.unit_clips(session, i) for i in range(units)]
        notes.append("profiled ops, device s: " + ", ".join(
            f"{op} {prof.op_s(op):.6f}" for op in fam.PROFILED_OPS))
    metrics = _metrics(cell, trace, window, prof, setup_s, peak, prof_clips)

    # the comparison, once the program's state is freed
    def weights_again():
        _free(device)
        return make_weights(specs, seed, device)[1]

    numbers, more_notes, detail = drv.check(session, weights_again)
    notes += more_notes
    numbers["launch_mismatch"] = float(launch_off)
    numbers["failed_units"] = float(window["failed"])  # non-finite losses, wrong-shaped answers
    ok, checks = correct.judge(numbers, {**cell.limits, **correct.EXACT})
    return {"correct": bool(ok), "attempted": window["units"], "failed": window["failed"],
            "metrics": metrics, "peak_bytes": peak, "profile": prof, "checks": checks,
            "notes": notes, "detail": detail}


def _pace(window: dict) -> str:
    """The window's units on the host clock (each unit's return), for the
    log: a run that paced slower shows here whether it was throughout or
    in stalls."""
    ends = window.get("unit_ends")
    if not ends or len(ends) < 3:
        return f"window: {window['units']} units in {window['seconds']:.3f} s"
    gaps = np.diff([window["t0"]] + ends) * 1e3
    q = np.percentile(gaps, [10, 50, 90, 99])
    return (f"window: {window['units']} units in {window['seconds']:.3f} s; host ms a unit "
            f"p10 {q[0]:.2f} p50 {q[1]:.2f} p90 {q[2]:.2f} p99 {q[3]:.2f} max {gaps.max():.2f}")


def _metrics(cell: Cell, trace: bool, window: dict, prof, setup_s: float, peak: int,
             prof_clips: List[int]) -> dict:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1), each from metrics/<name>.py; a reader that finds nothing to read
    returns None and its metric is left out."""
    run = Run(cell, window, prof, setup_s, peak, prof_clips)
    out = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
