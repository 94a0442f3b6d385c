"""Train steps back to back: the window steps through the mix's batches in
turn with the step object that set-up built and checked, and every clip
trained over the whole time is the rate.

Set-up builds the program's one step object (the configuration's model
and optimizer), drives it through its first CHECK_STEPS steps on the
pool's first batches (every torch.rand inside drawn by the benchmark, see
harness/seeded.py), and hands that same object to the window. After the
window, with the program freed, the reference follows those steps from
the same weights, batches and draws."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from portbench.harness import correct, traffic as gen
from portbench.harness.seeded import Draws

MODE = "train"
CHECK_STEPS = 3


@dataclass
class Session:
    cell: Any
    seed: int
    device: Any
    first_iter: int
    pool: List[Dict[str, torch.Tensor]]
    draws: List[Draws]
    readings: dict
    program: Dict[str, Any] = field(default_factory=dict)  # step, batches; freed by `check`
    generator: Optional[torch.Generator] = None


def first_iter(cfg: dict) -> int:
    """The train cells step from the end of warmup (LR = base)."""
    o = cfg["optimizer"]
    return o["warmup_epochs"] * o["iters_per_epoch"]


def setup(cell, seed: int, device, model, weights, tamper=None, clock=None) -> Session:
    fam, cfg, tr = cell.family, cell.cfg, cell.traffic
    pool = gen.train_pool(cfg, tr, seed, device)
    batches = [fam.program_batch(cfg, b) for b in pool]
    frames: List[torch.Tensor] = []
    step, opt = fam.train_program(cfg, model, device, first_iter(cfg), frames)
    if tamper is not None:
        step = tamper("train", step, model)
    draws = [Draws(seed, k, device) for k in range(CHECK_STEPS)]
    gen.sync(device)
    if clock is not None:
        clock.mark("inputs and program")
    readings = fam.step_readings(step, opt, model, weights, batches[:CHECK_STEPS], draws, cfg,
                                 frames)
    if clock is not None:
        clock.mark("check steps")
    # the window's own call, without the benchmark's draws
    step(batches[CHECK_STEPS % len(batches)], torch.Generator(device=device).manual_seed(0))
    gen.sync(device)
    return Session(cell, seed, device, first_iter(cfg), pool, draws, readings,
                   {"step": step, "batches": batches, "opt": opt, "model": model})


def window(s: Session, seconds: float) -> dict:
    """Steps until `seconds` have passed, then waits for the device."""
    step, batches = s.program["step"], s.program["batches"]
    s.generator = torch.Generator(device=s.device).manual_seed(1)
    gen.sync(s.device)
    losses, ends, clips = [], [], 0
    t0 = time.perf_counter()
    while True:
        batch = batches[len(losses) % len(batches)]
        losses.append(step(batch, s.generator)["loss"])
        clips += batch["target"]["action"].shape[0]
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    gen.sync(s.device)
    window_s = time.perf_counter() - t0
    finite = torch.isfinite(torch.stack(losses))
    return {"units": len(losses), "calls": len(losses), "clips": clips, "seconds": window_s,
            "failed": int((~finite).sum()), "unit_ends": ends, "t0": t0}


def unit(s: Session, i: int) -> None:
    batches = s.program["batches"]
    s.program["step"](batches[i % len(batches)], s.generator)


def unit_clips(s: Session, i: int) -> int:
    return s.pool[i % len(s.pool)]["target"].shape[0]


def check(s: Session, weights_again) -> tuple:
    """(numbers, notes, detail): the reference's first steps against the
    program's, once the program's state is freed."""
    s.program.clear()
    free = weights_again()  # frees the program's memory first, then makes the weights
    cell = s.cell
    ref = cell.reference.train_steps(free, cell.cfg, s.pool[:CHECK_STEPS],
                                     lambda k: s.draws[k], s.first_iter)
    numbers = correct.train_numbers(s.readings, ref)
    mismatched = [d.mismatch for d in s.draws if d.mismatch]
    numbers["draw_mismatch"] = float(len(mismatched))
    return numbers, mismatched, correct.worst_leaves(s.readings, ref)
