"""Requests to the serving entry: each request's clips through
batch_predict, its logits on the host. The mix's `arrival` says when a
request comes (harness/traffic.py): in a closed loop, when the last one
returned; open-loop, at its drawn time, waiting in arrival order while the
program answers an earlier one. A request's latency runs from its arrival
(closed: its call) to its logits on the host. The window offers requests
for `seconds` and ends when every one offered is answered.

After the window, with the program freed, the reference answers a sample
of the window's requests drawn from the seed, the largest among them."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.harness import correct, traffic as gen
from portbench.harness.seeded import sub_seed

MODE = "serve"
WARM = 2  # requests of each size served in set-up


@dataclass
class Session:
    cell: Any
    seed: int
    device: Any
    pool: List[np.ndarray]
    program: Dict[str, Any] = field(default_factory=dict)  # the forward; freed by `check`
    outputs: List[np.ndarray] = field(default_factory=list)


def _request(s: Session, frames: np.ndarray) -> np.ndarray:
    return s.cell.family.serve_request(s.program["fwd"], frames, s.cell.traffic["batch"])


def setup(cell, seed: int, device, model, weights, tamper=None, clock=None) -> Session:
    fwd = cell.family.serve_program(cell.cfg, model)
    if tamper is not None:
        fwd = tamper("serve", fwd, model)
    pool = gen.serve_pool(cell.cfg, cell.traffic, seed, device)
    s = Session(cell, seed, device, pool, {"fwd": fwd, "model": model})
    if clock is not None:
        clock.mark("inputs and program")
    for n in sorted({len(f) for f in pool}):  # every shape the window sends
        first = next(f for f in pool if len(f) == n)
        for _ in range(WARM):
            _request(s, first)
    return s


def window(s: Session, seconds: float) -> dict:
    pool, arrivals = s.pool, gen.arrivals(s.cell.traffic, s.seed)
    latencies, outputs, calls, clips = [], [], 0, 0
    batch = s.cell.traffic["batch"]
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if arrivals is None:
            if now - t0 >= seconds:
                break
            arrived = now
        else:
            at = next(arrivals)
            if at >= seconds:
                break
            arrived = t0 + at
            if now < arrived:
                time.sleep(arrived - now)
        frames = pool[len(outputs) % len(pool)]
        outputs.append(_request(s, frames))
        latencies.append(time.perf_counter() - arrived)
        calls += -(-len(frames) // batch)
        clips += len(frames)
    window_s = time.perf_counter() - t0
    failed = sum(not np.isfinite(o).all() or o.shape[0] != len(pool[i % len(pool)])
                 for i, o in enumerate(outputs))
    s.outputs = outputs
    return {"units": len(outputs), "calls": calls, "clips": clips, "seconds": window_s,
            "latencies": latencies, "failed": int(failed)}


def unit(s: Session, i: int) -> None:
    _request(s, s.pool[i % len(s.pool)])


def unit_clips(s: Session, i: int) -> int:
    return len(s.pool[i % len(s.pool)])


def check(s: Session, weights_again) -> tuple:
    """(numbers, notes, detail): the reference's logits of a sample of the
    window's answers, drawn from the seed, with the largest request in it."""
    s.program.clear()
    weights = weights_again()
    cell, pool, outputs = s.cell, s.pool, s.outputs
    if not outputs:
        return {"logit_gap": np.inf}, ["no request answered in the window"], {}
    rng = np.random.default_rng(sub_seed(s.seed, 3))
    n = min(cell.traffic["check_requests"], len(outputs))
    picks = [int(i) for i in rng.choice(len(outputs), size=n, replace=False)]
    largest = max(range(min(len(pool), len(outputs))), key=lambda i: len(pool[i]))
    if all(len(pool[i % len(pool)]) < len(pool[largest]) for i in picks):
        picks[-1] = largest
    refs = {}
    for i in sorted({i % len(pool) for i in picks}):
        frames = torch.from_numpy(pool[i]).to(s.device)
        refs[i] = cell.reference.eval_logits(weights, cell.cfg, frames).float().cpu().numpy()
    numbers = {"logit_gap": correct.logit_gap([outputs[i] for i in picks],
                                               [refs[i % len(pool)] for i in picks])}
    return numbers, [], {}
