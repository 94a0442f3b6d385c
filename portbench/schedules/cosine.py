"""Linear warmup from 0 over W iterations, then a cosine over the rest of
the epochs, continued from the last warmup LR."""
from __future__ import annotations

import math


def lr_at(opt: dict, it: int) -> float:
    base, ipe = opt["lr"], opt["iters_per_epoch"]
    W = max(opt["warmup_epochs"] * ipe, 1)
    if it < W:
        return base * it / W
    t_max = (opt["num_epochs"] - opt["warmup_epochs"]) * ipe
    t = it - (W - 1)
    if t >= t_max:
        return 0.0
    return (W - 1) / W * base * (1 + math.cos(math.pi * t / t_max)) / 2
