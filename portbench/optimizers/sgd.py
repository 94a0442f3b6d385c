"""SGD with weight decay and (nesterov) momentum in optax's order, as the
configuration states it: g += wd * p; t = g + m * t (t kept in
momentum_dtype); u = g + m * t with nesterov, else t; p -= lr * u."""
from __future__ import annotations

from typing import Dict

import torch


def program_kwargs(o: dict) -> dict:
    """The optimizer_kwargs of the program's build_optimizer."""
    kwargs = {"nesterov": o["nesterov"], "momentum": o["momentum"]}
    if o["momentum_dtype"] != "float32":
        kwargs["momentum_dtype"] = o["momentum_dtype"]
    return kwargs


def first_gradient(opt, name: str, p0: torch.Tensor, o: dict) -> torch.Tensor:
    """Step 1's gradient of leaf `name`, from the program's state after one
    step from zero momentum: t = g + wd * p0."""
    return opt.momentum_buffers[name].float() - o["wd"] * p0


class Reference:
    def __init__(self, P: Dict[str, torch.Tensor], o: dict):
        self.o = o
        dt = getattr(torch, o["momentum_dtype"])
        self.buf = {n: torch.zeros_like(p, dtype=dt) for n, p in P.items()}

    def step(self, P: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        wd, m = self.o["wd"], self.o["momentum"]
        for n, p in P.items():
            g = grads[n] + wd * p
            t = g + m * self.buf[n].float()
            u = g + m * t if self.o["nesterov"] else t
            self.buf[n].copy_(t)
            p.sub_(lr * u)
