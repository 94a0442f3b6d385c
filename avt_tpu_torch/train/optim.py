"""Optimizer, LR schedules and per-module parameter groups.

Counterpart of avt_tpu/train/optim.py for SGD (the flagship's optimizer):
  * schedules: `cosine_schedule`, `multistep_schedule`, `constant_schedule`
    and `warmup_schedule` (with its `affine_floor` quirk), composed by
    `build_schedule`. They are plain functions of the iteration count,
    evaluated on the host, so reading the LR never waits for the device.
  * `build_optimizer`: [module(s), lr, wd] groups matched on torch parameter
    names ('__all__', a name prefix, a dotted component, or an fnmatch
    pattern; the first matching group wins), LR scaled by the world size
    (and the batch size with scale_lr_by_bs), lr == 0 and unmatched
    parameters frozen, `bias_bn_wd_scale` on biases and norm parameters,
    `grad_clip_max_norm` over the non-frozen gradients only.
  * `SGD`: written out, because torch.optim.SGD cannot keep a bf16 momentum
    buffer. Its arithmetic follows optax 0.2.6's chain
    add_decayed_weights -> trace -> scale_by_learning_rate:
        g     = grad + wd * p                      (f32)
        new_t = g + momentum * t     (momentum * t in t's type, momentum
                                      rounded to it: a weakly typed float)
        u     = g + momentum * new_t if nesterov else new_t   (f32)
        t     = new_t rounded to the buffer's type
        p     = p + (-lr(count)) * u;  count += 1
    The schedule sees the count before the increment (lr(0) = 0 under a
    warmup from init_lr_ratio 0). Parameters and buffers are updated in place
    (the JAX step donates its state instead).
Adam, AdamW, Adafactor and the plateau scaler are not ported yet (ROADMAP
Queue 1) and raise.
"""
from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


# --------------------------------------------------------------- schedules
def multistep_schedule(base_lr: float, milestone_epochs: Sequence[int], iters_per_epoch: int,
                       gamma: float = 0.1, warmup_factor: float = 1.0 / 3,
                       warmup_epochs: int = 5, warmup_method: str = "linear") -> Schedule:
    """WarmupMultiStepLR."""
    milestones = [iters_per_epoch * m for m in milestone_epochs]
    warmup_iters = max(warmup_epochs * iters_per_epoch, 1)

    def fn(it: int) -> float:
        if it < warmup_iters:
            alpha = it / warmup_iters
            wf = warmup_factor if warmup_method == "constant" else (
                warmup_factor * (1 - alpha) + alpha)
        else:
            wf = 1.0
        return base_lr * wf * gamma ** sum(it >= m for m in milestones)

    return fn


def cosine_schedule(base_lr: float, num_epochs: int, iters_per_epoch: int,
                    eta_min: float = 0.0, world_size: int = 1) -> Schedule:
    """CosineLR: zero LR from T_max on."""
    t_max = num_epochs * iters_per_epoch
    eta = eta_min * world_size

    def fn(it: int) -> float:
        if it >= t_max:
            return 0.0
        return eta + (base_lr - eta) * (1 + math.cos(math.pi * it / t_max)) / 2

    return fn


def constant_schedule(base_lr: float) -> Schedule:
    return lambda it: base_lr


def warmup_schedule(base_schedule: Schedule, base_lr: float, warmup_epochs: int,
                    iters_per_epoch: int, init_lr_ratio: float = 0.0,
                    affine_floor: float = 0.0) -> Schedule:
    """Linear warmup from base_lr * init_lr_ratio over W = warmup_epochs *
    iters_per_epoch iterations; from W on the base schedule runs with its
    counter at it - (W - 1), transformed around `affine_floor` so that it
    continues from the last warmup LR, as the reference's recursive torch
    scheduler chaining does (see avt_tpu's warmup_schedule)."""
    w = max(warmup_epochs * iters_per_epoch, 1)
    r = init_lr_ratio if w > 1 else 1.0
    last_warmup_factor = r + (1 - r) * (w - 1) / w
    denom = base_lr - affine_floor
    scale = (last_warmup_factor * base_lr - affine_floor) / denom if denom != 0.0 else 1.0

    def fn(it: int) -> float:
        if it < w:
            return base_lr * (r + (1 - r) * it / w)
        base = base_schedule(max(it - (w - 1), 0))
        # past T_max a cosine pins the LR to exactly 0, not the affine floor
        return 0.0 if base == 0.0 else affine_floor + scale * (base - affine_floor)

    return fn


def build_schedule(name: str, base_lr: float, *, iters_per_epoch: int, num_epochs: int,
                   world_size: int = 1, warmup_epochs: int = 0,
                   warmup_init_lr_ratio: float = 0.0, **kwargs) -> Schedule:
    """The warmup-wrapped schedule by name; a cosine's T_max is
    num_epochs - warmup_epochs, as the reference's config composes it."""
    affine_floor = 0.0
    if name == "cosine":
        eta_min = kwargs.get("eta_min", 0.0)
        base = cosine_schedule(base_lr, num_epochs - warmup_epochs, iters_per_epoch,
                               eta_min=eta_min, world_size=world_size)
        affine_floor = eta_min * world_size
    elif name == "warmup_multi_step":
        base = multistep_schedule(
            base_lr, kwargs.get("milestone_epochs", []), iters_per_epoch,
            gamma=kwargs.get("gamma", 0.1), warmup_factor=kwargs.get("warmup_factor", 1.0 / 3),
            warmup_epochs=kwargs.get("scheduler_warmup_epochs", 0),
            warmup_method=kwargs.get("warmup_method", "linear"))
    elif name == "constant":
        base = constant_schedule(base_lr)
    elif name == "reduce_lr_on_plateau":
        raise NotImplementedError(
            "the ReduceLROnPlateau scaler is not ported yet (ROADMAP Queue 1)")
    else:
        raise NotImplementedError(f"Unknown scheduler {name!r}")
    return warmup_schedule(base, base_lr, warmup_epochs, iters_per_epoch,
                           warmup_init_lr_ratio, affine_floor=affine_floor)


# ------------------------------------------------------------- optimizer
@dataclass
class ParamGroup:
    names: List[str]
    params: List[nn.Parameter]
    weight_decay: float
    schedule: Schedule


class SGD:
    """SGD with (nesterov) momentum in optax's order; see the module
    docstring. `step()` reads each parameter's `.grad` (None counts as 0) and
    updates parameters and momentum buffers in place, with torch._foreach
    ops per group, and never waits for the device."""

    def __init__(self, groups: List[ParamGroup], *, momentum: float = 0.9,
                 nesterov: bool = False, momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: Optional[float] = None, frozen: Sequence[str] = ()):
        self.groups = groups
        self.momentum = momentum
        self.nesterov = nesterov
        self.grad_clip_max_norm = grad_clip_max_norm
        self.frozen = list(frozen)
        self.count = 0
        self.momentum_buffers: Dict[str, torch.Tensor] = {
            name: torch.zeros_like(p, dtype=momentum_dtype or p.dtype)
            for g in groups for name, p in zip(g.names, g.params)}

    def _momentum_in(self, bufs: List[torch.Tensor]) -> float:
        """The momentum as JAX multiplies a buffer by it: a Python float
        takes the array's type (0.8984375 for 0.9 in bf16)."""
        return float(torch.tensor(self.momentum, dtype=bufs[0].dtype)) if bufs else self.momentum

    def zero_grad(self) -> None:
        for g in self.groups:
            for p in g.params:
                p.grad = None

    @staticmethod
    def _grads(group: ParamGroup) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in group.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = [self._grads(g) for g in self.groups]
        if self.grad_clip_max_norm is not None:
            grads = self._clip(grads)
        for group, g in zip(self.groups, grads):
            if not group.params:
                continue
            if group.weight_decay:
                wd_p = torch._foreach_mul(group.params, group.weight_decay)
                g = torch._foreach_add(g, wd_p)
            bufs = [self.momentum_buffers[n] for n in group.names]
            new_t = torch._foreach_add(g, torch._foreach_mul(bufs, self._momentum_in(bufs)))
            if self.nesterov:
                u = torch._foreach_add(g, torch._foreach_mul(new_t, self.momentum))
            else:
                u = new_t
            torch._foreach_copy_(bufs, new_t)
            torch._foreach_mul_(u, -group.schedule(self.count))
            torch._foreach_add_(group.params, u)
        self.count += 1

    def _clip(self, grads: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """optax.clip_by_global_norm over the non-frozen gradients, on the
        device: g / norm * max_norm where norm >= max_norm."""
        flat = [t for g in grads for t in g]
        if not flat:
            return grads
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(flat)))
        keep = norm < self.grad_clip_max_norm
        out = []
        for g in grads:
            clipped = torch._foreach_mul(torch._foreach_div(g, norm), self.grad_clip_max_norm)
            out.append([torch.where(keep, a, b) for a, b in zip(g, clipped)])
        return out

    def load_state_dict(self, state: dict) -> None:
        """Copies count and momentum buffers in (buffers keep their type)."""
        self.count = int(state["count"])
        missing = set(self.momentum_buffers) - set(state["momentum"])
        if missing:
            raise KeyError(f"no momentum for {sorted(missing)[:5]}")
        with torch.no_grad():
            for name, buf in self.momentum_buffers.items():
                buf.copy_(state["momentum"][name])


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._NormBase)


def _is_bias_or_norm(name: str, owner: nn.Module) -> bool:
    """Biases and normalisation parameters (avt_tpu's `_is_bias_or_norm`
    reads flax names, where a LayerNorm weight is `scale`)."""
    return name.endswith(".bias") or name == "bias" or isinstance(owner, _NORMS)


def _matches(name: str, mod: str) -> bool:
    return (mod == "__all__" or name.startswith(mod + ".") or f".{mod}." in f".{name}"
            or fnmatch.fnmatch(name, mod))


def build_optimizer(
    model: nn.Module,
    lr_wd: Sequence[Tuple],
    *,
    optimizer_name: str = "sgd",
    scheduler_name: str = "cosine",
    iters_per_epoch: int,
    num_epochs: int,
    world_size: int = 1,
    batch_size: Optional[int] = None,
    scale_lr_by_bs: bool = False,
    bias_bn_wd_scale: float = 1.0,
    grad_clip_max_norm: Optional[float] = None,
    warmup_epochs: int = 0,
    warmup_init_lr_ratio: float = 0.0,
    optimizer_kwargs: Optional[dict] = None,
    scheduler_kwargs: Optional[dict] = None,
) -> Tuple[SGD, Dict[str, Schedule]]:
    """Per-module parameter groups -> (SGD, {group label: schedule}).

    optimizer_kwargs: momentum (0.9), nesterov (False), momentum_dtype
    (None: the parameter's type; 'bf16'/'bfloat16')."""
    optimizer_kwargs = dict(optimizer_kwargs or {})
    scheduler_kwargs = scheduler_kwargs or {}
    if optimizer_name != "sgd":
        raise NotImplementedError(
            f"optimizer {optimizer_name!r} is not ported yet (ROADMAP Queue 1); only sgd is")
    groups_cfg = [((mods,) if isinstance(mods, str) else tuple(mods), float(lr), float(wd))
                  for mods, lr, wd in lr_wd]
    lr_scale = world_size * (batch_size if scale_lr_by_bs and batch_size else 1)
    owners = {f"{mname}.{pname}" if mname else pname: m
              for mname, m in model.named_modules() for pname, _ in m.named_parameters(recurse=False)}

    members: Dict[str, Tuple[List[str], List[nn.Parameter]]] = {}
    frozen: List[str] = []
    for name, p in model.named_parameters():
        label = None
        for gi, (mods, lr, _) in enumerate(groups_cfg):
            if any(_matches(name, mod) for mod in mods):
                if lr != 0:
                    label = f"g{gi}" + ("_bn" if _is_bias_or_norm(name, owners[name]) else "")
                break
        if label is None:
            frozen.append(name)
            continue
        names, params = members.setdefault(label, ([], []))
        names.append(name)
        params.append(p)

    groups: List[ParamGroup] = []
    schedules: Dict[str, Schedule] = {}
    for gi, (_, lr, wd) in enumerate(groups_cfg):
        for suffix, wd_scale in (("", 1.0), ("_bn", bias_bn_wd_scale)):
            label = f"g{gi}{suffix}"
            if label not in members:
                continue
            sched = build_schedule(scheduler_name, lr * lr_scale, iters_per_epoch=iters_per_epoch,
                                   num_epochs=num_epochs, world_size=world_size,
                                   warmup_epochs=warmup_epochs,
                                   warmup_init_lr_ratio=warmup_init_lr_ratio, **scheduler_kwargs)
            schedules[label] = sched
            names, params = members[label]
            groups.append(ParamGroup(names, params, wd * wd_scale, sched))
    mdt = optimizer_kwargs.pop("momentum_dtype", None)
    if mdt not in (None, "bf16", "bfloat16", torch.bfloat16):
        raise ValueError(f"momentum_dtype {mdt!r}: None or bfloat16")
    unknown = set(optimizer_kwargs) - {"momentum", "nesterov"}
    if unknown:
        raise TypeError(f"unknown sgd options {sorted(unknown)}")
    opt = SGD(groups, momentum=optimizer_kwargs.get("momentum", 0.9),
              nesterov=optimizer_kwargs.get("nesterov", False),
              momentum_dtype=None if mdt is None else torch.bfloat16,
              grad_clip_max_norm=grad_clip_max_norm, frozen=frozen)
    return opt, schedules
