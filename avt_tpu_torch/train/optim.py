"""Optimizers, LR schedules and per-module parameter groups.

Counterpart of avt_tpu/train/optim.py:
  * schedules: `cosine_schedule`, `multistep_schedule`, `constant_schedule`
    and `warmup_schedule` (with its `affine_floor` quirk), composed by
    `build_schedule`. They are plain functions of the iteration count,
    evaluated on the host, so reading the LR never waits for the device.
    `reduce_lr_on_plateau` is a constant schedule; its reductions come from
    each group's `Plateau` multiplier, which `ReduceLROnPlateau.step`
    lowers on the host (not for adafactor, whose step size ignores the LR).
  * `build_optimizer`: [module(s), lr, wd] groups matched on torch parameter
    names ('__all__', a name prefix, a dotted component, or an fnmatch
    pattern; the first matching group wins), LR scaled by the world size
    (and the batch size with scale_lr_by_bs), lr == 0 and unmatched
    parameters frozen, `bias_bn_wd_scale` on biases and norm parameters,
    `grad_clip_max_norm` over the non-frozen gradients only.
  * `SGD`, `Adam` (adam and adamw) and `Adafactor`, written out, because
    torch.optim cannot keep a bf16 first moment and does not round where
    optax does. SGD follows optax 0.2.6's chain add_decayed_weights ->
    trace -> scale_by_learning_rate:
        g     = grad + wd * p                      (f32)
        new_t = g + momentum * t     (momentum * t in t's type, momentum
                                      rounded to it: a weakly typed float)
        u     = g + momentum * new_t if nesterov else new_t   (f32)
        t     = new_t rounded to the buffer's type
        p     = p + (-lr(count)) * u;  count += 1
    The schedule sees the count before the increment (lr(0) = 0 under a
    warmup from init_lr_ratio 0). Parameters and buffers are updated in place
    (the JAX step donates its state instead), with torch._foreach ops per
    group (Adafactor: per tensor), and no step waits for the device.

Under tensor parallelism (parallel/mesh.py) a sharded parameter's buffers
hold its local part. The two global reductions follow the mesh: the clip's
norm sums the squares of the sharded gradients over the model group and
counts each replicated gradient once, and Adafactor's RMS of the parameter
and of the update, and its means along a sharded axis (the row and column
second moments, the row moment's mean) are taken over the model group, so
that every rank takes its part of the one-process update.
"""
from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from avt_tpu_torch.parallel.mesh import Mesh, Shard, model_shards

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
    elif name in ("constant", "reduce_lr_on_plateau"):
        # a plateau's reductions scale the update through each group's
        # Plateau multiplier, stepped by ReduceLROnPlateau on the host
        base = constant_schedule(base_lr)
    else:
        raise NotImplementedError(f"Unknown scheduler {name!r}")
    return warmup_schedule(base, base_lr, warmup_epochs, iters_per_epoch,
                           warmup_init_lr_ratio, affine_floor=affine_floor)


# ------------------------------------------------------- ReduceLROnPlateau
@dataclass
class Plateau:
    """A group's LR multiplier, stepped on the host by ReduceLROnPlateau
    (avt_tpu's `PlateauScaleState`): the update is scaled by `mult`, kept as
    an f32 value; `floor` is torch's absolute min_lr over the group's base
    LR."""
    mult: float = 1.0
    floor: float = 0.0


def _f32(x) -> float:
    return float(np.float32(x))


class ReduceLROnPlateau:
    """Host-side plateau tracker, torch.optim.lr_scheduler.ReduceLROnPlateau
    step for step (avt_tpu's `ReduceLROnPlateau`): `step(optimizer, metric)`
    once per evaluation reduces the groups' multipliers in place."""

    def __init__(self, mode: str = "min", factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel", cooldown: int = 0,
                 **_ignored):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"mode {mode!r} / threshold_mode {threshold_mode!r}")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode, self.cooldown = threshold, threshold_mode, cooldown
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.best = -float("inf") if mode == "max" else float("inf")

    def _is_better(self, a: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < self.best * (1.0 - self.threshold)
            return a < self.best - self.threshold
        if self.threshold_mode == "rel":
            return a > self.best * (1.0 + self.threshold)
        return a > self.best + self.threshold

    def step(self, optimizer: "Optimizer", metric: float) -> None:
        if self._is_better(float(metric)):
            self.best = float(metric)
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            # each group's multiplier times the factor, clamped at its
            # floor, in f32: torch's per-group LR reduction
            for group in optimizer.groups:
                if group.plateau is not None:
                    pl = group.plateau
                    pl.mult = max(_f32(np.float32(pl.mult) * np.float32(self.factor)), pl.floor)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def state_dict(self) -> dict:
        return {"best": float(self.best), "num_bad_epochs": int(self.num_bad_epochs),
                "cooldown_counter": int(self.cooldown_counter)}

    def load_state_dict(self, d: dict) -> None:
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])
        self.cooldown_counter = int(d["cooldown_counter"])


# ------------------------------------------------------------- optimizers
@dataclass
class ParamGroup:
    names: List[str]
    params: List[nn.Parameter]
    weight_decay: float
    schedule: Schedule
    label: str = ""
    plateau: Optional[Plateau] = None


class Optimizer:
    """What the port's optimizers share: parameter groups, the step count,
    gradient clipping, and per-parameter state buffers (`self.state`: kind ->
    {parameter name: tensor}) that `load_state_dict` fills. `step()` reads
    each parameter's `.grad` (None counts as 0), updates parameters and
    buffers in place and never waits for the device."""

    def __init__(self, groups: List[ParamGroup], grad_clip_max_norm: Optional[float] = None,
                 frozen: Sequence[str] = (), shards: Optional[Dict[str, Shard]] = None,
                 mesh: Optional[Mesh] = None):
        self.groups = groups
        self.grad_clip_max_norm = grad_clip_max_norm
        self.frozen = list(frozen)
        self.shards = dict(shards or {})  # of a tensor-parallel model
        self.mesh = mesh
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    def zero_grad(self) -> None:
        for g in self.groups:
            for p in g.params:
                p.grad = None

    @staticmethod
    def _grads(group: ParamGroup) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in group.params]

    def _lr_scale(self, group: ParamGroup) -> float:
        """-lr(count), times the group's plateau multiplier when it has one."""
        lr = -group.schedule(self.count)
        return lr * group.plateau.mult if group.plateau is not None else lr

    @torch.no_grad()
    def step(self) -> None:
        grads = [self._grads(g) for g in self.groups]
        if self.grad_clip_max_norm is not None:
            grads = self._clip(grads)
        for group, g in zip(self.groups, grads):
            if group.params:
                self._update(group, g)
        self.count += 1

    def _update(self, group: ParamGroup, grads: List[torch.Tensor]) -> None:
        raise NotImplementedError

    def _clip(self, grads: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """optax.clip_by_global_norm over the non-frozen gradients, on the
        device: g / norm * max_norm where norm >= max_norm."""
        flat = [t for g in grads for t in g]
        if not flat:
            return grads
        norms = torch.stack(torch._foreach_norm(flat))
        if self.shards:
            sharded = torch.tensor([n in self.shards for g in self.groups for n in g.names],
                                   device=norms.device)
            sq = norms.square()
            part = torch.where(sharded, sq, torch.zeros_like(sq)).sum().reshape(1)
            dist.all_reduce(part, group=self.mesh.model_group)
            norm = (part[0] + torch.where(sharded, torch.zeros_like(sq), sq).sum()).sqrt()
        else:
            norm = torch.linalg.vector_norm(norms)
        keep = norm < self.grad_clip_max_norm
        out = []
        for g in grads:
            clipped = torch._foreach_mul(torch._foreach_div(g, norm), self.grad_clip_max_norm)
            out.append([torch.where(keep, a, b) for a, b in zip(g, clipped)])
        return out

    def state_dict(self) -> dict:
        """The inverse of `load_state_dict`: the count, a CPU copy of every
        buffer in its own type ({kind: {parameter name: tensor}}, so a bf16
        momentum stays bf16), and the plateau multipliers by group label."""
        out = {"count": int(self.count),
               "plateau": {g.label: float(g.plateau.mult)
                           for g in self.groups if g.plateau is not None}}
        for kind, bufs in self.state.items():
            out[kind] = {name: buf.detach().to("cpu", copy=True) for name, buf in bufs.items()}
        return out

    def load_state_dict(self, state: dict) -> None:
        """Copies the count, every buffer (each keeps its own type) and, where
        given, the groups' plateau multipliers ({group label: mult}) in."""
        self.count = int(state["count"])
        for kind, bufs in self.state.items():
            missing = set(bufs) - set(state.get(kind, {}))
            if missing:
                raise KeyError(f"no {kind} for {sorted(missing)[:5]}")
        with torch.no_grad():
            for kind, bufs in self.state.items():
                for name, buf in bufs.items():
                    buf.copy_(state[kind][name])
        for group in self.groups:
            if group.plateau is not None and group.label in state.get("plateau", {}):
                group.plateau.mult = _f32(state["plateau"][group.label])


def _in_type(x: float, bufs: List[torch.Tensor]) -> float:
    """x as JAX multiplies a buffer by it: a Python float takes the array's
    type (0.8984375 for 0.9 in bf16)."""
    return float(torch.tensor(x, dtype=bufs[0].dtype)) if bufs else x


class SGD(Optimizer):
    """SGD with (nesterov) momentum in optax's order; see the module
    docstring."""

    def __init__(self, groups: List[ParamGroup], *, momentum: float = 0.9,
                 nesterov: bool = False, momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: Optional[float] = None, frozen: Sequence[str] = (),
                 shards: Optional[Dict[str, Shard]] = None, mesh: Optional[Mesh] = None):
        super().__init__(groups, grad_clip_max_norm, frozen, shards, mesh)
        self.momentum = momentum
        self.nesterov = nesterov
        self.momentum_buffers: Dict[str, torch.Tensor] = {
            name: torch.zeros_like(p, dtype=momentum_dtype or p.dtype)
            for g in groups for name, p in zip(g.names, g.params)}
        self.state["momentum"] = self.momentum_buffers

    def _update(self, group: ParamGroup, g: List[torch.Tensor]) -> None:
        if group.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(group.params, group.weight_decay))
        bufs = [self.momentum_buffers[n] for n in group.names]
        new_t = torch._foreach_add(g, torch._foreach_mul(bufs, _in_type(self.momentum, bufs)))
        if self.nesterov:
            u = torch._foreach_add(g, torch._foreach_mul(new_t, self.momentum))
        else:
            u = new_t
        torch._foreach_copy_(bufs, new_t)
        torch._foreach_mul_(u, self._lr_scale(group))
        torch._foreach_add_(group.params, u)


class Adam(Optimizer):
    """Adam (L2 decay: g += wd * p first, optax's add_decayed_weights ->
    adam) or, with `decoupled`, AdamW (optax.adamw: u += wd * p after the
    moment normalisation), in optax 0.2.6's order:
        mu    = (1 - b1) * g + b1 * mu     (b1 * mu in mu's type: b1 rounded
                                            to it, as a weakly typed float)
        nu    = (1 - b2) * g^2 + b2 * nu   (f32)
        u     = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps),  t = count + 1
        p     = p + (-lr(count)) * u       (the bias corrections in f32)
    mu is stored in `momentum_dtype` (bf16 halves its traffic) after the
    update used it in f32."""

    def __init__(self, groups: List[ParamGroup], *, betas=(0.9, 0.999), eps: float = 1e-8,
                 decoupled: bool = False, momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: Optional[float] = None, frozen: Sequence[str] = (),
                 shards: Optional[Dict[str, Shard]] = None, mesh: Optional[Mesh] = None):
        super().__init__(groups, grad_clip_max_norm, frozen, shards, mesh)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = eps
        self.decoupled = decoupled
        named = [(name, p) for g in groups for name, p in zip(g.names, g.params)]
        self.state["mu"] = {n: torch.zeros_like(p, dtype=momentum_dtype or p.dtype)
                            for n, p in named}
        self.state["nu"] = {n: torch.zeros_like(p) for n, p in named}

    def _update(self, group: ParamGroup, g: List[torch.Tensor]) -> None:
        wd = group.weight_decay
        if wd and not self.decoupled:
            g = torch._foreach_add(g, torch._foreach_mul(group.params, wd))
        mus = [self.state["mu"][n] for n in group.names]
        nus = [self.state["nu"][n] for n in group.names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(mus, _in_type(self.b1, mus)))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(nus, self.b2))
        t = np.float32(self.count + 1)
        bc1 = _f32(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = _f32(np.float32(1) - np.float32(self.b2) ** t)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if wd and self.decoupled:
            torch._foreach_add_(u, torch._foreach_mul(group.params, wd))
        torch._foreach_copy_(mus, mu)
        torch._foreach_copy_(nus, nu)
        torch._foreach_mul_(u, self._lr_scale(group))
        torch._foreach_add_(group.params, u)


class Adafactor(Optimizer):
    """transformers.Adafactor as avt_tpu's `transformers_adafactor` has it,
    with its defaults and quirks: the step size is relative,
    min(1e-2, 1/sqrt(t)) * max(1e-3, RMS(p)), whatever the schedule says
    (the reference's per-group LR dicts bypass the manual-LR path); every
    tensor of 2 or more dimensions keeps row and column second moments over
    its last two axes, the rest a full one; the update is clipped to RMS 1;
    the weight decay is decoupled and scaled by the same computed LR:
        delta = -(u * lr + wd * lr * p)
    The factored axes are the last two of the JAX package's layout. A linear
    weight is factored in the torch layout, the JAX kernel's two axes
    swapped: the factored estimate is symmetric under a transpose, so the
    update is the same (its row and col are JAX's col and row). A conv
    weight (out, in, *k) is not a transpose of the flax kernel (*k, in,
    out): its moments are taken on the permuted view in the flax layout,
    which keeps its row (*k, in) and col (*k, out), and the update is
    permuted back. No other parameter of the shipped models is re-laid-out
    with 3 or more dimensions (the ViT's pos_embed and cls_token are the
    same on both sides). The update runs tensor by tensor on the device (the
    factored shapes differ), without a sync."""

    EPS1, EPS2, CLIP, DECAY = 1e-30, 1e-3, 1.0, -0.8

    def __init__(self, groups: List[ParamGroup], *, grad_clip_max_norm: Optional[float] = None,
                 frozen: Sequence[str] = (), conv_weights: Sequence[str] = (),
                 shards: Optional[Dict[str, Shard]] = None, mesh: Optional[Mesh] = None):
        super().__init__(groups, grad_clip_max_norm, frozen, shards, mesh)
        self.conv_weights = frozenset(conv_weights)
        named = [(name, self._jax_layout(name, p))
                 for g in groups for name, p in zip(g.names, g.params)]
        f32 = dict(dtype=torch.float32)
        self.state["row"] = {n: torch.zeros(p.shape[:-1], device=p.device, **f32)
                             for n, p in named if p.dim() >= 2}
        self.state["col"] = {n: torch.zeros(p.shape[:-2] + p.shape[-1:], device=p.device, **f32)
                             for n, p in named if p.dim() >= 2}
        self.state["v"] = {n: torch.zeros(p.shape, device=p.device, **f32)
                           for n, p in named if p.dim() < 2}

    def _jax_layout(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A conv weight (out, in, *k) as the flax kernel (*k, in, out), a
        view; any other tensor as it is."""
        if name not in self.conv_weights:
            return x
        return x.permute(*range(2, x.dim()), 1, 0)

    def _torch_layout(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The inverse of `_jax_layout`."""
        if name not in self.conv_weights:
            return x
        n = x.dim()
        return x.permute(n - 1, n - 2, *range(n - 2))

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the model group (x's parts of a sharded tensor)."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.mesh.model_group)
        return x

    def _rms(self, x: torch.Tensor, sharded: bool = False) -> torch.Tensor:
        if not sharded:
            return x.square().mean().sqrt()
        return (self._sum(x.square().sum().reshape(1))[0]
                / (x.numel() * self.mesh.n_model)).sqrt()

    def _mean(self, x: torch.Tensor, dim: int, sharded: bool, keepdim: bool = False
              ) -> torch.Tensor:
        """The mean along dim, over the model group's parts when that axis
        is sharded."""
        if not sharded:
            return x.mean(dim=dim, keepdim=keepdim)
        return self._sum(x.sum(dim=dim, keepdim=keepdim)) / (x.shape[dim] * self.mesh.n_model)

    def _update(self, group: ParamGroup, grads: List[torch.Tensor]) -> None:
        t = np.float32(self.count + 1)
        step = _f32(min(np.float32(1e-2), np.float32(1) / np.sqrt(t)))
        beta2t = _f32(np.float32(1) - t ** np.float32(self.DECAY))
        wd = group.weight_decay
        for name, p, g in zip(group.names, group.params, grads):
            g32, p32 = (self._jax_layout(name, x.float()) for x in (g, p))
            shard = self.shards.get(name)  # a sharded weight is a 2-d linear one
            lr = step * torch.clamp_min(self._rms(p32, shard is not None), self.EPS2)
            sq = g32.square() + self.EPS1
            if p.dim() >= 2:
                axis = None if shard is None else shard.axis % p.dim()
                last, before = axis == p.dim() - 1, axis == p.dim() - 2
                r, c = self.state["row"][name], self.state["col"][name]
                r.mul_(beta2t).add_(self._mean(sq, -1, last) * (1 - beta2t))
                c.mul_(beta2t).add_(self._mean(sq, -2, before) * (1 - beta2t))
                rf = torch.rsqrt(r / self._mean(r, -1, before, keepdim=True))[..., None]
                u = rf * torch.rsqrt(c)[..., None, :] * g32
            else:
                v = self.state["v"][name]
                v.mul_(beta2t).add_(sq * (1 - beta2t))
                u = torch.rsqrt(v) * g32
            u = u / torch.clamp_min(self._rms(u, shard is not None) / self.CLIP, 1.0)
            u = u * lr
            p.add_(self._torch_layout(name, -(u + wd * lr * p32)).to(p.dtype))


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
) -> Tuple[Optimizer, Dict[str, Schedule]]:
    """Per-module parameter groups -> (optimizer, {group label: schedule}).

    optimizer_name: 'sgd', 'adam', 'adamw' or 'adafactor'. optimizer_kwargs:
    momentum (0.9) and nesterov (False) for sgd; betas ((0.9, 0.999)) and eps
    (1e-8) for adam/adamw; momentum_dtype (None: the parameter's type;
    'bf16'/'bfloat16') for the sgd momentum and the adam first moment.
    Adafactor takes none of them (its defaults are transformers').
    world_size: the number of data-parallel replicas (n_data under tensor
    parallelism). A model sharded by `parallel.mesh.shard_model` gives the
    optimizer its shards."""
    optimizer_kwargs = dict(optimizer_kwargs or {})
    scheduler_kwargs = scheduler_kwargs or {}
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
            plateau = None
            if scheduler_name == "reduce_lr_on_plateau" and optimizer_name != "adafactor":
                # the floor encodes torch's absolute min_lr for this group's
                # base LR; adafactor's relative step ignores the LR, so the
                # reference's plateau reduction does nothing there
                plateau = Plateau(floor=_f32(scheduler_kwargs.get("min_lr", 0.0)
                                             / max(lr * lr_scale, 1e-30)))
            groups.append(ParamGroup(names, params, wd * wd_scale, sched, label, plateau))
    mdt = optimizer_kwargs.pop("momentum_dtype", None)
    if mdt not in (None, "bf16", "bfloat16", torch.bfloat16):
        raise ValueError(f"momentum_dtype {mdt!r}: None or bfloat16")
    mdt = None if mdt is None else torch.bfloat16
    # the options avt_tpu's _base_optimizer takes; each optimizer reads its own
    unknown = set(optimizer_kwargs) - {"momentum", "nesterov", "betas", "eps"}
    if unknown:
        raise TypeError(f"unknown {optimizer_name} options {sorted(unknown)}")
    shards, mesh = model_shards(model)
    common = dict(grad_clip_max_norm=grad_clip_max_norm, frozen=frozen, shards=shards, mesh=mesh)
    if optimizer_name == "sgd":
        opt = SGD(groups, momentum=optimizer_kwargs.get("momentum", 0.9),
                  nesterov=optimizer_kwargs.get("nesterov", False), momentum_dtype=mdt, **common)
    elif optimizer_name in ("adam", "adamw"):
        opt = Adam(groups, betas=optimizer_kwargs.get("betas", (0.9, 0.999)),
                   eps=optimizer_kwargs.get("eps", 1e-8), decoupled=optimizer_name == "adamw",
                   momentum_dtype=mdt, **common)
    elif optimizer_name == "adafactor":
        conv = [n for n, m in owners.items()
                if isinstance(m, nn.modules.conv._ConvNd) and n.rsplit(".", 1)[-1] == "weight"]
        opt = Adafactor(groups, conv_weights=conv, **common)
    else:
        raise NotImplementedError(f"Unknown optimizer {optimizer_name!r}")
    return opt, schedules
