"""Data parallelism over processes: the process group and its collectives.

Counterpart of avt_tpu/parallel/mesh.py (`setup_distributed`, and the
'data' axis of `make_mesh`, `shard_params`, `shard_batch` and
`unshard_results`). The JAX step is written over the global batch and
GSPMD inserts the collectives; here every process runs the step on its own
shard of the batch (the config's per-replica batch size), as the reference's
DDP did, and the collectives are explicit, so that R processes of b clips
compute what one process computes on the R*b clips:

  * the gradient: `allreduce_gradients` averages each parameter's gradient
    over the ranks before the optimizer (one flat all-reduce per type), the
    update of the global batch's mean loss. It is the work of DDP's
    gradient hooks, done once after the backward: the steps call the model
    more than once (the SSL step, rollouts), which DDP's wrapper does not
    follow;
  * BatchNorm's statistics over the global batch (models/norm.py) and the
    InfoNCE negatives of every rank (losses/infonce.py), through the
    autograd-aware `all_reduce_with_grad` and `all_gather_with_grad`;
  * the meters, the eval results, the checkpoints and the save and
    preemption decisions (train/, evaluate/).

Under tensor parallelism (parallel.model_size > 1, parallel/mesh.py) the
ranks form a (data, model) mesh, and every data-parallel collective here
goes over this rank's data group: the ranks that hold the same shards of
the model. `data_rank()` and `data_world()` place a rank's batch in the
global one. With model_size 1 the data group is the world.
"""
from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from avt_tpu_torch.parallel.mesh import current_mesh, reset_mesh


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def data_rank() -> int:
    """This rank's replica on the mesh's data axis (`rank()` without a
    model axis)."""
    return current_mesh().data_rank


def data_world() -> int:
    """The number of data-parallel replicas (`world_size()` without a model
    axis)."""
    return current_mesh().n_data


def model_rank() -> int:
    """This rank's place on the mesh's model axis (0 without one)."""
    return current_mesh().model_rank


def _data_group():
    return current_mesh().data_group


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK, else SLURM_LOCALID, else 0."""
    return int(os.environ.get("LOCAL_RANK") or os.environ.get("SLURM_LOCALID") or 0)


def env_rank() -> int:
    """The rank the environment gives this process (RANK, else
    SLURM_PROCID, else 0), before the process group exists."""
    return int(os.environ.get("RANK") or os.environ.get("SLURM_PROCID") or 0)


def resolve_backend(name: Optional[str], device_type: str) -> str:
    """The torch backend for the config's `dist_backend`: 'ici' (the JAX
    package's default) or None means NCCL on CUDA and gloo on the CPU; an
    explicit 'nccl' or 'gloo' is honoured. Gloo on CUDA tensors lets several
    ranks share one card, which NCCL refuses."""
    if name in (None, "", "ici"):
        return "nccl" if device_type == "cuda" else "gloo"
    if name not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend={name!r}: the port takes 'ici', 'nccl' or 'gloo'")
    if name == "nccl" and device_type != "cuda":
        raise ValueError("dist_backend=nccl needs CUDA devices; the CPU takes gloo")
    return name


def setup_distributed(backend: Optional[str] = None, device_type: str = "cuda",
                      logger=None) -> bool:
    """Joins the process group the environment describes (the reference's
    common/utils.py:106-150): RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT, as torchrun and `avt_tpu_torch.launch` set them, with
    SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID in their place under SLURM.
    A world of one with no rendezvous configured is a no-op, as is a group
    already joined. Returns whether this call joined one.

    backend: the config's `dist_backend` (`resolve_backend`). On CUDA each
    rank takes device LOCAL_RANK; under gloo, ranks beyond the host's card
    count share its cards (LOCAL_RANK modulo the count, `utils.device`)."""
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE") or os.environ.get("SLURM_NTASKS") or 1)
    addr = os.environ.get("MASTER_ADDR")
    if world == 1 and not addr:
        return False
    if not addr or not os.environ.get("MASTER_PORT"):
        raise ValueError(f"a world of {world} processes needs MASTER_ADDR and MASTER_PORT "
                         "(the rendezvous of process 0)")
    backend = resolve_backend(backend, device_type)
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank() >= n_cards:
            raise ValueError(f"NCCL takes one rank per card: local rank {local_rank()} on a "
                             f"host of {n_cards}; dist_backend=gloo lets ranks share a card")
        torch.cuda.set_device(local_rank() % n_cards)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
        rank=env_rank(), world_size=world, timeout=datetime.timedelta(minutes=30))
    if logger:
        logger.info("torch.distributed initialized (%s): process %d/%d, local rank %d",
                    backend, rank(), world_size(), local_rank())
    return True


def cleanup() -> None:
    """Leaves the process group, when there is one, and forgets its mesh."""
    reset_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a small host value goes for a collective: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce_sum(values, group="data") -> torch.Tensor:
    """The element-wise sum over the data replicas of a host array (as
    f64), on the host: the meters' totals and counts (model peers hold the
    same ones). group='world': over every rank."""
    t = torch.as_tensor(values, dtype=torch.float64)
    over_data = group == "data"
    if (data_world() if over_data else world_size()) == 1:
        return t
    t = t.to(_comm_device())
    dist.all_reduce(t, group=_data_group() if over_data else None)
    return t.cpu()


def any_rank(flag: bool) -> bool:
    """True on every rank when it is true on any (the preemption stop).
    Over the world: the stop's checkpoint is a collective of every rank,
    model peers included, so no rank may stop alone."""
    return bool(all_reduce_sum([float(flag)], group="world")[0] > 0)


def from_rank0(flag: bool) -> bool:
    """Rank 0's flag on every rank (the wall-clock save trigger: clocks
    differ between hosts). Over the world, as `any_rank`."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_comm_device())
    dist.broadcast(t, 0)
    return bool(t.item())


def broadcast_module(module: torch.nn.Module) -> None:
    """Every rank takes rank 0's parameters and buffers, as DDP does when it
    wraps a model."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, 0)


def allreduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Each parameter's gradient becomes its mean over the data replicas:
    one flat all-reduce per type over the data group (the ranks that hold
    the same shard). Parameters without a gradient (the same on every rank:
    one model, one path) are left out. A no-op with one replica."""
    world = data_world()
    if world == 1:
        return
    by_type = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=_data_group())
        flat /= world
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


class _AllReduceSum(torch.autograd.Function):
    """The sum over the data replicas; its gradient is the sum of their
    gradients, since every replica's loss depends on every replica's
    input."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=_data_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_data_group())
        return grad


class _AllGather(torch.autograd.Function):
    """The data replicas' (b, ...) tensors concatenated in data-rank order
    (R*b, ...), as the sum of R buffers that each hold one replica's rows
    and zeros elsewhere (exact: one term an element is not zero). The
    gradient of this replica's rows is the sum over the replicas of the
    gradient of those rows. All-reduce is the collective that every backend takes for CUDA
    tensors; `torch.distributed.nn.functional.all_gather`'s backward takes
    all_to_all under gloo, and that module is deprecated in newer torch."""

    @staticmethod
    def forward(ctx, x):
        b, r = x.shape[0], data_rank()
        out = x.new_zeros((data_world() * b,) + tuple(x.shape[1:]))
        out[r * b:(r + 1) * b] = x
        dist.all_reduce(out, group=_data_group())
        ctx.rows = b
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_data_group())
        r = data_rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of x over the data replicas; x itself with one."""
    return x if data_world() == 1 else _AllReduceSum.apply(x)


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Differentiable concatenation of the data replicas' x along the first
    axis, in data-rank order; x itself with one replica."""
    return x if data_world() == 1 else _AllGather.apply(x)


class RankGenerator(torch.Generator):
    """A data replica's generator under data parallelism: its own draws
    (plain dropout masks, crop draws) differ from every other replica's
    (model peers share them), and `shared` is the step's generator of one
    process, the same on every rank, from which the draws that all ranks
    must agree on are taken (`shared_generator`: the seed of AVT-h's
    position-stable rollout masks)."""

    shared: torch.Generator


def shared_generator(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """The generator of draws every rank must agree on: `generator` itself
    in one process."""
    return getattr(generator, "shared", generator)
