"""Tensor parallelism: the (data, model) mesh over processes and the
Megatron-style sharding of attention heads, MLPs and classifiers.

Counterpart of the 'model' axis of avt_tpu/parallel/mesh.py (`make_mesh`,
`DEFAULT_PARAM_RULES`, `shard_params`). The JAX package shards weights on a
device mesh and GSPMD inserts the collectives; here each process holds its
shard of the sharded weights and the collectives are explicit, Megatron's
column / row split over a model process group:

  * a column layer (the attention's qkv projection, an MLP's first Linear,
    a classifier) keeps its output columns [r*N/m, (r+1)*N/m) on model rank
    r; its input passes `copy_to_model` (identity forward, all-reduce
    backward), so that the replicated input's gradient is the sum of the
    ranks' parts;
  * a row layer (the attention's output projection, an MLP's second Linear)
    keeps the matching input rows; each rank's partial product is
    all-reduced in f32 (`row_dense`), rounded to the compute type, and the
    replicated bias is added once, as `models.layers.dense` rounds;
  * a classifier's local logits are gathered along the class axis
    (`gather_from_model`) before the losses.

Attention is sharded by heads: rank r takes heads [r*H/m, (r+1)*H/m), the
q, k and v columns of those heads kept as one contiguous local packed
(3C/m) projection, which is a valid packed layout of H/m
heads, so the attention kernels run on it unchanged. The JAX package shards
the (C, 3C) kernel storage contiguously instead; the function is the same.
Where H % m != 0 the attention is replicated, JAX's rule for a dimension
that does not divide; the MLP and classifier weights follow that rule on
their own widths. Only weights are sharded, as JAX's rules match kernels
only: a column layer's bias stays whole on every rank and is sliced at use
(`local_bias`, whose backward sums the ranks' parts).

A run of n_data x n_model processes computes what one process computes on
the n_data replicas' global batch. Global rank = data_rank * n_model +
model_rank, JAX's `reshape(n_data, n_model)` device order: the model group
is n_model consecutive ranks, the data group the ranks of one model rank.
Model peers see the same batch and draw the same random numbers
(`train.step.step_generator` keys by data rank), so the replicated
activations stay equal on them; a dropout mask inside a sharded region is
the full-width draw sliced to the local columns.

`gather_state_dict` and `shard_state_dict` (model and optimizer state:
SGD's momentum, Adam's moments, Adafactor's factored row and col) carry a
checkpoint in the one-process layout, whatever model_size wrote it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class Mesh:
    """This process's place on the (data, model) mesh and its two groups
    (None: no collective needed, the group being this process alone, or the
    whole world for the data group of a mesh without a model axis)."""
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None


# The current mesh lives beside the process group it is built on, which
# torch.distributed keeps per process: the data-parallel collectives
# (parallel/ddp.py) that BatchNorm, the InfoNCE and the meters call read it.
_MESH: Optional[Mesh] = None


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def current_mesh() -> Mesh:
    """The mesh `make_mesh` built, else data parallelism over the process
    group (a model axis of 1), else the 1 x 1 mesh of one process."""
    if _MESH is not None:
        return _MESH
    if _joined():
        return Mesh(dist.get_world_size(), 1, dist.get_rank(), 0)
    return Mesh(1, 1, 0, 0)


def make_mesh(n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over the joined process group, n_data =
    world / n_model, which becomes the current mesh; in one process the 1 x
    1 mesh with no groups. Every rank must call it (group creation is a
    collective). Raises when n_model does not divide the world."""
    global _MESH
    n_model = int(n_model or 1)
    world = dist.get_world_size() if _joined() else 1
    if n_model < 1 or world % n_model:
        raise ValueError(f"parallel.model_size={n_model} does not divide the {world} "
                         "processes of the run")
    if world == 1:
        _MESH = Mesh(1, 1, 0, 0)
        return _MESH
    n_data, rank = world // n_model, dist.get_rank()
    data_group = model_group = None
    if n_model > 1:
        # every rank creates every group, in the same order
        for j in range(n_model):
            g = dist.new_group([d * n_model + j for d in range(n_data)])
            if j == rank % n_model:
                data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + j for j in range(n_model)])
            if d == rank // n_model:
                model_group = g
    _MESH = Mesh(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)
    return _MESH


def reset_mesh() -> None:
    """Forgets the current mesh (the process group is being left)."""
    global _MESH
    _MESH = None


# ------------------------------------------------------------------ rules
# (regex with the owner module's name as group 'owner', axis of the weight
# that is split, kind). Kinds: 'column' and 'row' split `axis` into m
# contiguous parts (divisibility on that axis); 'qkv' takes the q, k and v
# columns of the local heads, 'heads' the matching rows of the output
# projection (divisibility on the owner's head count). JAX's seven rules
# (classifier, GPT-2 MLP up/down, ViT MLP up/down, attention qkv/proj) on
# the port's names: Conv1D weights are (in, out), Linear weights (out, in).
DEFAULT_PARAM_RULES: Tuple[Tuple[str, int, str], ...] = (
    (r"^(?P<owner>classifiers\.[^.]+)\.weight$", 0, "column"),
    (r"^(?P<owner>(.+\.)?mlp)\.c_fc\.weight$", 1, "column"),
    (r"^(?P<owner>(.+\.)?mlp)\.c_proj\.weight$", 0, "row"),
    (r"^(?P<owner>(.+\.)?mlp)\.fc1\.weight$", 0, "column"),
    (r"^(?P<owner>(.+\.)?mlp)\.fc2\.weight$", 1, "row"),
    (r"^(?P<owner>(.+\.)?attn)\.c_attn\.weight$", 1, "qkv"),
    (r"^(?P<owner>(.+\.)?attn)\.qkv\.weight$", 0, "qkv"),
    (r"^(?P<owner>(.+\.)?self_attn)\.in_proj_weight$", 0, "qkv"),
    (r"^(?P<owner>(.+\.)?attn)\.c_proj\.weight$", 0, "heads"),
    (r"^(?P<owner>(.+\.)?attn)\.proj\.weight$", 1, "heads"),
    (r"^(?P<owner>(.+\.)?self_attn)\.out_proj\.weight$", 1, "heads"),
)


@dataclass(frozen=True)
class Shard:
    """How a sharded tensor splits: along `axis`, contiguously or ('qkv')
    as the local heads' q, k and v columns."""
    axis: int
    kind: str


def _local_index(n: int, kind: str, rank: int, m: int, device=None) -> torch.Tensor:
    """The global indices, along the split axis of global length n, that
    model rank `rank` of m holds."""
    if kind == "qkv":
        c = n // 3
        per = c // m
        return torch.cat([torch.arange(s * c + rank * per, s * c + (rank + 1) * per,
                                       device=device) for s in range(3)])
    per = n // m
    return torch.arange(rank * per, (rank + 1) * per, device=device)


def plan_shards(model: nn.Module, n_model: int,
                rules: Tuple[Tuple[str, int, str], ...] = DEFAULT_PARAM_RULES
                ) -> Tuple[Dict[str, Shard], Dict[str, nn.Module]]:
    """({parameter name: Shard}, {owner name: owner module}) of the
    parameters that `rules` shard over n_model ranks. An owner's weights are
    sharded together or not at all: all of them must divide (a 'qkv' or
    'heads' weight: the owner's head count)."""
    modules = dict(model.named_modules())
    by_owner: Dict[str, Dict[str, Shard]] = {}
    for name, p in model.named_parameters():
        for pattern, axis, kind in rules:
            m = re.search(pattern, name)
            if m:
                by_owner.setdefault(m.group("owner"), {})[name] = Shard(axis, kind)
                break
    shards: Dict[str, Shard] = {}
    owners: Dict[str, nn.Module] = {}
    params = dict(model.named_parameters())
    for owner, members in by_owner.items():
        module = modules[owner]
        fits = n_model > 1
        for name, s in members.items():
            if s.kind in ("qkv", "heads"):
                fits = fits and module.num_heads % n_model == 0
            else:
                fits = fits and params[name].shape[s.axis] % n_model == 0
        if fits:
            shards.update(members)
            owners[owner] = module
    return shards, owners


def shard_model(model: nn.Module, mesh: Mesh,
                rules: Tuple[Tuple[str, int, str], ...] = DEFAULT_PARAM_RULES
                ) -> Dict[str, Shard]:
    """Slices the parameters that `rules` shard to this rank's part, in
    place (the Parameter objects stay), and tells each owner module its
    mesh (`module.tp`), whose forward then runs on its local part. The
    model's `tp_shards` and `tp_mesh` record the plan for the optimizer and
    the checkpoints. Every model peer must hold the same full weights (after
    `ddp.broadcast_module`). A no-op on a mesh without a model axis.

    The ViT's fused qkv kernel (an attention with use_kernel=True) runs
    whole heads on an input as wide as their output, which local heads are
    not: sharding such an attention raises, naming the local head count."""
    shards, owners = plan_shards(model, mesh.n_model, rules)
    for name, module in owners.items():
        if getattr(module, "use_kernel", None):
            local = module.num_heads // mesh.n_model
            raise ValueError(
                f"{name}: the fused qkv kernel (use_kernel=True) takes all of a layer's heads "
                f"over an input of their width, an even count of 64-wide heads; "
                f"parallel.model_size={mesh.n_model} leaves {local} heads of "
                f"{module.num_heads} on each rank. Use the split path (use_kernel=None)")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, s in shards.items():
            p = params[name]
            idx = _local_index(p.shape[s.axis], s.kind, mesh.model_rank, mesh.n_model,
                               p.device)
            p.data = p.data.index_select(s.axis, idx).contiguous()
    for module in owners.values():
        module.tp = mesh
    model.tp_shards = shards
    model.tp_mesh = mesh
    return shards


def model_shards(model: nn.Module) -> Tuple[Dict[str, Shard], Optional[Mesh]]:
    """({name: Shard}, mesh) of a sharded model; ({}, None) otherwise."""
    return getattr(model, "tp_shards", {}), getattr(model, "tp_mesh", None)


# -------------------------------------------------------- state dicts
def _state_shard(kind: str, s: Shard, ndim: int) -> Optional[Shard]:
    """How an optimizer buffer of the given kind splits, for a parameter
    that splits as `s` (None: replicated). Adafactor's row (the mean over the
    last axis) keeps the axes before it, its col (the mean over the one
    before) the last."""
    if kind == "row":
        return s if s.axis < ndim - 1 else None
    if kind == "col":
        return Shard(ndim - 2, s.kind) if s.axis == ndim - 1 else None
    return s


def _gather(x: torch.Tensor, s: Shard, mesh: Mesh) -> torch.Tensor:
    """The model group's parts of x joined along s.axis: each rank places
    its part in zeros and the group sums (exact: one term an element is not
    zero)."""
    home = x.device
    if home.type == "cpu" and dist.get_backend(mesh.model_group) == "nccl":
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    shape = list(x.shape)
    shape[s.axis] *= mesh.n_model
    full = x.new_zeros(shape)
    full.index_copy_(s.axis, _local_index(shape[s.axis], s.kind, mesh.model_rank,
                                          mesh.n_model, x.device), x)
    dist.all_reduce(full, group=mesh.model_group)
    return full.to(home)


def _slice(x: torch.Tensor, s: Shard, mesh: Mesh) -> torch.Tensor:
    idx = _local_index(x.shape[s.axis], s.kind, mesh.model_rank, mesh.n_model, x.device)
    return x.index_select(s.axis, idx).contiguous()


def _map_state(state: Mapping, shards: Mapping[str, Shard], ndims: Mapping[str, int], fn
               ) -> dict:
    """A model state_dict ({name: tensor}) or an optimizer state_dict
    ({kind: {name: tensor}, ...}) with fn(tensor, Shard) applied to every
    sharded entry; everything else as it is."""
    out = {}
    for key, val in state.items():
        if isinstance(val, Mapping):
            out[key] = {}
            for name, t in val.items():
                s = shards.get(name)
                s = None if s is None else _state_shard(key, s, ndims[name])
                out[key][name] = t if s is None else fn(t, s)
        elif isinstance(val, torch.Tensor) and key in shards:
            out[key] = fn(val, shards[key])
        else:
            out[key] = val
    return out


def gather_state_dict(state: Mapping, model: nn.Module) -> dict:
    """A sharded model's state_dict, or its optimizer's, in the
    one-process layout: every sharded entry gathered over the model group.
    A collective: every rank of the mesh calls it. The state as it is for
    a model that is not sharded."""
    shards, mesh = model_shards(model)
    if not shards:
        return dict(state)
    ndims = {n: p.dim() for n, p in model.named_parameters()}
    return _map_state(state, shards, ndims, lambda t, s: _gather(t.contiguous(), s, mesh))


def shard_state_dict(state: Mapping, model: nn.Module) -> dict:
    """The inverse of `gather_state_dict`: a one-process state_dict (model
    or optimizer) cut to this rank's parts of `model`'s sharded entries."""
    shards, mesh = model_shards(model)
    if not shards:
        return dict(state)
    ndims = {n: p.dim() for n, p in model.named_parameters()}
    return _map_state(state, shards, ndims, lambda t, s: _slice(t, s, mesh))


# ------------------------------------------------- Megatron's operators
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (the
    input of a column layer, replicated on the model peers)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (a row layer's partial
    products); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's parts joined along `dim` (contiguous parts, rank
    order) forward; this rank's part of the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, x.shape[dim]
        return _gather(x.contiguous(), Shard(dim % x.dim(), "column"), mesh)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.model_rank * ctx.n
        return grad.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


class _LocalBias(torch.autograd.Function):
    """A replicated bias's local columns forward; backward, the ranks'
    parts placed in zeros and summed over the model group, so that every
    rank holds the whole bias gradient."""

    @staticmethod
    def forward(ctx, bias, idx, group):
        ctx.save_for_backward(idx)
        ctx.n, ctx.group = bias.shape[0], group
        return bias.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        full = grad.new_zeros(ctx.n)
        full.index_copy_(0, idx, grad.contiguous())
        dist.all_reduce(full, group=ctx.group)
        return full, None, None


def copy_to_model(x: torch.Tensor, tp: Optional[Mesh]) -> torch.Tensor:
    """The input of a column layer: x itself; its gradient summed over the
    model group."""
    return x if tp is None else _CopyToModel.apply(x, tp.model_group)


def reduce_from_model(x: torch.Tensor, tp: Optional[Mesh]) -> torch.Tensor:
    """The sum over the model group of the ranks' partial x."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.model_group)


def gather_from_model(x: torch.Tensor, tp: Optional[Mesh], dim: int = -1) -> torch.Tensor:
    """The ranks' contiguous parts of x joined along dim, in rank order."""
    return x if tp is None else _GatherFromModel.apply(x, dim, tp)


def local_bias(bias: Optional[torch.Tensor], tp: Optional[Mesh], qkv: bool = False
               ) -> Optional[torch.Tensor]:
    """A column layer's replicated bias cut to this rank's columns (the
    local heads' q, k and v columns with qkv)."""
    if tp is None or bias is None:
        return bias
    idx = _local_index(bias.shape[0], "qkv" if qkv else "column", tp.model_rank, tp.n_model,
                       bias.device)
    return _LocalBias.apply(bias, idx, tp.model_group)


def row_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: Optional[torch.dtype], tp: Optional[Mesh], *, in_out: bool = False
              ) -> torch.Tensor:
    """A row layer: x (.., K/m) times this rank's rows of the weight
    (Linear's (out, K/m), or (K/m, out) with in_out), the partial products
    summed over the model group in f32, rounded to the compute type, then
    the bias added in that type: `layers.dense`'s rounding order (product
    rounded, bias added in the compute type). Without a mesh, `dense`."""
    if tp is None:
        from avt_tpu_torch.models.layers import dense  # layers imports this module

        return dense(x, weight, bias, dtype, in_out=in_out)
    if dtype is not None:
        x, weight = x.to(dtype), weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    w = weight if in_out else weight.t()
    # bf16 products are exact in f32: the partials accumulate in f32
    y = reduce_from_model(torch.matmul(x.float(), w.float()), tp).to(x.dtype)
    return y if bias is None else y + bias


def dropout_columns(n_local: int, tp: Optional[Mesh]) -> Tuple[int, int]:
    """(first global column, global width) of this rank's n_local columns
    of a sharded activation: where a full-width dropout draw is sliced."""
    if tp is None:
        return 0, n_local
    return tp.model_rank * n_local, n_local * tp.n_model
