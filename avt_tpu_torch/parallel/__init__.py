"""Data parallelism over processes (parallel/ddp.py) and tensor parallelism
over a (data, model) mesh of them (parallel/mesh.py)."""
from avt_tpu_torch.parallel.ddp import (
    all_gather_with_grad,
    all_reduce_with_grad,
    allreduce_gradients,
    barrier,
    broadcast_module,
    cleanup,
    data_rank,
    data_world,
    model_rank,
    rank,
    resolve_backend,
    setup_distributed,
    world_size,
)
from avt_tpu_torch.parallel.mesh import (
    DEFAULT_PARAM_RULES,
    Mesh,
    current_mesh,
    gather_state_dict,
    make_mesh,
    shard_model,
    shard_state_dict,
)

__all__ = [
    "DEFAULT_PARAM_RULES", "Mesh", "all_gather_with_grad", "all_reduce_with_grad",
    "allreduce_gradients", "barrier", "broadcast_module", "cleanup", "current_mesh",
    "data_rank", "data_world", "gather_state_dict", "make_mesh", "model_rank", "rank",
    "resolve_backend", "setup_distributed", "shard_model", "shard_state_dict", "world_size",
]
