"""Data parallelism over processes (parallel/ddp.py)."""
from avt_tpu_torch.parallel.ddp import (
    all_gather_with_grad,
    all_reduce_with_grad,
    allreduce_gradients,
    barrier,
    broadcast_module,
    check_model_parallel,
    cleanup,
    rank,
    resolve_backend,
    setup_distributed,
    world_size,
)

__all__ = [
    "all_gather_with_grad", "all_reduce_with_grad", "allreduce_gradients", "barrier",
    "broadcast_module", "check_model_parallel", "cleanup", "rank", "resolve_backend",
    "setup_distributed", "world_size",
]
