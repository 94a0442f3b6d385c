"""Where the port's entry points run: CUDA unless the CPU is asked for."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the GPU, and raises when
    there is none rather than running on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def require_one_process(what: str) -> None:
    """Raises NotImplementedError under a torch.distributed group of more
    than one process: `what` runs as one process until the DDP slice
    (ROADMAP Queue 1.9) ports its multi-process branches, rather than as
    several unsynchronised copies of a one-process run."""
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            f"{what} runs in one process; its multi-process form waits for the DDP slice "
            "(ROADMAP Queue 1.9)")


def batch_to_device(node, device):
    """A batch's arrays (numpy or tensors, in nested dicts) as tensors on
    `device`. A host array bound for a card goes through pinned memory, so
    that the copy is queued without waiting for the work already queued (a
    copy from pageable memory may wait for it)."""
    if isinstance(node, dict):
        return {k: batch_to_device(v, device) for k, v in node.items()}
    x = torch.as_tensor(node)
    if torch.device(device).type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)
