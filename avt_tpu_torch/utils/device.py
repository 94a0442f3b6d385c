"""Where the port's entry points run: CUDA unless the CPU is asked for."""
from __future__ import annotations

import os

import torch

from avt_tpu_torch.utils import trace


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the GPU, and raises when
    there is none rather than running on the CPU unasked. Under a launcher
    the GPU is this process's: cuda:LOCAL_RANK, modulo the host's card count
    so that gloo ranks can share a card (setup_distributed refuses that
    under NCCL)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        local = os.environ.get("LOCAL_RANK") or os.environ.get("SLURM_LOCALID")
        if local is None:
            return torch.device("cuda")
        return torch.device("cuda", int(local) % torch.cuda.device_count())
    return torch.device(device)


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


def upload(frames, device) -> torch.Tensor:
    """`frames` (numpy or a tensor) as a tensor on `device`: a copy from the
    host to a device runs under the span `avt.preprocess.upload`."""
    x = torch.as_tensor(frames)
    device = torch.device(device)
    if x.device.type != "cpu" or device.type == "cpu":
        return x.to(device)
    with trace.span("avt.preprocess.upload"):
        return x.to(device)
