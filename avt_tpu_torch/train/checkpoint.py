"""Checkpoints: the model, the optimizer and the (fractional) epoch.

Counterpart of avt_tpu/train/checkpoint.py (`CKPT_NAME`, `BEST_NAME`,
`save_checkpoint`, `restore_checkpoint`), on `torch.save` in place of
orbax. A checkpoint is one file holding
    {"model": model.state_dict() on the CPU, under the reference's torch
               names (so avt_tpu/models/import_torch.py reads it),
     "optimizer": optimizer.state_dict(),
     "epoch": float,            # fractional for a save inside an epoch
     "host": {...}}             # optional host state (the plateau counters)
written to `<name>.tmp` and renamed over `<name>`, so a crash mid-write
leaves the previous checkpoint whole. Restoring loads on the CPU and
copies into the live tensors, so a checkpoint does not depend on the device
it was written on. Under data parallelism rank 0 writes and every rank
waits at a barrier until the file is whole; every rank resumes from the
same file (the ranks hold the same model and optimizer). Under tensor
parallelism (parallel/mesh.py) every rank joins the gather of the sharded
model and optimizer state, rank 0 writes the one-process layout, and a
resume cuts each rank's part out again: a checkpoint reads back whatever
parallel.model_size wrote or reads it.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from avt_tpu_torch.parallel import ddp
from avt_tpu_torch.parallel.mesh import gather_state_dict, model_shards, shard_state_dict

CKPT_NAME = "checkpoint"
BEST_NAME = "checkpoint_best"


def save_checkpoint(ckpt_dir: str, model, optimizer, epoch: float, *,
                    names: Tuple[str, ...] = (CKPT_NAME,), rank: Optional[int] = None,
                    host_state: Optional[dict] = None) -> None:
    """Writes the rolling checkpoint (and any other `names`) on rank 0 (the
    process group's, unless `rank` is given), then waits at a barrier for
    every rank: a collective, called by every rank at the same point.

    host_state: a small dict of host-side values saved beside the tensors
    (e.g. `ReduceLROnPlateau.state_dict()`)."""
    model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    if model_shards(model)[0]:  # a collective: every rank joins
        model_sd = gather_state_dict(model_sd, model)
        opt_sd = gather_state_dict(opt_sd, model)
    if (ddp.rank() if rank is None else rank) == 0:
        _write(ckpt_dir, model_sd, opt_sd, epoch, names, host_state)
    ddp.barrier()


def _write(ckpt_dir, model_sd, opt_sd, epoch, names, host_state) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu() for k, v in model_sd.items()},
        "optimizer": opt_sd,
        "epoch": float(epoch),
    }
    if host_state:
        payload["host"] = dict(host_state)
    for name in names:
        path = os.path.join(ckpt_dir, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def restore_checkpoint(ckpt_dir: str, model, optimizer, name: str = CKPT_NAME,
                       host_template: Optional[dict] = None
                       ) -> Union[None, float, Tuple[float, dict]]:
    """Loads `<ckpt_dir>/<name>` into `model` and `optimizer` in place (the
    optimizer may be None). Returns None when the file is absent, else the
    epoch, or (epoch, host state) when `host_template` is given: the saved
    host state, or the template itself when the checkpoint has none. Host
    state that was saved but not asked for is dropped."""
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(shard_state_dict(ckpt["model"], model))
    if optimizer is not None:
        optimizer.load_state_dict(shard_state_dict(ckpt["optimizer"], model))
    epoch = float(ckpt["epoch"])
    if host_template is None:
        return epoch
    return epoch, ckpt.get("host", dict(host_template))
