"""Serving: the eval forward as a callable, and the batching host loop.

Counterpart of avt_tpu/serve.py (`make_eval_forward`, `batch_predict`). The
JAX package serialises the forward as StableHLO; its counterpart here,
torch.export, comes in a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

DEFAULT_OUTPUTS = ("logits/action",)


def make_eval_forward(
    model,
    preprocessor=None,
    outputs: Sequence[str] = DEFAULT_OUTPUTS,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """frames_or_video -> dict of the requested endpoints, on the model's
    device, without autograd.

    With a preprocessor the input is raw (B, T, H, W, 3) uint8 frames (numpy
    or tensor) and the call runs preprocessing + forward, the bench.py
    main_eval topology; without, it is a preprocessed (B, #clips, [#crops,]
    C, T, H, W) video tensor."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def fwd(frames) -> Dict[str, torch.Tensor]:
        if preprocessor is not None:
            video = preprocessor.eval_fn(frames)[:, None]
        else:
            video = torch.as_tensor(frames).to(device)
        outs, _ = model(video)
        return {k: outs[k] for k in outputs}

    return fwd


def batch_predict(fwd: Callable, frames: np.ndarray, batch_size: int) -> Dict[str, np.ndarray]:
    """Splits frames on axis 0 into batches of `batch_size`, pads the tail
    batch with copies of its last clip so every call has one shape, trims
    the padding off the outputs, and concatenates them as numpy arrays. An
    empty input gives empty per-key outputs."""
    n = frames.shape[0]
    if n == 0:  # an empty shard runs the forward on zero clips: no work, right shapes
        return {k: v.float().cpu().numpy() for k, v in fwd(frames).items()}
    outs = []
    for i in range(0, n, batch_size):
        chunk = frames[i:i + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        res = fwd(chunk)
        outs.append({k: v[: batch_size - pad].float().cpu().numpy() for k, v in res.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
