"""Faults planted under a run (`cell.run(..., tamper=fault)`): the test that
`correct` comes out false for each, and the readings of the faults on the
card, which bound a limit from above. None of them runs in a benchmark run.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

SHIFT_PX = 3  # a crop this many pixels out, in each axis
SCALE = 1.03  # a resize this much too large


def _rows(x, n):
    if isinstance(x, dict):
        return {k: _rows(v, n) for k, v in x.items()}
    return x[:n]


def unchanged_state(kind, obj, model):
    """A train step that returns the model's parameters as they were."""
    if kind != "train":
        return obj

    def step(batch, generator=None):
        before = [p.detach().clone() for p in model.parameters()]
        out = obj(batch, generator)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return out
    return step


def half_batch(kind, obj, model):
    """Half of the batch left out: a train step over its first half (the
    losses' mean over the rest), a request answered from its first half."""
    if kind == "train":
        def step(batch, generator=None):
            return obj(_rows(batch, batch["target"]["action"].shape[0] // 2), generator)
        return step

    def fwd(frames):
        half = {k: v for k, v in obj(frames[: frames.shape[0] // 2]).items()}
        return {k: torch.cat([v, v[-1:].expand(frames.shape[0] - v.shape[0], *v.shape[1:])])
                for k, v in half.items()}
    return fwd


def altered_answer(kind, obj, model):
    """One clip's action logits moved by one class where the classifier
    makes them (every score of that clip's answer wrong)."""
    def bump(module, args, out):
        out = out.clone()
        out[0] = out[0].roll(1, dims=-1)
        return out
    model.classifiers["action"].register_forward_hook(bump)
    return obj


def crop_offset(kind, obj, model):
    """Every crop SHIFT_PX pixels down and right of where it was drawn (the
    frames rolled before preprocessing)."""
    if kind == "train":
        def step(batch, generator=None):
            video = batch["video"]
            if video.dim() != 5:  # features: no crop to move
                return obj(batch, generator)
            return obj({**batch, "video": video.roll((-SHIFT_PX, -SHIFT_PX), dims=(2, 3))},
                       generator)
        return step

    def fwd(frames):
        return obj(np.roll(np.asarray(frames), (-SHIFT_PX, -SHIFT_PX), axis=(2, 3)))
    return fwd


@contextlib.contextmanager
def _scaled():
    from avt_tpu_torch.data.transforms import VideoPreprocessor

    train, evals = VideoPreprocessor._train_scales, VideoPreprocessor._eval_resize_shape
    with mock.patch.object(VideoPreprocessor, "_train_scales",
                           lambda self, s, H, W: tuple(f * SCALE for f in train(self, s, H, W))), \
            mock.patch.object(VideoPreprocessor, "_eval_resize_shape",
                              lambda self, H, W: tuple(int(n * SCALE) for n in evals(self, H, W))):
        yield


def wrong_scale(kind, obj, model):
    """Every resize SCALE times the size drawn (train) or set (eval)."""
    def call(*args):
        with _scaled():
            return obj(*args)
    return call


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "crop_offset": crop_offset,
          "wrong_scale": wrong_scale}
