"""VideoClips-style clip samplers + the sampler-wrapping distributed shard.

A copy of avt_tpu/data/clip_samplers.py (numpy only), whose parity target
is the reference's common/sampler.py
  * UniformClipSampler (:63-92): at most max_clips_per_video clips per
    video, equally spaced with step = max(length // max, 1). Replicates the
    torchvision quirk that arange(length)[::step] can emit MORE than
    max_clips_per_video indices (e.g. length=10, max=4 -> step=2 -> 5 clips)
    while __len__ reports sum(min(length, max)) — iteration length and
    __len__ intentionally disagree, exactly like the reference.
  * RandomClipSampler (:95-126): at most max_clips_per_video random clips
    per video, then a global shuffle.
  * DistributedSampler (:10-60): pad-to-divisible strided sharding that can
    wrap ANOTHER sampler — rank r takes positions [r::world] of the
    (optionally shuffled) position list, then maps positions through the
    wrapped sampler's emitted order.

These are selected when a dataset exposes `video_clips`
(func/train.py:606-634); no shipped AVT dataset does, so this is surface
parity for torchvision-style video datasets. The `video_clips` contract
needed here is just per-video clip counts: pass any object with a `.clips`
sequence-of-sequences (torchvision VideoClips satisfies it) or a plain
list of ints.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Union

import numpy as np


def _clip_lengths(video_clips) -> list:
    """Per-video clip counts from a VideoClips-like object or a list."""
    clips = getattr(video_clips, "clips", video_clips)
    return [c if isinstance(c, (int, np.integer)) else len(c) for c in clips]


class UniformClipSampler:
    """Equally-spaced clips per video (reference common/sampler.py:63-92)."""

    def __init__(self, video_clips, max_clips_per_video: int):
        self.clip_lengths = _clip_lengths(video_clips)
        self.max_clips_per_video = max_clips_per_video

    def __iter__(self) -> Iterator[int]:
        idxs = []
        s = 0
        for length in self.clip_lengths:
            step = max(length // self.max_clips_per_video, 1)
            idxs.extend(range(s, s + length, step))
            s += length
        return iter(idxs)

    def __len__(self) -> int:
        return sum(
            min(length, self.max_clips_per_video)
            for length in self.clip_lengths
        )


class RandomClipSampler:
    """At most max_clips_per_video random clips per video, globally
    shuffled (reference common/sampler.py:95-126).

    RNG contract (deliberate delta, documented): the reference draws from
    torch's GLOBAL RNG, whose cross-rank agreement rests on every rank
    having called torch.manual_seed(cfg.seed) and made the same number of
    draws since. Here the order is a pure function of (seed, epoch) —
    re-iterating is idempotent (no hidden RNG mutation from len() or extra
    passes), every rank with the same seed emits the SAME order (so the
    DistributedSamplerWrapper partitions one global permutation instead of
    striding N different ones), and a preempted run's fast-forward replays
    the exact pre-crash order (the bitwise-resume guarantee,
    test_crash_resume_trajectory_equivalence). Reshuffle per epoch via
    set_epoch, like every sampler here."""

    def __init__(
        self,
        video_clips,
        max_clips_per_video: int,
        seed: int = 0,
    ):
        self.clip_lengths = _clip_lengths(video_clips)
        self.max_clips_per_video = max_clips_per_video
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng((self.seed, self.epoch))
        idxs = []
        s = 0
        for length in self.clip_lengths:
            size = min(length, self.max_clips_per_video)
            sampled = rng.permutation(length)[:size] + s
            s += length
            idxs.append(sampled)
        idxs = np.concatenate(idxs) if idxs else np.zeros((0,), np.int64)
        return iter(idxs[rng.permutation(len(idxs))].tolist())

    def __len__(self) -> int:
        return sum(
            min(length, self.max_clips_per_video)
            for length in self.clip_lengths
        )


class DistributedSamplerWrapper:
    """Strided distributed shard over a dataset OR another sampler
    (reference common/sampler.py:10-60).

    Pads the index list to a world-size multiple by repeating from the
    front, then rank r takes positions [rank::num_replicas]. When `source`
    is a sampler (anything with __iter__ but no __getitem__ contract we
    rely on... the reference checks isinstance(dataset, Sampler)), the
    positions index into the wrapped sampler's freshly-emitted order.
    set_epoch reseeds the shuffle exactly like torch's
    Generator().manual_seed(epoch) reshuffle contract (same partition
    semantics; RNG stream is numpy, not torch).
    """

    def __init__(
        self,
        source: Union[Sequence, UniformClipSampler, RandomClipSampler],
        num_replicas: int,
        rank: int,
        shuffle: bool = False,
        is_sampler: Optional[bool] = None,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas}")
        # Explicit sampler-vs-dataset decision (the reference uses
        # isinstance(dataset, Sampler), common/sampler.py:36): known sampler
        # types are samplers, sized indexables are datasets, and anything
        # else must say which it is via `is_sampler` — a duck-typing
        # fallback would silently shard a __getitem__-bearing sampler
        # positionally.
        if is_sampler is None:
            if isinstance(source, (UniformClipSampler, RandomClipSampler)):
                is_sampler = True
            elif hasattr(source, "__getitem__"):
                is_sampler = False
            elif hasattr(source, "__iter__"):
                raise TypeError(
                    f"ambiguous source {type(source).__name__}: pass "
                    "is_sampler=True/False explicitly"
                )
            else:
                is_sampler = False
        self.is_sampler = bool(is_sampler)
        self.source = source
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0
        n = len(source)
        self.num_samples = int(np.ceil(n / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # drive the wrapped sampler's reshuffle too: the loader only calls
        # set_epoch on the outermost sampler (like torch DataLoader)
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    def _is_sampler(self) -> bool:
        return self.is_sampler

    def __iter__(self) -> Iterator[int]:
        n = len(self.source)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        assert len(indices) == self.total_size
        indices = indices[self.rank : self.total_size : self.num_replicas]
        assert len(indices) == self.num_samples
        if self._is_sampler():
            orig = list(iter(self.source))
            indices = [orig[i] for i in indices]
        return iter(indices)

    def __len__(self) -> int:
        return self.num_samples


def build_clip_samplers(
    train_dataset,
    eval_datasets: dict,
    *,
    train_bs_multiplier: int,
    val_clips_per_video: int,
    rank: int = 0,
    world_size: int = 1,
    shuffle_data: bool = True,
):
    """Sampler selection for datasets exposing `video_clips`
    (func/train.py:606-634). Returns (train_sampler, {key: eval_sampler})
    or (None, {key: None}) when the dataset has no video_clips."""
    if not hasattr(train_dataset, "video_clips"):
        return None, {key: None for key in eval_datasets}
    assert shuffle_data, "TODO"  # the reference asserts the same
    train_sampler = RandomClipSampler(
        train_dataset.video_clips, train_bs_multiplier
    )
    eval_samplers = {
        key: UniformClipSampler(ds.video_clips, val_clips_per_video)
        for key, ds in eval_datasets.items()
    }
    if world_size > 1:
        train_sampler = DistributedSamplerWrapper(
            train_sampler, world_size, rank
        )
        eval_samplers = {
            key: DistributedSamplerWrapper(s, world_size, rank)
            for key, s in eval_samplers.items()
        }
    return train_sampler, eval_samplers
