"""Clip-window and frame-sampling math as pure functions.

A copy of avt_tpu/data/sampling.py (numpy only): the window and index math
of the reference's BaseVideoDataset._sample, factored out of the reader so
any reader (LMDB or npy features, frames) plugs in.

Pipeline per clip:
  1. compute_read_window: pick [new_start, new_end] seconds inside the
     annotation's [start, end] by strategy (random/center/last/first).
  2. reader decodes/fetches all frames in the window -> n_read frames.
  3. subsample_indices: stride-subsample to the requested frame rate
     (from the back for 'last_clip').
  4. pad_or_crop_indices: edge-pad (repeat first frame for 'last_clip',
     last frame otherwise) or crop to exactly frames_per_clip.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SAMPLE_STRAT_CNTR = "center_clip"
SAMPLE_STRAT_RAND = "random_clip"
SAMPLE_STRAT_LAST = "last_clip"
SAMPLE_STRAT_FIRST = "first_clip"


def compute_read_window(
    start: float,
    end: float,
    fps: float,
    frames_per_clip: int,
    frame_rate: Optional[float],
    sample_strategy: str,
    rng: np.random.Generator,
) -> Tuple[float, float, float]:
    """Pick the [new_start, new_end] second range to read from the video.

    Returns (new_start, new_end, effective_fps). fps<=0 (empty/corrupt
    video) is coerced to frame_rate so downstream shapes stay static; the
    caller will produce black frames.
    """
    start = max(start, 0.0)
    end = max(end, 0.0)
    if fps <= 0:
        fps = frame_rate
        if fps is None or fps <= 0:
            fps = 30.0
    req_fps = frame_rate if frame_rate is not None else fps
    nframes = int(fps * (end - start))
    frames_to_ext = int(round(frames_per_clip * (fps / req_fps)))
    if sample_strategy == SAMPLE_STRAT_RAND:
        start_frame = max(nframes - frames_to_ext, 0)
        if start_frame > 0:
            start_frame = int(rng.integers(start_frame))
    elif sample_strategy == SAMPLE_STRAT_CNTR:
        start_frame = max((nframes - frames_to_ext) // 2, 0)
    elif sample_strategy == SAMPLE_STRAT_LAST:
        start_frame = max(nframes - frames_to_ext, 0)
    elif sample_strategy == SAMPLE_STRAT_FIRST:
        start_frame = 0
    else:
        raise NotImplementedError(f"Unknown sample strategy {sample_strategy!r}")
    new_start = start + max(start_frame / fps, 0)
    new_end = start + max((start_frame + frames_to_ext) / fps, 0)
    # Clamp: never bleed past the annotation end (anticipation!) or before 0.
    new_end = max(min(end, new_end), 0)
    new_start = min(max(new_start, 0), new_end)
    return new_start, new_end, fps


def frame_seconds(new_start: float, new_end: float, n_read: int) -> np.ndarray:
    """Second timestamp of each read frame (reference :570-573)."""
    if new_start >= new_end:
        return np.full((n_read,), new_start, dtype=np.float64)
    return np.linspace(new_start, new_end, n_read)


def subsample_indices(
    n_read: int, fps: float, frame_rate: Optional[float], sample_strategy: str
) -> np.ndarray:
    """Stride-subsample read frames to the requested rate.

    'last_clip' strides from the back so the final frame is always kept
    (reference :576-583); other strategies stride from the front.
    """
    req_fps = frame_rate if frame_rate is not None else fps
    stride = max(int(round(fps / req_fps)), 1)
    if sample_strategy == SAMPLE_STRAT_LAST:
        keep = list(range(n_read))[::-stride][::-1]
    else:
        keep = list(range(n_read))[::stride]
    return np.asarray(keep, dtype=np.int64)


def pad_or_crop_indices(
    indices: np.ndarray, frames_per_clip: int, sample_strategy: str
) -> np.ndarray:
    """Edge-pad or crop subsampled indices to exactly frames_per_clip.

    'last_clip' repeats the FIRST frame at the front and crops from the
    back; others repeat the LAST frame at the end and crop from the front
    (reference :606-633).
    """
    n = len(indices)
    if n == 0:
        raise ValueError("Cannot pad an empty index list")
    if n < frames_per_clip:
        npad = frames_per_clip - n
        if sample_strategy == SAMPLE_STRAT_LAST:
            indices = np.concatenate([np.repeat(indices[:1], npad), indices])
        else:
            indices = np.concatenate([indices, np.repeat(indices[-1:], npad)])
    if sample_strategy == SAMPLE_STRAT_LAST:
        return indices[-frames_per_clip:]
    return indices[:frames_per_clip]


def sample_clip_frames(
    n_read: int,
    new_start: float,
    new_end: float,
    fps: float,
    frame_rate: Optional[float],
    frames_per_clip: int,
    sample_strategy: str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Steps 3+4 combined: indices into the read frames and their seconds.

    Returns (idx[frames_per_clip] int64, sec[frames_per_clip] float64).
    If n_read == 0 the caller must produce an empty (black) clip with
    sec == -1 (reference :598-605).
    """
    if n_read == 0:
        raise ValueError("n_read must be > 0; handle empty clips at the caller")
    secs = frame_seconds(new_start, new_end, n_read)
    keep = subsample_indices(n_read, fps, frame_rate, sample_strategy)
    final = pad_or_crop_indices(keep, frames_per_clip, sample_strategy)
    return final, secs[final]
