"""Anticipation window math on annotation tables.

Counterpart of avt_tpu/data/anticipation.py (`convert_to_anticipation`,
`break_segments_by_duration`, `dense_labels_to_segments`, `get_abs_path`,
`dense_clip_sampler`), on the port's `Table` in place of a DataFrame. Every
downstream number depends on these, so they follow the JAX package (and the
reference's datasets/base_video_dataset.py) step for step.

An annotated action spans [start, end]. For anticipation the model
observes tau_o seconds of video that end tau_a seconds before the action
starts: observed = [start - tau_a - tau_o, start - tau_a].
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from avt_tpu_torch.data.table import Table

# Frame rate at which the RULSTM project stored pre-extracted EPIC features;
# also defines the "first frame" cutoff used by the drop rules.
RULSTM_TSN_FPS = 30.0
FUTURE_PREFIX = "future"


def convert_to_anticipation(
    df: Table,
    tau_a: float,
    tau_o: float,
    future_clip_ratios: Sequence[float] = (1.0,),
    drop_style: str = "correct",
) -> Tuple[Table, Table]:
    """Shift each action's [start, end] to its anticipation observation window.

    Args:
      df: annotations with at least columns {uid, start, end}.
      tau_a: anticipation gap in seconds. Special value -999 = plain
        recognition (window == the action segment itself).
      tau_o: observed duration in seconds.
      future_clip_ratios: one future clip per ratio r: it starts at
        end' + tau_a*r and spans tau_o seconds. Special value -999 = the
        observed clip itself.
      drop_style: which converted rows to keep:
        'correct'          -> at least one frame observable (end' >= 1/30 s)
        'full_context_in'  -> whole window inside the video (start' >= 1/30 s)
        'action_banks'     -> end' >= 2 s (action-banks convention)
    Returns:
      (kept rows with orig_start/orig_end/future_i_* columns, the dropped
       rows).
    """
    df = df.copy()
    if tau_a == -999:
        # Recognition mode: window equals the original segment; keep going so
        # orig_*/future_* columns still get created.
        tau_a = df["start"] - df["end"]
        tau_o = df["end"] - df["start"]
    df["orig_start"] = df["start"]
    df["orig_end"] = df["end"]
    df["end"] = df["start"] - tau_a
    df["start"] = df["end"] - tau_o
    for i, ratio in enumerate(future_clip_ratios):
        if ratio == -999:
            df[f"{FUTURE_PREFIX}_{i}_start"] = df["start"]
            df[f"{FUTURE_PREFIX}_{i}_end"] = df["end"]
        elif -10 < ratio < 10:
            eff_tau_a = tau_a * ratio
            df[f"{FUTURE_PREFIX}_{i}_start"] = df["end"] + eff_tau_a
            df[f"{FUTURE_PREFIX}_{i}_end"] = df[f"{FUTURE_PREFIX}_{i}_start"] + tau_o
        else:
            raise ValueError(f"future_clip_ratio out of bounds: {ratio}")

    f1_sec = 1.0 / RULSTM_TSN_FPS
    if drop_style == "correct":
        keep = df["end"] >= f1_sec
    elif drop_style == "full_context_in":
        keep = df["start"] >= f1_sec
    elif drop_style == "action_banks":
        keep = df["end"] >= 2
    else:
        raise NotImplementedError(f"Unknown drop_style {drop_style!r}")
    return df.mask(keep), df.mask(~keep)


def break_segments_by_duration(duration, label, segment_len):
    """Split one labeled duration into fixed-length segments.

    Returns ([[seg_len, *label], ...], total_duration_used). With
    segment_len=None the segment keeps its full duration.
    """
    if not isinstance(label, list):
        label = [label]
    if segment_len is None:
        return [[duration] + label], duration
    nseg = int(round(duration / segment_len))
    return [[segment_len] + label for _ in range(nseg)], nseg * segment_len


def dense_labels_to_segments(
    dense_labels,
    segment_start_time,
    segment_end_time,
    pred_steps: int = -1,
    fixed_duration: Optional[float] = None,
    dummy_label=-1,
):
    """Convert (start, end, label) dense annotations into a segment list
    covering [segment_start_time, segment_end_time], inserting dummy-labeled
    gaps, optionally re-chunked to fixed_duration and padded/truncated to
    pred_steps entries.
    """
    segments = []
    for start, end, label in dense_labels:
        if end < segment_start_time:
            continue  # action already over
        if start > segment_end_time:
            continue  # action starts after the window
        end = min(end, segment_end_time)
        if start > segment_start_time:
            # unknown gap -> dummy so the model isn't penalized there
            new_segments, used = break_segments_by_duration(
                start - segment_start_time, dummy_label, fixed_duration)
            segments += new_segments
            segment_start_time += used
        new_segments, used = break_segments_by_duration(
            end - segment_start_time, label, fixed_duration)
        segments += new_segments
        segment_start_time += used
        if fixed_duration is None and segment_start_time != end:
            raise AssertionError(f"segment ends at {segment_start_time}, not {end}")
        if pred_steps > 0 and len(segments) >= pred_steps:
            break
    if pred_steps > 0:
        segments = segments[:pred_steps]
        dummy = dummy_label if isinstance(dummy_label, list) else [dummy_label]
        segments += [[-1] + dummy] * (pred_steps - len(segments))
    return segments


def get_abs_path(root_dirs: Sequence[Path], fpath) -> Path:
    """Join fpath with the first root dir under which it exists."""
    res = None
    for root_dir in root_dirs:
        res = Path(root_dir) / fpath
        if res.exists():
            return res
    return res  # last candidate; caller deals with the miss


def dense_clip_sampler(
    df: Table,
    video_len_fn: Callable[[str], float],
    clip_len="mean_action_len",
    stride: float = 1.0,
    shard: Tuple[int, int] = (0, 1),
    keep_orig_clips: bool = True,
    skip_uids: Optional[set] = None,
) -> Tuple[Table, Table]:
    """Add clips sampled densely over each video (label -1); for SSL and
    feature extraction. Video durations come from `video_len_fn`; `shard`
    is this process's (rank, world)."""
    uniq_videos = sorted(set(df["video_path"].tolist()))
    rank, world = shard
    if world > 1:
        per = int(math.ceil(len(uniq_videos) / world))
        uniq_videos = uniq_videos[per * rank: min((rank + 1) * per, len(uniq_videos))]
    skip_uids = skip_uids or set()
    if clip_len == "mean_action_len":
        clip_len = float(np.mean(df["end"] - df["start"]))
    new_rows = []
    for vid_path in uniq_videos:
        end_s = video_len_fn(vid_path)
        stem = Path(vid_path).stem
        for new_end in np.arange(0, end_s, stride):
            uid = f"{stem}_{new_end}"
            if uid in skip_uids:
                continue
            new_rows.append({
                "participant_id": stem.split("_")[0],
                "narration": "",
                "video_id": stem,
                "start": new_end - clip_len,
                "end": new_end,
                "verb_class": -1,
                "noun_class": -1,
                "action_class": -1,
                "video_path": vid_path,
                "uid": uid,
            })
    new_df = Table.from_records(new_rows)
    if keep_orig_clips:
        df = df.copy()
        df["uid"] = [str(u) for u in df["uid"]]
        new_df = Table.concat([df, new_df])
    return new_df, Table()
