"""Breakfast and 50Salads datasets.

Counterpart of avt_tpu/data/breakfast_50salads.py, whose parity target is
the reference's datasets/breakfast_50salads.py: Abu-Farha per-frame label
files or the original annotations (50Salads' timestamped activity files,
Breakfast's .labels files), fold bundles 'train/test.splitN.bundle', the
class mapping file, and Sener et al.'s pre-extracted feature reader (gz or
npy). The annotation table is the port's `Table`; video fps comes from the
port's native decoder unless a `video_info_fn` is given.
"""
from __future__ import annotations

import gzip
import logging
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from avt_tpu_torch.data.dataset import VideoDataset
from avt_tpu_torch.data.readers import Reader
from avt_tpu_torch.data.table import Table

LOG = logging.getLogger(__name__)


def load_mappings_file(fpath) -> Dict[str, int]:
    """Abu-Farha mapping file: '<id> <name>' lines -> {name: index}."""
    res = []
    with open(fpath, "r") as fin:
        for line in fin:
            res.append(line.rpartition(" ")[-1].strip())
    return dict(zip(res, range(len(res))))


def bundle_entry_to_video_fname_50salads(bundle_entry, root=None):
    video_id = bundle_entry.strip()[len("rgb-"):-len(".txt")]
    return f"rgb-{video_id}.avi", f"{video_id}-activityAnnotation.txt"


def bundle_entry_to_video_fname_breakfast(bundle_entry, root):
    person, camera, _, topic = bundle_entry.strip()[:-len(".txt")].split("_")
    channels = [""]
    if camera.startswith("stereo"):
        channels = ["_ch0", "_ch1"]  # ch0 is not always present
        camera = "stereo"
    video_fname = f"{person}/{camera}/{person}_{topic}{{channel}}.avi"
    annot_fname = f"{video_fname}.labels"
    for channel in channels:
        if (Path(root) / annot_fname.format(channel=channel)).exists():
            video_fname = video_fname.format(channel=channel)
            annot_fname = annot_fname.format(channel=channel)
            break
    return video_fname, annot_fname


def _default_video_info(path):
    from avt_tpu_torch.data.video_decoder import get_video_info

    return get_video_info(path)


def read_orig_50salads_annotations(
    videos: Sequence[str], root, action_classes: Dict[str, int],
    annots_dir, timestamps_dir, video_info_fn=None,
):
    """Original 50Salads activityAnnotation files -> (video, path, s, e, label).

    Timestamps are RGB-frame hardware stamps; the per-frame timestamp file
    maps them back to frame indices. Coarse labels (no _prep/_core/_post
    suffix) are skipped.
    """
    all_segments = []
    for video in videos:
        video_fname, annot_fname = bundle_entry_to_video_fname_50salads(video)
        video_id = video.strip()[len("rgb-"):-len(".txt")]
        frame_rate = (video_info_fn or _default_video_info)(Path(root) / video_fname)["fps"]
        frame_ts = []
        with open(Path(timestamps_dir) / f"timestamps-{video_id}.txt") as fin:
            for line in fin:
                frame_ts.append(int(line.partition(" ")[0]))
        with open(Path(annots_dir) / annot_fname, "r") as fin:
            for line in fin:
                start_ts, end_ts, activity = line.split(" ")
                act_pre, _, act_post = activity.strip().rpartition("_")
                if act_post not in ("prep", "core", "post"):
                    continue  # coarse-grained label
                label = action_classes[act_pre]
                start = frame_ts.index(int(start_ts)) / frame_rate
                # index(end_ts + 1) looks up the timestamp VALUE end + 1, as
                # the reference does (breakfast_50salads.py:72): it presumes
                # consecutive annotation timestamps, as the original data has
                end = frame_ts.index(int(end_ts) + 1) / frame_rate
                all_segments.append((video, video_fname, start, end, label))
    return all_segments


def read_orig_breakfast_annotations(videos: Sequence[str], root,
                                    action_classes: Dict[str, int]):
    """Breakfast .labels files: '<start>-<end> <activity>' at 15 fps."""
    video_fps = 15
    all_segments = []
    for video in videos:
        video_fname, annot_fname = bundle_entry_to_video_fname_breakfast(video, root)
        with open(Path(root) / annot_fname, "r") as fin:
            for line in (el.strip() for el in fin):
                start_end, activity = line.split(" ")
                start, end = start_end.split("-")
                if activity not in action_classes:
                    LOG.warning("Unknown activity %s; skipped", activity)
                    continue
                all_segments.append((video, video_fname, int(start) / video_fps,
                                     int(end) / video_fps, action_classes[activity]))
    return all_segments


def read_abu_farha_annotations(
    videos: Sequence[str],
    root,
    action_classes: Dict[str, int],
    annots_dir,
    bundle_entry_to_vname_fn: Callable,
    frame_rate: Optional[float] = None,
    video_info_fn=None,
):
    """Abu-Farha per-frame label txts -> contiguous segments.

    Run-length encodes the frame labels; segment ends extend to (lno+1)/fps
    so adjacent segments leave no -1 gaps (reference :150-170).
    """
    all_segments = []
    for video in videos:
        video_fname, _ = bundle_entry_to_vname_fn(video.strip(), root)
        fr = frame_rate
        if fr is None:
            fr = (video_info_fn or _default_video_info)(Path(root) / video_fname)["fps"]
        with open(Path(annots_dir) / video.strip(), "r") as fin:
            cur_action = ""
            for lno, line in enumerate(fin):
                if line == cur_action:
                    all_segments[-1][-2] = (lno + 1) / fr
                    continue
                cur_action = line
                all_segments.append([video, video_fname, lno / fr, (lno + 1) / fr,
                                     action_classes[cur_action.strip()]])
    return all_segments


def init_df(bundle_fpath, annot_reader_fn: Callable, root, action_classes) -> Table:
    with open(bundle_fpath, "r") as fin:
        videos = fin.readlines()
    assert videos[0].startswith("#"), "bundle files start with a # header"
    videos = videos[1:]
    segments = annot_reader_fn(videos, root, action_classes)
    names = ["video_bundle_name", "video_path", "start", "end", "action_class"]
    cols = {name: [seg[i] for seg in segments] for i, name in enumerate(names)}
    # start and end are float16, as the reference stores them
    # (breakfast_50salads.py:192-197): timestamps quantize (~0.5 s past
    # 512 s), and the anticipation windows downstream carry that
    cols["start"] = np.asarray(cols["start"], dtype=np.float64).astype(np.float16)
    cols["end"] = np.asarray(cols["end"], dtype=np.float64).astype(np.float16)
    cols["action_class"] = np.asarray(cols["action_class"], dtype=np.int64)
    return Table(cols)


class Breakfast50Salads(VideoDataset):
    """Univ. of Dundee 50Salads / Bonn Breakfast anticipation datasets."""

    def __init__(
        self,
        which: str,  # '50Salads' | 'Breakfast'
        root,
        splits_dir,
        classes_fpath,
        is_train: bool = True,
        fold: int = 1,
        annot_reader_fn: Optional[Callable] = None,
        **kwargs,
    ):
        bundle_fpath = Path(splits_dir) / f'{"train" if is_train else "test"}.split{fold}.bundle'
        self.which = which
        if which == "50Salads":
            assert 1 <= fold <= 5
        elif which == "Breakfast":
            assert 1 <= fold <= 4
        else:
            raise NotImplementedError(f"Unknown dataset {which!r}")
        action_classes = load_mappings_file(classes_fpath)
        df = init_df(bundle_fpath, annot_reader_fn, root, action_classes)
        kwargs["action_classes"] = action_classes
        kwargs["label_type"] = "action"
        super().__init__(df, root=root, **kwargs)


# ------------------------------------------------------- feature readers
class GZFormatReader:
    """Sener et al. features: one space-separated float line per frame."""

    def __call__(self, path, start_frame: int, end_frame: int) -> np.ndarray:
        feats = []
        with gzip.open(str(path).replace(".txt", ".gz"), "r") as fin:
            for lno, line in enumerate(fin):
                if start_frame <= lno <= end_frame:
                    feats.append([float(el) for el in line.strip().split(b" ")])
        return np.asarray(feats, dtype=np.float32)


class NPYFormatReader:
    """Features as (C, T) .npy per video."""

    def __call__(self, path, start_frame: int, end_frame: int) -> np.ndarray:
        feats = np.load(str(path).replace(".txt", ".npy"))
        start_frame = max(start_frame, 0)
        end_frame = min(end_frame, feats.shape[1])
        return np.ascontiguousarray(feats[:, start_frame:end_frame + 1].T).astype(np.float32)


class SenerFeatsReader(Reader):
    """Pre-extracted Breakfast/50Salads features keyed by bundle name."""

    def __init__(self, feat_dir, format_reader, video_info_fn=None):
        self.feat_dir = Path(feat_dir)
        self.format_reader = format_reader
        self._video_info_fn = video_info_fn

    def get_frame_rate(self, video_path) -> float:
        return (self._video_info_fn or _default_video_info)(video_path)["fps"]

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        vidname = row["video_bundle_name"].strip()
        start_frame = int(round(start_sec * fps - 1))
        end_frame = int(round(end_sec * fps - 1))
        feats = self.format_reader(self.feat_dir / vidname, start_frame, end_frame)
        return feats[:, None, None, :], {}
