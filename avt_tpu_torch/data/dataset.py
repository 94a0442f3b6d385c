"""Host-side video/feature dataset over an annotation table.

Counterpart of avt_tpu/data/dataset.py (`ConcatDataset`, `VideoDataset`),
whose parity target is the reference's datasets/base_video_dataset.py.
Everything that decides which features (or frames) and labels a sample
sees is the JAX package's: the anticipation conversion hook, the clip
sampling strategies with the fps resample and edge padding, the subclip
fold, per-frame past labels with the overlap rule, `repeat_data_times`,
the class-balanced index remap, `uid_subset` and the class counts. Items
are plain numpy dicts; the annotations are the port's `Table`.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from avt_tpu_torch.data.anticipation import FUTURE_PREFIX, get_abs_path
from avt_tpu_torch.data.sampling import (
    SAMPLE_STRAT_FIRST,
    SAMPLE_STRAT_RAND,
    compute_read_window,
    sample_clip_frames,
)
from avt_tpu_torch.data.table import Table

LOG = logging.getLogger(__name__)


class ConcatDataset:
    """Concatenation of datasets for multi-dataset training.

    Parity: the reference concatenates all dataset_train* keys with torch's
    ConcatDataset (func/train.py:586-593); class metadata comes from the
    first dataset (they must share a label space).
    """

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("need at least one dataset")
        self.datasets = list(datasets)
        self._offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        ds_idx = int(np.searchsorted(self._offsets, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self._offsets[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]

    # Only dataset-level metadata delegates to the first dataset (the
    # reference reads these off the train dataset after ConcatDataset,
    # func/train.py:586-599). A catch-all __getattr__ would mask attribute
    # typos and confuse copy/pickle protocols probing dunders.
    _DELEGATED = (
        "classes", "classes_manyshot", "class_mappings", "primary_metric",
        "classes_counts", "label_type",
    )

    def __getattr__(self, name):
        if name in ConcatDataset._DELEGATED:
            return getattr(self.datasets[0], name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )


class VideoDataset:
    """Dataset of anticipation clips; indexable by int, yields NumPy dicts."""

    def __init__(
        self,
        df: Union[Table, Dict[str, Sequence]],
        root: Union[str, Sequence[str]] = "",
        frames_per_clip: int = 32,
        frame_rate: Optional[float] = None,
        subclips_options: Optional[Dict[str, int]] = None,
        load_seg_labels: bool = False,
        load_long_term_future_labels: int = 0,
        reader=None,
        transform: Optional[Callable] = None,
        label_type: Union[str, Sequence[str]] = "verb",
        return_future_clips_too: bool = False,
        sample_strategy: str = SAMPLE_STRAT_RAND,
        sample_strategy_future: str = SAMPLE_STRAT_FIRST,
        conv_to_anticipate_fn: Optional[Callable] = None,
        conv_to_anticipate_fn_runtime: Optional[Callable] = None,
        process_df_before_read_fn: Optional[Callable] = None,
        sample_clips_densely_fn: Optional[Callable] = None,
        random_seed: int = 42,
        verb_classes: Optional[dict] = None,
        noun_classes: Optional[dict] = None,
        action_classes: Optional[dict] = None,
        repeat_data_times: float = 1.0,
        dummy_label: Union[list, int] = -1,
        class_balanced_sampling: bool = False,
        uid_subset: Optional[list] = None,
    ):
        self.root = [Path(el) for el in ([root] if isinstance(root, (str, Path)) else list(root))]
        self.df = df if isinstance(df, Table) else Table(df)
        if "uid" not in self.df:
            self.df = self.df.copy()
            self.df["uid"] = np.arange(1, len(self.df) + 1)
        if sample_clips_densely_fn is not None:
            self.df, _ = sample_clips_densely_fn(self.df)
        self.conv_to_anticipate_fn = conv_to_anticipate_fn
        # Runtime variant: applied per ROW in __getitem__ (for datasets too
        # large to convert up front, e.g. HowTo100M-style dense data;
        # reference base_video_dataset.py:291,323,773-778 declares the hook
        # without shipping an implementation either).
        if conv_to_anticipate_fn and conv_to_anticipate_fn_runtime:
            raise ValueError("conv_to_anticipate_fn and conv_to_anticipate_fn_runtime are "
                             "mutually exclusive")
        self.conv_to_anticipate_fn_runtime = conv_to_anticipate_fn_runtime
        self.discarded_df = None
        if conv_to_anticipate_fn is not None:
            self.df, self.discarded_df = conv_to_anticipate_fn(self.df)
        # Interface key for challenge submission packaging.
        self.challenge_type = (
            "action_anticipation"
            if (conv_to_anticipate_fn or conv_to_anticipate_fn_runtime)
            else "action_recognition"
        )
        self.subclips_options = subclips_options
        self.load_seg_labels = load_seg_labels
        self.load_long_term_future_labels = load_long_term_future_labels
        self.repeat_data_times = repeat_data_times
        self.process_df_before_read_fn = process_df_before_read_fn
        self.frames_per_clip = frames_per_clip
        self.frame_rate = frame_rate
        self.reader = reader
        self.transform = transform
        # (frame_shape, dtype) learned from the first successful read on
        # the static-shape path; lets corrupt clips become black/zero
        # frames (reference :598-605) instead of dropped items. Benign
        # race under loader threads (worst case: a few early Nones).
        self._frame_shape_dtype = None
        self.label_type = [label_type] if isinstance(label_type, str) else list(label_type)
        self.verb_classes = dict(verb_classes or {})
        self.noun_classes = dict(noun_classes or {})
        self.action_classes = dict(action_classes or {})
        self.return_future_clips_too = return_future_clips_too
        self.sample_strategy = sample_strategy
        self.sample_strategy_future = sample_strategy_future
        self.random_seed = random_seed
        self.rng = np.random.default_rng(random_seed)
        self.dummy_label = dummy_label
        self.classes_counts = self._compute_stats_cls_counts()
        self.class_balanced_sampling = class_balanced_sampling
        if self.class_balanced_sampling:
            if len(self.label_type) != 1:
                raise ValueError("balanced sampling needs 1 task")
            self.df = self.df.sort_values(by=self.label_type[0] + "_class")
        # Keep the pre-subset df: past-frame labels must see ALL annotations
        # of a video, even ones subset out of this split view.
        self.df_before_subset = self.df
        if uid_subset is not None:
            # get_indexer maps missing uids to -1 (iloc[-1] would silently
            # substitute the LAST row) — drop them loudly instead
            idxs = self.df.get_indexer("uid", uid_subset)
            if (idxs < 0).any():
                missing = [u for u, i in zip(uid_subset, idxs) if i < 0]
                LOG.warning(
                    "uid_subset: %d uids not in the dataset (e.g. %s); "
                    "skipping them", len(missing), missing[:5],
                )
                idxs = idxs[idxs >= 0]
            self.df = self.df.take(idxs)

    # ------------------------------------------------------------- stats
    def _compute_stats_cls_counts(self):
        all_counts = {}
        for tname, tclasses in self.classes.items():
            col = tname + "_class"
            if col not in self.df:
                continue
            lbls = np.asarray(self.df[col])
            counts = {
                cls_id: int(np.sum(lbls == cls_id))
                for _, cls_id in [("", -1)] + list(tclasses.items())
            }
            if sum(counts.values()) != len(self.df):
                raise ValueError(f"{col} holds labels outside the {tname} classes")
            all_counts[tname] = counts
        return all_counts

    @property
    def classes(self) -> "OrderedDict[str, dict]":
        return OrderedDict(
            (tname, getattr(self, tname + "_classes")) for tname in self.label_type
        )

    @property
    def classes_manyshot(self) -> "OrderedDict[str, dict]":
        """Subset used for recall metrics; defaults to all classes."""
        return self.classes

    @property
    def class_mappings(self) -> Dict:
        return {}

    @property
    def primary_metric(self) -> str:
        return "final_acc/action/top1"

    def __len__(self):
        return int(len(self.df) * self.repeat_data_times)

    # ------------------------------------------------------------ labels
    def _get_label_from_row(self, row, tname):
        col = tname + "_class"
        return row[col] if col in row else self.dummy_label

    def _get_labels(self, row) -> "OrderedDict[str, int]":
        return OrderedDict(
            (tname, self._get_label_from_row(row, tname)) for tname in self.label_type
        )

    def _get_vidseg_labels(self, row, video_frame_sec: np.ndarray):
        """Per-frame labels by annotation lookup on this video.

        video_frame_sec: (#clips, T). Overlapping annotations resolve by the
        reference's rule (base_video_dataset.py:728-734): nearest to the
        HALF-DURATION value (orig_end-orig_start)/2 — replicated verbatim,
        quirk included, for bit parity with trained models.
        """
        full = self.df_before_subset
        vid_df = full.mask([p == row["video_path"] for p in full["video_path"]])
        if video_frame_sec.ndim != 2:
            raise ValueError(f"video_frame_sec of shape {video_frame_sec.shape}")
        starts = vid_df["orig_start"].astype(np.float64)
        ends = vid_df["orig_end"].astype(np.float64)
        half_dur = (ends - starts) / 2.0
        labels = OrderedDict(
            (t, -np.ones(video_frame_sec.shape, dtype=np.int64))
            for t in self.label_type
        )
        label_cols = {
            t: vid_df[t + "_class"] if t + "_class" in vid_df else None
            for t in self.label_type
        }
        flat_t = video_frame_sec.reshape(-1)
        # (F, R) match matrix; F frames, R annotation rows of this video
        match = (starts[None, :] <= flat_t[:, None]) & (ends[None, :] >= flat_t[:, None])
        any_match = match.any(axis=1)
        dist = np.abs(flat_t[:, None] - half_dur[None, :])
        dist = np.where(match, dist, np.inf)
        best = np.argmin(dist, axis=1)
        for tname in self.label_type:
            col = label_cols[tname]
            if col is None:
                continue
            vals = np.where(any_match, col[best], -1)
            labels[tname] = vals.reshape(video_frame_sec.shape).astype(np.int64)
        return labels

    # ------------------------------------------------------------- video
    def _apply_vid_transform(self, video: np.ndarray) -> np.ndarray:
        """Host transform hook.

        Raw frames (T, H, W, 3 uint8) are returned untransformed when no
        host transform is set: preprocessing (resize/crop/normalize) runs on
        the device inside the train or eval step (data/transforms.py), and
        the subclip fold happens there too. The reference instead runs
        torchvision transforms in loader workers.
        """
        if video.size == 0:
            return video
        if video.ndim != 4:
            raise ValueError(f"a clip must be (T, H, W, C), got {video.shape}")
        if video.shape[1] > 1 and video.shape[2] > 1:
            if self.transform:
                return self.transform(video)
            return video  # raw uint8 THWC for device-side preprocessing
        # Feature "videos" (T, 1, 1, C): only permute to (C, T, 1, 1).
        return np.ascontiguousarray(video.transpose(3, 0, 1, 2))

    def _sample_window(self, video_path, fps, start, end, strategy):
        new_start, new_end, eff_fps = compute_read_window(
            start, end, fps, self.frames_per_clip, self.frame_rate, strategy, self.rng
        )
        return new_start, new_end, eff_fps

    def _read_clip(self, row, start, end, strategy):
        video_path = get_abs_path(self.root, row["video_path"])
        fps = self.reader.get_frame_rate(video_path)
        new_start, new_end, eff_fps = self._sample_window(
            video_path, fps, start, end, strategy
        )
        video, info = self.reader(video_path, new_start, new_end, eff_fps, row)
        n_read = video.shape[0] if video.ndim == 4 else 0
        if video.ndim != 4 or video.size == 0:
            # Corrupt/empty clip (reference :598-605 makes black frames).
            if self.transform is not None:
                # host-transform path: its resize absorbs any stand-in size
                video = np.zeros(
                    (self.frames_per_clip, 100, 100, 3), dtype=np.uint8)
                secs = -np.ones((self.frames_per_clip,), dtype=np.float64)
                return video, secs, info
            if self._frame_shape_dtype is not None:
                # static-shape (device-preproc / feature) path: black/zero
                # frames at the dataset's known frame geometry keep the
                # item (and its labels) in the batch, like the reference
                shape, dtype = self._frame_shape_dtype
                video = np.zeros(
                    (self.frames_per_clip,) + shape, dtype=dtype)
                secs = -np.ones((self.frames_per_clip,), dtype=np.float64)
                return video, secs, info
            # no geometry known yet: drop the item, the loader backfills
            return None, None, info
        if self.transform is None and self._frame_shape_dtype is None:
            self._frame_shape_dtype = (video.shape[1:], video.dtype)
        idx, secs = sample_clip_frames(
            n_read, new_start, new_end, eff_fps, self.frame_rate,
            self.frames_per_clip, strategy,
        )
        return video[idx], secs, info

    def _get_subclips(self, video: np.ndarray, num_frames: int, stride: int):
        """(C, T, *) -> (#clips, C, num_frames, *).

        Same tiling as the device-side fold (transforms.fold_subclips):
        only FULL windows, and (T - num_frames) must tile by the stride —
        a ragged tail window would np.stack into a shape error anyway.
        """
        total = video.shape[1]
        if (total - num_frames) % stride != 0 or total < num_frames:
            raise ValueError(
                f"subclips (num_frames={num_frames}, stride={stride}) must "
                f"tile T={total} exactly"
            )
        return np.stack(
            [
                video[:, i : i + num_frames]
                for i in range(0, total - num_frames + 1, stride)
            ]
        )

    # ----------------------------------------------------------- getitem
    def _repeat_process_idx(self, idx: int) -> int:
        total = len(self.df)
        scaled = idx / self.repeat_data_times
        if self.repeat_data_times < 1:
            scaled += self.rng.integers(int(1 / self.repeat_data_times))
        return int(scaled) % total

    def _class_balance_data_idx(self, idx: int) -> int:
        if not self.class_balanced_sampling:
            return idx
        counts = OrderedDict(self.classes_counts[self.label_type[0]])
        if counts.get(-1, 0) == 0:
            counts.pop(-1, None)
        # vocabulary classes absent from this split contribute no rows;
        # keeping them would make rng.integers(low, low) raise
        counts = OrderedDict(
            (k, v) for k, v in counts.items() if v > 0
        )
        if len(self.df) < 2 or not counts:
            return idx
        cls_counts = [counts[i] for i in sorted(counts.keys())]
        cls_cumsum = np.cumsum(cls_counts).tolist()
        cls_first = [0] + cls_cumsum[:-1]
        share = max(cls_counts)
        new_total = len(cls_counts) * share
        old_total = sum(cls_counts)
        eff = int(round(idx * ((new_total - 1) / (old_total - 1))))
        cls_idx = min(eff // share, len(cls_counts) - 1)
        new_idx = int(self.rng.integers(cls_first[cls_idx], cls_cumsum[cls_idx]))
        return new_idx % len(self.df)

    def __getitem__(self, idx: int):
        idx = self._class_balance_data_idx(idx)
        idx = self._repeat_process_idx(idx)
        row = self.df.row(idx)
        if self.conv_to_anticipate_fn_runtime is not None:
            row = self.conv_to_anticipate_fn_runtime(row, self.df)
            if row is None:
                return None
        if self.process_df_before_read_fn is not None:
            row = self.process_df_before_read_fn(row, self)
        if row is None:
            return None
        video, secs, info = self._read_clip(
            row, row["start"], row["end"], self.sample_strategy
        )
        if video is None:
            return None  # unreadable clip on a static-shape path
        video = self._apply_vid_transform(video)
        out = {"start": row["start"], "end": row["end"]}
        if self.return_future_clips_too:
            if "orig_start" not in row:
                raise ValueError("future clips need anticipation data")
            nfut = len([k for k in row.keys() if k.startswith(FUTURE_PREFIX)]) // 2
            for i in range(nfut):
                fvid, _, _ = self._read_clip(
                    row,
                    row[f"{FUTURE_PREFIX}_{i}_start"],
                    row[f"{FUTURE_PREFIX}_{i}_end"],
                    self.sample_strategy_future,
                )
                fvid = self._apply_vid_transform(fvid)
                # DELIBERATE delta vs the reference: base_video_dataset.py
                # :670-683 stores future clips RAW (C,T,H,W) while the main
                # video gets a leading #clips dim (:793), so its latent SSL
                # path (func/train_eval_ops.py:185-192) would torch.cat
                # tensors of different rank and crash — no shipped expt
                # config exercises it. Folding futures through the same
                # subclip tiling keeps the obs+future concat in
                # train/step.py:make_ssl_train_step shape-consistent.
                if self.subclips_options:
                    fvid = self._get_subclips(fvid, **self.subclips_options)
                out[f"{FUTURE_PREFIX}_{i}_video"] = fvid

        raw_video = video.ndim == 4 and video.shape[-1] == 3 and video.shape[1] > 1
        secs = secs[None]  # (1, T)
        if self.subclips_options:
            if not raw_video:
                video = self._get_subclips(video, **self.subclips_options)
            secs = self._get_subclips(secs, **self.subclips_options)[:, 0]
        elif not raw_video:
            video = video[None]
        out.update(
            {
                "video": video,  # (#clips, C, T', H, W)
                "video_frame_sec": secs,  # (#clips, T')
                "idx": idx,
                "target": self._get_labels(row),
                "uid": row["uid"],
            }
        )
        if self.load_seg_labels:
            out["target_subclips"] = self._get_vidseg_labels(
                row, out["video_frame_sec"]
            )
        if self.load_long_term_future_labels > 0:
            flat = out["video_frame_sec"].reshape(-1)
            gap = flat[-1] - flat[-2]
            future_t = np.asarray(
                [flat[-1] + gap * i for i in range(1, self.load_long_term_future_labels + 1)]
            ).reshape(-1, 1)
            out["future_subclips"] = self._get_vidseg_labels(row, future_t)
        return out
