"""Feature readers.

Counterpart of avt_tpu/data/readers.py (`Reader`, `FeatsReaderBase`,
`LMDBFeatsReader`, `NpyFeatsReader`, `VideoAsLabelOnehotReader`), whose
parity targets are the reference's datasets/reader_fns.py and
datasets/epic_kitchens.py:394-526 (EpicRULSTMFeatsReader): the frame-index
math for 'exact_rulstm' (11 frames at 0.25 s back from the window end) and
'normal' (every frame in [start, end]); a backward search of up to 10
frames for a missing feature; zero fill when none is found; channel concat
across stores; output (T, 1, 1, C), so features flow through the video
pipeline unchanged.

Stores are LMDB (the `lmdb` module is imported by `LMDBFeatsReader` alone,
when it is built) or memory-mapped per-video .npy shards (`NpyFeatsReader`,
no C dependency). Raw video is read by `OpenCVVideoReader` (OpenCV is
imported by its constructor alone) or by the native libav decoder
(`video_decoder.LibavVideoReader`).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from avt_tpu_torch.data.anticipation import RULSTM_TSN_FPS

LOG = logging.getLogger(__name__)


class Reader:
    """Reader protocol: fetch frames/features for a second range.

    __call__(video_path, start_sec, end_sec, fps, row) ->
        (frames: (T, H, W, 3) uint8 | feats: (T, 1, 1, C) float32,
         info: dict)
    """

    def __call__(self, video_path, start_sec, end_sec, fps, row) -> Tuple[np.ndarray, Dict]:
        raise NotImplementedError

    def get_frame_rate(self, video_path) -> float:
        raise NotImplementedError


class FeatsReaderBase(Reader):
    """Pre-extracted per-frame feature reader (store-agnostic index math)."""

    def __init__(
        self,
        read_type: str = "exact_rulstm",
        search_radius: int = 10,
        warn_if_using_closeby_frame: bool = True,
    ):
        """warn_if_using_closeby_frame: log when the backward search settles
        on a nearby frame instead of the requested one — configs for sparse
        stores (e.g. expts/04's 10fps ig65m features) turn it off
        (reference epic_kitchens.py:398,419,453)."""
        if read_type not in ("exact_rulstm", "normal"):
            raise NotImplementedError(f"Unknown read_type {read_type!r}")
        self.read_type = read_type
        self.search_radius = search_radius
        self.warn_if_using_closeby_frame = warn_if_using_closeby_frame

    # -- store interface -------------------------------------------------
    def fetch(self, video_stem: str, frame_id: int) -> Optional[np.ndarray]:
        """Return the (C,) feature of 1-based frame `frame_id`, or None.

        Single-store readers implement this; multi-store readers pass an
        explicit callable to read_window instead.
        """
        raise NotImplementedError

    # --------------------------------------------------------------------
    def frame_ids_for_window(self, start_sec: float, end_sec: float, fps: float) -> np.ndarray:
        """1-based frame ids covering [start_sec, end_sec]."""
        if self.read_type == "exact_rulstm":
            # 11 timestamps at 0.25 s spacing, ending at end_sec.
            time_stamps = end_sec - np.arange(0.0, 0.25 * 11, 0.25)[::-1]
            frames = np.floor(time_stamps * fps).astype(int)
        else:  # normal
            start_frame = np.floor(start_sec * fps)
            end_frame = np.floor(end_sec * fps)
            frames = np.arange(end_frame, start_frame, -1).astype(int)[::-1]
        if frames.size == 0 or frames.max() < 1:
            raise ValueError(
                f"No readable frames in window [{start_sec}, {end_sec}] @ {fps}"
            )
        frames[frames < 1] = frames[frames >= 1].min()
        return frames

    def read_window(self, video_stem: str, frames: np.ndarray, fetch=None) -> np.ndarray:
        fetch = fetch or self.fetch
        feats: List[Optional[np.ndarray]] = []
        for frame_id in frames:
            dd = None
            for radius in range(self.search_radius):
                # Search backward only: looking forward would leak the future
                # into an anticipation model.
                dd = fetch(video_stem, int(frame_id) - radius)
                if dd is not None:
                    if radius > 0 and self.warn_if_using_closeby_frame:
                        LOG.warning(
                            "Using frame %d instead of %d for %s",
                            int(frame_id) - radius, int(frame_id), video_stem,
                        )
                    break
            feats.append(dd)
        not_none = [el for el in feats if el is not None]
        if not not_none:
            raise ValueError(f"No features found for {video_stem} at {frames}")
        proto = not_none[0]
        feats = [np.zeros_like(proto) if el is None else el for el in feats]
        return np.stack(feats).astype(np.float32)

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        frames = self.frame_ids_for_window(start_sec, end_sec, fps)
        feats = self.read_window(Path(video_path).stem, frames)
        # (T, C) -> (T, 1, 1, C): features masquerade as 1x1 videos.
        return feats[:, None, None, :], {}

    def get_frame_rate(self, video_path) -> float:
        del video_path
        return RULSTM_TSN_FPS


class LMDBFeatsReader(FeatsReaderBase):
    """RULSTM-format LMDB store: key '<stem>_frame_%010d.jpg' -> f32 bytes.

    Multiple paths concat features on the channel dim (TSN rgb+obj+flow).
    """

    def __init__(
        self,
        lmdb_path: Union[str, Sequence[str]],
        read_type: str = "exact_rulstm",
        **kwargs,
    ):
        super().__init__(read_type=read_type, **kwargs)
        import lmdb  # optional: only this reader needs it

        if isinstance(lmdb_path, (str, Path)):
            lmdb_path = [lmdb_path]
        self.envs = [
            lmdb.open(str(p), readonly=True, lock=False) for p in lmdb_path
        ]

    def _fetch_env(self, env, video_stem: str, frame_id: int) -> Optional[np.ndarray]:
        key = f"{video_stem}_frame_{frame_id:010d}.jpg".encode("utf-8")
        with env.begin() as txn:
            dd = txn.get(key)
        if dd is None:
            return None
        return np.frombuffer(dd, dtype=np.float32)

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        frames = self.frame_ids_for_window(start_sec, end_sec, fps)
        stem = Path(video_path).stem
        all_feats = [
            self.read_window(
                stem, frames,
                fetch=lambda s, f, _env=env: self._fetch_env(_env, s, f),
            )
            for env in self.envs
        ]
        feats = np.concatenate(all_feats, axis=-1)
        return feats[:, None, None, :], {}


class NpyFeatsReader(FeatsReaderBase):
    """Per-video .npy feature shards, memory-mapped.

    Store layout: <root>/<video_stem>.npy of shape (num_frames, C); row i
    holds the feature of 1-based frame i+1. Missing trailing frames are
    simply out of range (-> backward search -> zero-fill), matching the
    LMDB reader's sparse-store behavior. Multiple roots concat on channels.
    """

    def __init__(
        self,
        root: Union[str, Sequence[str]],
        read_type: str = "exact_rulstm",
        **kwargs,
    ):
        super().__init__(read_type=read_type, **kwargs)
        if isinstance(root, (str, Path)):
            root = [root]
        self.roots = [Path(r) for r in root]
        self._cache: Dict[Tuple[int, str], Optional[np.ndarray]] = {}

    def _get_arr(self, root_idx: int, video_stem: str) -> Optional[np.ndarray]:
        key = (root_idx, video_stem)
        if key not in self._cache:
            fpath = self.roots[root_idx] / f"{video_stem}.npy"
            self._cache[key] = (
                np.load(fpath, mmap_mode="r") if fpath.exists() else None
            )
        return self._cache[key]

    def _fetch_root(self, root_idx: int, video_stem: str, frame_id: int):
        arr = self._get_arr(root_idx, video_stem)
        if arr is None or not (1 <= frame_id <= arr.shape[0]):
            return None
        row = np.asarray(arr[frame_id - 1])
        if np.isnan(row).all():  # NaN rows mark missing frames in the shard
            return None
        return row

    def _read_root(self, root_idx: int, video_stem: str, frames: np.ndarray) -> np.ndarray:
        """`read_window` over one root, its backward search done for every
        frame at once on one read of the window's rows (a window of 'normal'
        reads at 30 fps holds thousands of frames, and a store packed at a
        stride has most of them missing): the nearest present row at most
        search_radius - 1 frames back, zeros where there is none. The same
        array as `read_window`, and the same warnings and error."""
        arr = self._get_arr(root_idx, video_stem)
        lo = max(1, int(frames.min()) - self.search_radius + 1)
        hi = min(arr.shape[0], int(frames.max())) if arr is not None else 0
        if hi < lo:  # no row of the shard in reach
            raise ValueError(f"No features found for {video_stem} at {frames}")
        block = np.asarray(arr[lo - 1:hi])
        present = ~np.isnan(block).all(axis=-1)  # NaN rows mark missing frames
        last = np.maximum.accumulate(np.where(present, np.arange(lo, hi + 1), 0))
        top = np.minimum(frames, hi)  # the last present id at or before each frame
        cand = np.where(top >= lo, last[np.clip(top - lo, 0, None)], 0)
        found = np.where(cand >= frames - self.search_radius + 1, cand, 0)  # 0: none
        hit = found > 0
        if not hit.any():
            raise ValueError(f"No features found for {video_stem} at {frames}")
        if self.warn_if_using_closeby_frame:
            for want, got in zip(frames[hit], found[hit]):
                if got != want:
                    LOG.warning("Using frame %d instead of %d for %s", int(got), int(want),
                                video_stem)
        if hit.all():
            return block[found - lo].astype(np.float32)
        out = np.zeros((len(frames),) + block.shape[1:], dtype=np.float32)
        out[hit] = block[found[hit] - lo]
        return out

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        frames = self.frame_ids_for_window(start_sec, end_sec, fps)
        stem = Path(video_path).stem
        all_feats = [self._read_root(i, stem, frames) for i in range(len(self.roots))]
        feats = np.concatenate(all_feats, axis=-1)
        return feats[:, None, None, :], {}


class VideoAsLabelOnehotReader(Reader):
    """Oracle reader: the 'video' is the one-hot of observed action labels.

    Parity: reference datasets/reader_fns.py:34-67.
    """

    def __init__(self, num_classes: int = 1000):
        self.num_classes = num_classes

    def get_frame_rate(self, video_path) -> float:
        # the reference raises too (reader_fns.py:36-37, "Not sure what it
        # is here... TODO") and its dataset calls get_frame_rate
        # unconditionally — the oracle path is exercised only with configs
        # that sidestep fps resampling; replicated as-is
        raise NotImplementedError("Undefined for one-hot oracle reader")

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        if abs(end_sec - row["end"]) >= 0.1:
            raise AssertionError("Only last_clip supported for oracle reader")
        labels = np.asarray(row["obs_action_class"])[:, 1].astype(np.int64)
        feats = np.zeros((len(labels), self.num_classes), dtype=np.float32)
        valid = labels >= 0
        feats[np.arange(len(labels))[valid], labels[valid]] = 1.0
        return feats[:, None, None, :], {}


class OpenCVVideoReader(Reader):
    """Raw-video decode through OpenCV (the fallback; the native libav
    decoder of video_decoder.py is the main reader).

    Returns (T, H, W, 3) RGB uint8 frames whose times i / fps fall in
    [start_sec, end_sec] (inclusive), like torchvision's read_video.
    """

    def __init__(self):
        import cv2  # only this reader needs it

        self._cv2 = cv2

    def get_frame_rate(self, video_path) -> float:
        cap = self._cv2.VideoCapture(str(video_path))
        try:
            return float(cap.get(self._cv2.CAP_PROP_FPS))
        finally:
            cap.release()

    def duration(self, video_path) -> float:
        """Seconds of video: the frame count over the frame rate."""
        cap = self._cv2.VideoCapture(str(video_path))
        try:
            fps = float(cap.get(self._cv2.CAP_PROP_FPS))
            return float(cap.get(self._cv2.CAP_PROP_FRAME_COUNT)) / fps if fps > 0 else 0.0
        finally:
            cap.release()

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        cv2 = self._cv2
        cap = cv2.VideoCapture(str(video_path))
        frames = []
        try:
            vid_fps = cap.get(cv2.CAP_PROP_FPS)
            if vid_fps <= 0:
                return np.zeros((0, 1, 1, 3), dtype=np.uint8), {}
            start_frame = int(np.ceil(start_sec * vid_fps - 1e-6))
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
            idx = start_frame
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if idx / vid_fps > end_sec + 1e-6:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                idx += 1
        finally:
            cap.release()
        if not frames:
            return np.zeros((0, 1, 1, 3), dtype=np.uint8), {"video_fps": vid_fps}
        return np.stack(frames), {"video_fps": vid_fps}
