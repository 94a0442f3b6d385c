"""EPIC-Kitchens-55 / EPIC-Kitchens-100 / EGTEA Gaze+ datasets.

Counterpart of avt_tpu/data/epic_kitchens.py (`EpicKitchens`,
`load_action_classes`, `load_action_classes_egtea`, `gen_all_actions`),
whose parity target is the reference's datasets/epic_kitchens.py:28-391:
original pkl annotations (HH:MM:SS.f timestamps) or RULSTM csv annotations
(30 fps frame numbers); verb/noun class csvs; the action vocabulary from
RULSTM's actions.csv (or the full verb x noun cross product); the
(verb, noun) -> action mapping; person and video subset filters; the
verb/noun-in-action 0/1 matrices; EK55 many-shot classes; class-mean
recall@5 as EK100's primary metric.

The RULSTM csv and the class csvs are read with the `csv` module. A pkl
annotation file holds a pandas DataFrame; unpickling it needs pandas where
the file is read, and the port takes its columns through the object's own
`reset_index()` and `to_dict("list")` without importing pandas itself (a
pickled dict of columns is read as it is).
"""
from __future__ import annotations

import csv
import logging
import pickle as pkl
from collections import OrderedDict
from datetime import date, datetime
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from avt_tpu_torch.data.anticipation import RULSTM_TSN_FPS
from avt_tpu_torch.data.dataset import VideoDataset
from avt_tpu_torch.data.table import Table

EGTEA_VERSION = -1
EPIC55_VERSION = 0.1
EPIC100_VERSION = 0.2

LOG = logging.getLogger(__name__)


def _timestr_to_sec(s: str, fmt: str = "%H:%M:%S.%f") -> float:
    timeobj = datetime.strptime(s, fmt).time()
    td = datetime.combine(date.min, timeobj) - datetime.min
    return td.total_seconds()


def _read_csv_records(fpath) -> List[Dict]:
    """The rows of a csv with a header, as dicts; a column whose every value
    reads as an int holds ints, else one that reads as floats holds floats,
    as pandas' read_csv types its columns."""
    with open(fpath, "r", newline="") as fin:
        rows = list(csv.DictReader(fin))
    for name in (rows[0].keys() if rows else ()):
        for conv in (int, float):
            try:
                values = [conv(r[name]) for r in rows]
            except (TypeError, ValueError):
                continue
            for r, v in zip(rows, values):
                r[name] = v
            break
    return rows


def load_action_classes(fpath) -> Tuple[Dict[str, int], Dict[Tuple[int, int], int]]:
    """RULSTM actions.csv: columns id,verb,noun,action."""
    class_names: Dict[str, int] = {}
    verb_noun_to_action: Dict[Tuple[int, int], int] = {}
    with open(fpath, "r") as fin:
        reader = csv.DictReader(fin, delimiter=",")
        for lno, line in enumerate(reader):
            class_names[line["action"]] = lno
            verb_noun_to_action[(int(line["verb"]), int(line["noun"]))] = int(
                line["id"]
            )
    return class_names, verb_noun_to_action


def load_action_classes_egtea(fpath) -> Tuple[Dict[str, int], Dict[Tuple[int, int], int]]:
    """EGTEA action list: 'id,<verb>_<noun>,action-name' rows, no header."""
    class_names: Dict[str, int] = {}
    verb_noun_to_action: Dict[Tuple[int, int], int] = {}
    with open(fpath, "r") as fin:
        reader = csv.DictReader(
            fin, delimiter=",", fieldnames=["id", "verb_noun", "action"]
        )
        for lno, line in enumerate(reader):
            class_names[line["action"]] = lno
            verb, noun = [int(el) for el in line["verb_noun"].split("_")]
            verb_noun_to_action[(verb, noun)] = int(line["id"])
    return class_names, verb_noun_to_action


def gen_all_actions(
    verb_classes: Sequence[str], noun_classes: Sequence[str]
) -> Tuple[Dict[str, int], Dict[Tuple[int, int], int]]:
    """Full verb x noun cross-product action vocabulary."""
    class_names: Dict[str, int] = {}
    verb_noun_to_action: Dict[Tuple[int, int], int] = {}
    action_id = 0
    for verb_id, verb_cls in enumerate(verb_classes):
        for noun_id, noun_cls in enumerate(noun_classes):
            class_names[f"{verb_cls}:{noun_cls}"] = action_id
            verb_noun_to_action[(verb_id, noun_id)] = action_id
            action_id += 1
    return class_names, verb_noun_to_action


class EpicKitchens(VideoDataset):
    """EK55 (version=0.1), EK100 (0.2) and EGTEA (-1) in one loader."""

    def __init__(
        self,
        annotation_path: Sequence[Union[str, Path]],
        only_keep_persons: str = None,
        only_keep_videos=None,
        action_labels_fpath=None,
        annotation_dir=None,
        rulstm_annotation_dir=None,
        version: float = EPIC55_VERSION,
        **other_kwargs,
    ):
        self.version = version
        if isinstance(annotation_path, (str, Path)):
            annotation_path = [annotation_path]
        df = Table.concat([self._load_df(str(el)) for el in annotation_path])
        df = self._subselect_df_by_videos(
            self._subselect_df_by_person(df, only_keep_persons), only_keep_videos
        )
        self.annotation_dir = (
            Path(annotation_dir)
            if annotation_dir is not None
            else Path(annotation_path[0]).parent
        )
        self.rulstm_annotation_dir = rulstm_annotation_dir
        epic_postfix = "_100" if self.version == EPIC100_VERSION else ""
        if self.version != EGTEA_VERSION:
            verb_classes = self._load_class_names(
                self.annotation_dir / f"EPIC{epic_postfix}_verb_classes.csv"
            )
            noun_classes = self._load_class_names(
                self.annotation_dir / f"EPIC{epic_postfix}_noun_classes.csv"
            )
        else:
            verb_classes, noun_classes = {}, {}
        if action_labels_fpath is not None:
            load_fn = (
                load_action_classes_egtea
                if self.version == EGTEA_VERSION
                else load_action_classes
            )
            action_classes, verb_noun_to_action = load_fn(action_labels_fpath)
        else:
            action_classes, verb_noun_to_action = gen_all_actions(
                list(verb_classes), list(noun_classes)
            )
        if "action_class" not in df and {"noun_class", "verb_class"}.issubset(df.columns):
            vn = list(zip(df["verb_class"], df["noun_class"]))
            df["action_class"] = [verb_noun_to_action.get(key, -1) for key in vn]
        elif "action_class" not in df:
            df["action_class"] = -1
            df["verb_class"] = -1
            df["noun_class"] = -1
        num_undef = int((df["action_class"] == -1).sum())
        if num_undef > 0:
            LOG.error(
                "No valid action label for %d/%d samples", num_undef, len(df)
            )
        other_kwargs["verb_classes"] = verb_classes
        other_kwargs["noun_classes"] = noun_classes
        other_kwargs["action_classes"] = action_classes
        super().__init__(df, **other_kwargs)
        self.verb_noun_to_action = verb_noun_to_action

    # --------------------------------------------------------- properties
    @property
    def primary_metric(self) -> str:
        if self.version == EPIC100_VERSION:
            return "final_acc/action/AR5"
        return super().primary_metric

    @property
    def class_mappings(self) -> Dict[Tuple[str, str], np.ndarray]:
        """0/1 matrices mapping action logits to verb/noun scores.

        verb_in_action[a, v] = 1 iff action a's verb is v; used by the model
        to marginalize verb/noun predictions out of action logits.
        """
        num_verbs = len(self.verb_classes) or len(
            {v for (v, _) in self.verb_noun_to_action}
        )
        num_nouns = len(self.noun_classes) or len(
            {n for (_, n) in self.verb_noun_to_action}
        )
        num_actions = len(self.action_classes) or len(
            set(self.verb_noun_to_action.values())
        )
        verb_in_action = np.zeros((num_actions, num_verbs), dtype=np.float32)
        noun_in_action = np.zeros((num_actions, num_nouns), dtype=np.float32)
        for (verb, noun), action in self.verb_noun_to_action.items():
            verb_in_action[action, verb] = 1.0
            noun_in_action[action, noun] = 1.0
        return {
            ("verb", "action"): verb_in_action,
            ("noun", "action"): noun_in_action,
        }

    @property
    def classes_manyshot(self) -> OrderedDict:
        """EK55 many-shot classes (RULSTM recall convention); else all."""
        if self.version != EPIC55_VERSION:
            return super().classes_manyshot
        many_shot_verbs = {
            el["verb"]: el["verb_class"]
            for el in _read_csv_records(self.annotation_dir / "EPIC_many_shot_verbs.csv")
        }
        many_shot_nouns = {
            el["noun"]: el["noun_class"]
            for el in _read_csv_records(self.annotation_dir / "EPIC_many_shot_nouns.csv")
        }
        # An action is many-shot if its verb OR its noun is many-shot.
        many_shot_actions = {}
        action_names = {val: key for key, val in self.action_classes.items()}
        for (verb_id, noun_id), action_id in self.verb_noun_to_action.items():
            if verb_id in many_shot_verbs.values() or noun_id in many_shot_nouns.values():
                many_shot_actions[action_names[action_id]] = action_id
        return OrderedDict(
            verb=many_shot_verbs, noun=many_shot_nouns, action=many_shot_actions
        )

    # ------------------------------------------------------------ loading
    def _load_class_names(self, annot_path) -> Dict[str, int]:
        res = {}
        key_col = "class_key" if self.version == EPIC55_VERSION else "key"
        with open(annot_path, "r") as fin:
            for lno, line in enumerate(csv.DictReader(fin, delimiter=",")):
                res[line[key_col]] = lno
        return res

    def _load_df(self, annotation_path: str) -> Table:
        if annotation_path.endswith(".pkl"):
            return self._init_df_orig(annotation_path)
        if annotation_path.endswith(".csv"):
            return self._init_df_rulstm(annotation_path)
        raise NotImplementedError(annotation_path)

    def _init_df_gen_vidpath(self, df: Table) -> Table:
        if self.version == EGTEA_VERSION:
            df["video_path"] = [Path(v + ".mp4") for v in df["video_id"]]
        else:
            df["video_path"] = [
                Path(p) / (v + ".MP4")
                for p, v in zip(df["participant_id"], df["video_id"])
            ]
        return df

    def _init_df_rulstm(self, annotation_path: str) -> Table:
        """RULSTM csv: uid,video_id,start_frame,end_frame,verb,noun,action
        with frame numbers at the fixed 30 fps feature rate, no header."""
        names = ["uid", "video_id", "start_frame_30fps", "end_frame_30fps", "verb_class",
                 "noun_class", "action_class"]
        with open(annotation_path, "r", newline="") as fin:
            rows = [r for r in csv.reader(fin, skipinitialspace=True) if r]
        for r in rows:
            if len(r) != len(names):
                raise ValueError(f"{annotation_path}: a row of {len(r)} fields, want "
                                 f"{len(names)}: {r}")
        cols = {name: [r[k] for r in rows] for k, name in enumerate(names)}
        df = Table({name: cols[name] if name in ("uid", "video_id")
                    else np.asarray([int(v) for v in cols[name]], dtype=np.int64)
                    for name in names})
        df["start"] = df["start_frame_30fps"] / RULSTM_TSN_FPS
        df["end"] = df["end_frame_30fps"] / RULSTM_TSN_FPS
        df["participant_id"] = [v.split("_")[0] for v in df["video_id"]]
        return self._init_df_gen_vidpath(df)

    def _init_df_orig(self, annotation_path: str) -> Table:
        """Original EPIC pkl annotations with HH:MM:SS.f timestamps."""
        with open(annotation_path, "rb") as fin:
            obj = pkl.load(fin)
        if hasattr(obj, "reset_index") and hasattr(obj, "to_dict"):
            # a DataFrame: its index (the uid) becomes the first column
            obj = obj.reset_index(drop=False).to_dict("list")
        if not isinstance(obj, dict):
            raise TypeError(f"{annotation_path} holds a {type(obj).__name__}, not a table")
        df = Table(obj)
        df["start"] = [_timestr_to_sec(s) for s in df["start_timestamp"]]
        df["end"] = [_timestr_to_sec(s) for s in df["stop_timestamp"]]
        # normalize the reversed "noun:of phrase" and dashed-verb formats.
        # NOTE the token reversal is the reference's verbatim idiom
        # (epic_kitchens.py:363-365): "liquid:washing up" -> "up washing
        # liquid", NOT "washing up liquid"; kept for bit-parity of any
        # name-keyed artifact
        if "noun" in df:
            df["noun"] = [" ".join(s.replace(":", " ").split(" ")[::-1]) for s in df["noun"]]
        if "verb" in df:
            df["verb"] = [" ".join(s.replace("-", " ").split(" ")) for s in df["verb"]]
        return self._init_df_gen_vidpath(df)

    @staticmethod
    def _subselect_df_by_person(df, only_keep_persons):
        """Keep P<start>..P<end> (EK55 train-minus-val convention)."""
        if only_keep_persons is None:
            return df
        start, end = [int(el) for el in only_keep_persons.split("-")]
        keep = ["P{:02d}".format(el) for el in range(start, end + 1)]
        return df.mask(df.isin("participant_id", keep))

    @staticmethod
    def _subselect_df_by_videos(df, videos_fpath):
        if videos_fpath is None:
            return df
        with open(videos_fpath, "r") as fin:
            keep = [el.strip() for el in fin.read().splitlines()]
        return df.mask(df.isin("video_id", keep))
