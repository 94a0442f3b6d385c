"""The port's host data layer against avt_tpu's.

The port keeps its annotations in its own `Table`, not in pandas. Compared
with avt_tpu on the same inputs: the table's operations with pandas' (row
order after the non-stable `sort_values` included); `convert_to_anticipation`
for every drop style, future ratio and the recognition mode `tau_a=-999`;
`dense_clip_sampler`; `EpicKitchens` item by item over the whole dataset
(row order after `sort_values`, `uid_subset` and repeat; features exactly;
targets, per-frame past targets and uids; classes, class mappings, class
counts and the primary metric) on an EK100 tree of original pkl
annotations, on an EK100 RULSTM csv tree and on an EGTEA tree (version -1:
its headerless actions.csv and `.mp4` video paths), each through
`LMDBFeatsReader` (on
tests/_fake_lmdb.py) and `NpyFeatsReader`, with frames missing from the
stores; the EK55 many-shot classes; and the `DataLoader`'s batches, in
order, for one seed.
"""
import functools
import math
import pickle
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import avt_tpu.data.readers as jreaders
from avt_tpu.data import anticipation as janticipation
from avt_tpu.data import clip_samplers as jclip_samplers
from avt_tpu.data.epic_kitchens import EpicKitchens as JEpicKitchens
from avt_tpu.data.loader import DataLoader as JDataLoader
from avt_tpu_torch.data import anticipation, clip_samplers
from avt_tpu_torch.data import readers as treaders
from avt_tpu_torch.data.epic_kitchens import EpicKitchens
from avt_tpu_torch.data.loader import DataLoader
from avt_tpu_torch.data.table import Table

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the synthetic RULSTM tree of its train_net phase)

import _expt_fixtures  # noqa: E402
import ref_harness  # noqa: E402

DIM = 16  # feature width of the test stores
FPS = 30


# ------------------------------------------------------------------ table
def _same(a, b):
    """Equal columns: the same values (NaN equal to NaN) of the same kind."""
    a, b = list(a), list(b)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float) and math.isnan(x) and math.isnan(y):
            continue
        if x != y:
            return False
    return True


def _assert_table_equals_frame(table, df):
    assert table.columns == list(df.columns)
    assert len(table) == len(df)
    for col in df.columns:
        assert _same(table[col].tolist(), df[col].tolist()), col


def _frame_and_table(seed, n=200):
    rng = np.random.default_rng(seed)
    cols = {"uid": [f"u{i}" for i in range(n)], "label": rng.integers(-1, 5, size=n),
            "start": rng.uniform(0, 50, size=n), "payload": np.arange(n)}
    cols["end"] = cols["start"] + rng.uniform(0.5, 3, size=n)
    return pd.DataFrame(cols), Table(cols)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_sort_values_keeps_pandas_row_order(seed):
    # 200 rows over 6 labels: many ties, which the non-stable quicksort
    # orders its own way
    df, table = _frame_and_table(seed)
    ref = df.sort_values(by="label").reset_index(drop=True)
    ours = table.sort_values("label")
    _assert_table_equals_frame(ours, ref)
    stable = np.argsort(df["label"].to_numpy(), kind="stable")
    assert not np.array_equal(ours["payload"], stable), "the keys must test a non-stable order"


def test_table_operations_match_pandas():
    df, table = _frame_and_table(3, n=40)
    keep = df["start"].to_numpy() > 20
    _assert_table_equals_frame(table.mask(keep), df[keep].reset_index(drop=True))
    idx = [5, 3, 3, 39, 0]
    _assert_table_equals_frame(table.take(idx), df.iloc[idx].reset_index(drop=True))
    assert np.array_equal(table.isin("label", [1, 3]), df["label"].isin([1, 3]).to_numpy())
    wanted = ["u7", "nope", "u0", "u39"]
    assert np.array_equal(table.get_indexer("uid", wanted),
                          pd.Index(df["uid"]).get_indexer(wanted))
    other = Table({"uid": ["x", "y"], "start": [1.0, 2.0], "extra": ["a", "b"]})
    ref = pd.concat([df, pd.DataFrame(other.to_dict())]).reset_index(drop=True)
    _assert_table_equals_frame(Table.concat([table, other]), ref)
    assert table.row(4) == df.loc[4, :].to_dict()
    with pytest.raises(ValueError, match="unique"):
        Table({"u": [1, 1]}).get_indexer("u", [1])


# ----------------------------------------------------------- anticipation
def _annotations(n=24, seed=0):
    rng = np.random.default_rng(seed)
    start = np.round(rng.uniform(0, 40, size=n), 3)
    return {"uid": np.arange(100, 100 + n), "video_id": [f"P01_{i % 3:02d}" for i in range(n)],
            "start": start, "end": start + np.round(rng.uniform(0.5, 4, size=n), 3),
            "verb_class": rng.integers(0, 3, size=n)}


@pytest.mark.parametrize("drop_style", ["correct", "full_context_in", "action_banks"])
@pytest.mark.parametrize("tau_a,tau_o,ratios", [(1.0, 2.5, (1.0,)), (-999, 1.0, (1.0,)),
                                                (0.5, 10.0, (-999, 0.5, 2.0))])
def test_convert_to_anticipation_matches_avt_tpu(drop_style, tau_a, tau_o, ratios):
    cols = _annotations()
    kept, dropped = anticipation.convert_to_anticipation(
        Table(cols), tau_a, tau_o, future_clip_ratios=ratios, drop_style=drop_style)
    jkept, jdropped = janticipation.convert_to_anticipation(
        pd.DataFrame(cols), tau_a, tau_o, future_clip_ratios=ratios, drop_style=drop_style)
    _assert_table_equals_frame(kept, jkept)
    _assert_table_equals_frame(dropped, jdropped.reset_index(drop=True))
    assert len(kept) + len(dropped) == len(cols["uid"])


def test_convert_to_anticipation_refuses_what_avt_tpu_refuses():
    with pytest.raises(NotImplementedError):
        anticipation.convert_to_anticipation(Table(_annotations()), 1, 1, drop_style="rulstm")
    with pytest.raises(ValueError):
        anticipation.convert_to_anticipation(Table(_annotations()), 1, 1,
                                             future_clip_ratios=(12,))


@pytest.mark.parametrize("shard,keep", [((0, 1), True), ((1, 2), True), ((0, 2), False)])
def test_dense_clip_sampler_matches_avt_tpu(shard, keep):
    cols = _annotations(9)
    cols["video_path"] = [f"P01/{v}.MP4" for v in cols["video_id"]]
    lens = {p: 4.0 + i for i, p in enumerate(sorted(set(cols["video_path"])))}
    kw = dict(video_len_fn=lens.__getitem__, stride=1.5, shard=shard, keep_orig_clips=keep,
              skip_uids={"P01_01_3.0"})
    ours, _ = anticipation.dense_clip_sampler(Table(cols), **kw)
    ref, _ = janticipation.dense_clip_sampler(pd.DataFrame(cols), **kw)
    _assert_table_equals_frame(ours, ref)


def test_dense_labels_to_segments_matches_avt_tpu():
    labels = [(1.0, 3.0, 5), (2.5, 6.0, 7), (8.0, 9.0, 1)]
    for args in ((0.5, 8.5), (0.5, 8.5, 4, 1.0), (2.0, 10.0, 12, None, [-1, -1])):
        assert (anticipation.dense_labels_to_segments(labels, *args)
                == janticipation.dense_labels_to_segments(labels, *args))


# ------------------------------------------------------------- datasets
def _write_stores(root: Path, features: dict, missing: dict):
    """The same features as per-video .npy shards (missing frames as NaN
    rows) and as a fake-lmdb store (missing frames absent): the 'rgb' dirs
    of both."""
    lmdb = ref_harness._load_fake_lmdb()
    npy_dir, lmdb_dir = root / "npy" / "rgb", root / "lmdb" / "rgb"
    npy_dir.mkdir(parents=True)
    env = lmdb.open(str(lmdb_dir), readonly=False)
    with env.begin(write=True) as txn:
        for stem, arr in features.items():
            arr = arr.copy()
            gone = missing.get(stem, ())
            for frame in range(1, len(arr) + 1):
                if frame not in gone:
                    txn.put(f"{stem}_frame_{frame:010d}.jpg".encode(), arr[frame - 1].tobytes())
            for frame in gone:
                arr[frame - 1] = np.nan
            np.save(npy_dir / f"{stem}.npy", arr)
    return npy_dir, lmdb_dir


def _pkl_tree(root: Path):
    """EK100 original-format annotations (pkl DataFrames: HH:MM:SS.f times,
    verb and noun names), the class csvs and RULSTM's actions.csv, from
    tests/_expt_fixtures.py; 3 videos of 9 actions, some overlapping."""
    annot = root / "epic-kitchens-100"
    annot.mkdir(parents=True)
    rows, uid = [], 100
    for v, video in enumerate(["P01_01", "P02_03", "P03_02"]):
        for k in range(9):
            start = 12.0 + 1.7 * k + 0.3 * v
            rows.append(dict(uid=uid, participant_id=video.split("_")[0], video_id=video,
                             start=start, end=start + 2.5 + (k % 3), verb_class=(v + k) % 3,
                             noun_class=k % 2))
            uid += 1
    _expt_fixtures._ek_pkl(annot / "EPIC_100_train.pkl", rows)
    _expt_fixtures._class_csvs(annot, "EPIC_100")
    _expt_fixtures._actions_csv(annot / "actions.csv")
    return dict(annotation_path=[annot / "EPIC_100_train.pkl"], annotation_dir=annot,
                action_labels_fpath=annot / "actions.csv", version=0.2)


def _csv_tree(root: Path):
    """A RULSTM csv tree (chip_smoke's writer: 97 verbs, 300 nouns, 3806
    actions), 3 train videos of 8 actions."""
    chip_smoke.write_ek100_tree(str(root), train_videos=3, eval_videos=1, actions_per_video=8,
                                first_action_s=12, dim=DIM, seed=5)
    rulstm = root / "annotations" / "rulstm" / "ek100"
    return dict(annotation_path=[rulstm / "training.csv"],
                annotation_dir=root / "annotations" / "epic-kitchens-100",
                action_labels_fpath=rulstm / "actions.csv", version=0.2)


EGTEA_VIDEOS = ("OP01-R01-00", "OP01-R02-01", "OP02-R03-02")


def _egtea_tree(root: Path):
    """EGTEA Gaze+ (version -1, as conf/dataset/egtea sets it): a RULSTM csv
    split, the headerless `id,<verb>_<noun>,name` actions.csv of
    tests/_expt_fixtures.py and no verb or noun class files; 3 videos of 8
    actions, some without an action id of their own."""
    rulstm = root / "egtea"
    rulstm.mkdir(parents=True)
    rows, uid = [], 100
    for v, video in enumerate(EGTEA_VIDEOS):
        for k in range(8):
            start = 12.0 + 2.1 * k + 0.4 * v
            rows.append(dict(uid=uid, video_id=video, start=start, end=start + 1.5 + (k % 2),
                             verb_class=(v + k) % 3, noun_class=k % 2))
            uid += 1
    _expt_fixtures._rulstm_csv(rulstm / "training1.csv", rows)
    (rulstm / "actions.csv").write_text(
        "0,0_0,take_plate\n1,0_1,take_knife\n2,1_0,put_plate\n3,2_1,wash_knife")
    return dict(annotation_path=[rulstm / "training1.csv"], annotation_dir=rulstm,
                action_labels_fpath=rulstm / "actions.csv", version=-1)


PRIMARY_METRIC = {"pkl": "final_acc/action/AR5", "csv": "final_acc/action/AR5",
                  "egtea": "final_acc/action/top1"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("ek_trees")
    rng = np.random.default_rng(9)
    out = {}
    for name, make in (("pkl", _pkl_tree), ("csv", _csv_tree), ("egtea", _egtea_tree)):
        kwargs = make(root / name)
        if name == "csv":
            feats = {p.stem: np.load(p) for p in (root / name / "features" / "rgb").glob("*.npy")}
        else:
            stems = EGTEA_VIDEOS if name == "egtea" else ("P01_01", "P02_03", "P03_02")
            feats = {s: rng.standard_normal((40 * FPS, DIM)).astype(np.float32) for s in stems}
        # a frame near every window's end, and a run longer than the search
        missing = {s: set(range(300, 300 + 12)) | {331, 392, 393} for s in feats}
        npy_dir, lmdb_dir = _write_stores(root / name / "stores", feats, missing)
        out[name] = (kwargs, npy_dir, lmdb_dir)
    return out


@pytest.fixture
def fake_lmdb(monkeypatch):
    fake = ref_harness._load_fake_lmdb()
    monkeypatch.setitem(sys.modules, "lmdb", fake)
    monkeypatch.setattr(jreaders, "lmdb", fake, raising=False)
    monkeypatch.setattr(jreaders, "HAVE_LMDB", True, raising=False)


OPTIONS = {
    "last_clip": dict(sample_strategy="last_clip"),
    "random_subset_repeat": dict(sample_strategy="random_clip", repeat_data_times=2.5,
                                 uid_subset="every_other"),
    "balanced": dict(sample_strategy="center_clip", class_balanced_sampling=True),
}


def _datasets(tree, reader_kind, option, tau_o=4.0):
    kwargs, npy_dir, lmdb_dir = tree
    opts = dict(OPTIONS[option])
    balanced = opts.get("class_balanced_sampling", False)
    label_type = "verb" if balanced else ["verb", "noun", "action"]
    if kwargs["version"] == -1:  # EGTEA has no verb or noun class lists
        label_type = "action"
    out = []
    for side in (JEpicKitchens, EpicKitchens):
        mod = jreaders if side is JEpicKitchens else treaders
        conv_mod = janticipation if side is JEpicKitchens else anticipation
        reader = (mod.NpyFeatsReader(str(npy_dir), read_type="normal") if reader_kind == "npy"
                  else mod.LMDBFeatsReader(str(lmdb_dir), read_type="normal"))
        kw = dict(kwargs, label_type=label_type, root=[str(npy_dir.parent)],
                  frames_per_clip=6, frame_rate=1, subclips_options={"num_frames": 1, "stride": 1},
                  load_seg_labels=True, reader=reader,
                  conv_to_anticipate_fn=functools.partial(conv_mod.convert_to_anticipation,
                                                          tau_a=1.0, tau_o=tau_o),
                  **{k: v for k, v in opts.items() if k != "uid_subset"})
        if "uid_subset" in opts:
            probe = side(**{**kw, "repeat_data_times": 1.0})
            uids = list(probe.df["uid"])[::2] + ["missing-uid"]
            kw["uid_subset"] = [u.item() if hasattr(u, "item") else u for u in uids]
        out.append(side(**kw))
    return out


def _assert_items_equal(x, y, where):
    assert x.keys() == y.keys(), where
    for k in x:
        if isinstance(x[k], dict):
            assert x[k].keys() == y[k].keys(), (where, k)
            for kk in x[k]:
                assert np.array_equal(np.asarray(x[k][kk]), np.asarray(y[k][kk])), (where, k, kk)
        else:
            a, b = np.asarray(x[k]), np.asarray(y[k])
            assert a.dtype.kind == b.dtype.kind or {a.dtype.kind, b.dtype.kind} <= {"U", "O"}, \
                (where, k, a.dtype, b.dtype)
            assert np.array_equal(a, b), (where, k)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("reader_kind", ["lmdb", "npy"])
@pytest.mark.parametrize("tree_name", ["pkl", "csv", "egtea"])
def test_epic_kitchens_matches_avt_tpu(trees, fake_lmdb, tree_name, reader_kind, option):
    ref, ours = _datasets(trees[tree_name], reader_kind, option)
    assert len(ours) == len(ref) > 0
    assert [str(u) for u in ours.df["uid"]] == [str(u) for u in ref.df["uid"]]
    assert ours.df.columns == list(ref.df.columns)
    for col in ref.df.columns:
        assert _same(ours.df[col].tolist(), ref.df[col].tolist()), col
    assert len(ours.discarded_df) == len(ref.discarded_df)
    assert ours.classes == ref.classes
    assert ours.classes_manyshot == ref.classes_manyshot
    assert ours.classes_counts == ref.classes_counts
    assert ours.primary_metric == ref.primary_metric == PRIMARY_METRIC[tree_name]
    cm, jcm = ours.class_mappings, ref.class_mappings
    assert cm.keys() == jcm.keys() and all(np.array_equal(cm[k], jcm[k]) for k in cm)
    for i in range(len(ref)):
        _assert_items_equal(ref[i], ours[i], (tree_name, reader_kind, option, i))


def test_stores_hold_the_missing_frames_the_readers_search_past(trees, fake_lmdb):
    """Both stores lack frames 300-311, so a window over them takes the
    backward search and the zero fill, and both readers agree."""
    _, npy_dir, lmdb_dir = trees["pkl"]
    a = treaders.NpyFeatsReader(str(npy_dir), read_type="normal")
    b = treaders.LMDBFeatsReader(str(lmdb_dir), read_type="normal")
    fa, _ = a("P01/P01_01.MP4", 9.5, 10.5, FPS, None)
    fb, _ = b("P01/P01_01.MP4", 9.5, 10.5, FPS, None)
    assert np.array_equal(fa, fb) and fa.shape == (30, 1, 1, DIM)
    assert not fa[-20:].any(axis=-1).all()  # zero rows past the search radius


def test_ek55_many_shot_classes_match_avt_tpu(tmp_path, fake_lmdb):
    annot = tmp_path / "ek55"
    annot.mkdir()
    rows = [dict(uid=10 + k, participant_id="P01", video_id="P01_01", start=5.0 + k,
                 end=6.0 + k, verb_class=k % 3, noun_class=k % 2) for k in range(6)]
    _expt_fixtures._ek_pkl(annot / "EPIC_train_action_labels.pkl", rows)
    (annot / "EPIC_verb_classes.csv").write_text("verb_id,class_key\n0,take\n1,put\n2,wash")
    (annot / "EPIC_noun_classes.csv").write_text("noun_id,class_key\n0,plate\n1,knife")
    (annot / "EPIC_many_shot_verbs.csv").write_text("verb_class,verb\n0,take\n2,wash\n")
    (annot / "EPIC_many_shot_nouns.csv").write_text("noun_class,noun\n1,knife\n")
    _expt_fixtures._actions_csv(annot / "actions.csv")
    kw = dict(annotation_path=[annot / "EPIC_train_action_labels.pkl"], version=0.1,
              action_labels_fpath=annot / "actions.csv", label_type=["verb", "noun", "action"],
              only_keep_persons="1-1")
    ours = EpicKitchens(reader=treaders.NpyFeatsReader(str(tmp_path)), **kw)
    ref = JEpicKitchens(reader=jreaders.NpyFeatsReader(str(tmp_path)), **kw)
    assert ours.classes_manyshot == ref.classes_manyshot
    assert ours.primary_metric == ref.primary_metric == "final_acc/action/top1"
    assert ours.df["noun"].tolist() == ref.df["noun"].tolist()
    assert ours.df["verb"].tolist() == ref.df["verb"].tolist()


def test_pkl_of_a_plain_dict_reads_without_pandas(tmp_path):
    annot = tmp_path / "a"
    annot.mkdir()
    cols = {"uid": [1, 2], "participant_id": ["P01", "P01"], "video_id": ["P01_01", "P01_01"],
            "start_timestamp": ["00:00:05.00", "00:00:09.50"],
            "stop_timestamp": ["00:00:06.00", "00:00:11.00"], "verb_class": [0, 1],
            "noun_class": [1, 0]}
    with open(annot / "EPIC_100_train.pkl", "wb") as f:
        pickle.dump(cols, f)
    _expt_fixtures._class_csvs(annot, "EPIC_100")
    ds = EpicKitchens(annotation_path=[annot / "EPIC_100_train.pkl"], version=0.2,
                      reader=treaders.NpyFeatsReader(str(tmp_path)), label_type="verb")
    assert ds.df["start"].tolist() == [5.0, 9.5] and ds.df["end"].tolist() == [6.0, 11.0]
    assert ds.df["action_class"].tolist() == [1, 2]  # (verb, noun) in the cross product


# --------------------------------------------------------------- loader
class _Items:
    """An indexable dataset whose item i fails (None, or raises) on some i."""

    def __init__(self, n, fail_every=0):
        self.n, self.fail_every = n, fail_every

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.fail_every and i % self.fail_every == 3:
            return None if i % 2 else (_ for _ in ()).throw(OSError("unreadable"))
        return {"video": np.full((2, 3), i, np.float32), "target": {"action": i % 7},
                "idx": i, "uid": f"u{i}"}


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True, seed=3),
    dict(shuffle=True, drop_last=False, seed=4, rank=1, world_size=3),
    dict(shuffle=False, drop_last=False, backfill="repeat", fail_every=5),
    dict(shuffle=True, drop_last=True, backfill="random", fail_every=4, seed=8),
], ids=["shuffle", "ranks", "repeat", "random_backfill"])
def test_loader_batches_match_avt_tpu(kw):
    kw = dict(kw)
    data = _Items(23, kw.pop("fail_every", 0))
    ours, ref = DataLoader(data, 4, num_workers=3, **kw), JDataLoader(data, 4, num_workers=3, **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(ours) == len(ref)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            _assert_items_equal(b, a, epoch)
        assert ours.backfill_count == ref.backfill_count


def test_loader_over_epic_kitchens_matches_avt_tpu(trees, fake_lmdb):
    ref_ds, ds = _datasets(trees["csv"], "npy", "last_clip")
    keys = ["video", "target", "target_subclips", "idx", "uid"]
    ours = DataLoader(ds, 5, shuffle=True, seed=42, num_workers=4, keys=keys)
    ref = JDataLoader(ref_ds, 5, shuffle=True, seed=42, num_workers=4, keys=keys)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == len(ds) // 5
    for a, b in zip(got, want):
        _assert_items_equal(b, a, "batch")


@pytest.mark.parametrize("world", [1, 2])
def test_clip_samplers_match_avt_tpu(world):
    class Clips:
        video_clips = [5, 1, 9, 4]

    kw = dict(train_bs_multiplier=3, val_clips_per_video=2, world_size=world, rank=world - 1)
    tr, ev = clip_samplers.build_clip_samplers(Clips(), {"": Clips()}, **kw)
    jtr, jev = jclip_samplers.build_clip_samplers(Clips(), {"": Clips()}, **kw)
    for epoch in (0, 1):
        tr.set_epoch(epoch)
        jtr.set_epoch(epoch)
        assert list(tr) == list(jtr) and len(tr) == len(jtr)
    assert list(ev[""]) == list(jev[""])
