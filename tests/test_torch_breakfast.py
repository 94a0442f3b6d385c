"""The port's Breakfast / 50Salads data against avt_tpu's.

On the 50Salads part of tests/_expt_fixtures.py's tree (three cv2-written
videos at 10 fps with hardware-timestamp files and activity annotations,
plus Abu-Farha per-frame label files written here), expts/13's datasets
are built by both packages from the composed config, under both
annotation readers (the original activity files and Abu-Farha's), train
and eval splits: the tables after the anticipation conversion (float16
times included) and every item (frames read by each package's native
decoder, frame times, labels) must be equal. Then the Breakfast .labels
reader with its stereo-channel file names, the Sener feature readers (gz
and npy) and the mapping file, on small files written here.
"""
import gzip
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

import avt_tpu.data.breakfast_50salads as jbf
from avt_tpu.config import Composer as JComposer
from avt_tpu.config import expand_sweeps as jexpand_sweeps
from avt_tpu.config import parse_override as jparse_override
from avt_tpu.config import parse_overrides_file as jparse_overrides_file
from avt_tpu.config.build import build_all_datasets as jbuild_all_datasets
from avt_tpu_torch import train_net
from avt_tpu_torch.config import Composer, expand_sweeps, parse_override, parse_overrides_file
from avt_tpu_torch.config.build import build_all_datasets
from avt_tpu_torch.data import breakfast_50salads as bf

import _expt_fixtures

pytest.importorskip("cv2")

EXPT = Path(__file__).resolve().parents[1] / "expts" / "13_50s_avt.txt"
READERS = {"orig": [], "abu_farha": [
    "dataset/dundee50salads/annot_reader_fn@dataset.dundee50salads.annot_reader_fn=abu_farha"]}


@pytest.fixture(scope="module")
def salads_root(tmp_path_factory):
    """The fixture tree's 50Salads videos and annotations (the other
    datasets' stores and videos are not written), and Abu-Farha label files
    of one action name a frame, from the activity annotations."""
    root = tmp_path_factory.mktemp("salads")
    write_video = _expt_fixtures._write_video
    with mock.patch.object(_expt_fixtures, "_lmdb_store", lambda *a, **k: None), \
            mock.patch.object(_expt_fixtures, "_write_video",
                              lambda path, *a, **k: write_video(path, *a, **k)
                              if "50Salads" in str(path) else None):
        data = _expt_fixtures.build_data_tree(root)
    gt = data / "annotations" / "50salads" / "groundTruth"
    n_frames = int(_expt_fixtures.VIDEO_SECONDS * _expt_fixtures.RAW_FPS)
    for i, vid in enumerate(["01-1", "02-1", "03-1"]):
        labels = ["mix_ingredients"] * n_frames
        for j, at in enumerate(_expt_fixtures.ACTION_STARTS):
            first = int(at * _expt_fixtures.RAW_FPS)
            name = ["cut_tomato", "peel_cucumber", "mix_ingredients"][(i + j) % 3]
            labels[first:first + 20] = [name] * 20
        (gt / f"rgb-{vid}.txt").write_text("\n".join(labels) + "\n")
    return root


def _datasets(root, reader, monkeypatch):
    monkeypatch.chdir(root)
    overrides = READERS[reader] + ["dataset.dundee50salads.common.fold=2"]
    cfg = Composer(train_net.CONF_DIR).compose("config", expand_sweeps(parse_overrides_file(
        EXPT) + [parse_override(o) for o in overrides])[0])
    jcfg = JComposer(train_net.CONF_DIR).compose("config", jexpand_sweeps(jparse_overrides_file(
        EXPT) + [jparse_override(o) for o in overrides])[0])
    (train,), evals = build_all_datasets(cfg)
    (jtrain,), jevals = jbuild_all_datasets(jcfg)
    return [(train, jtrain), (evals[""], jevals[""])]


def _same_table(table, df):
    assert table.columns == list(df.columns)
    for col in df.columns:
        ref = df[col].to_numpy()
        assert table[col].dtype == ref.dtype, col
        assert np.array_equal(table[col], ref), col


@pytest.mark.parametrize("split", [0, 1], ids=["train", "eval"])
@pytest.mark.parametrize("reader", sorted(READERS))
def test_50salads_items_match_avt_tpu(salads_root, reader, split, monkeypatch):
    ds, jds = _datasets(salads_root, reader, monkeypatch)[split]
    assert isinstance(ds, bf.Breakfast50Salads) and ds.which == "50Salads"
    assert len(ds) == len(jds) > 0
    assert ds.action_classes == jds.action_classes
    assert ds.classes_counts == jds.classes_counts
    _same_table(ds.df, jds.df)
    for i in range(len(ds)):
        item, ref = ds[i], jds[i]
        assert item["video"].shape[1:] == (96, 128, 3)
        for key in ("video", "video_frame_sec", "idx", "uid", "start", "end"):
            assert np.array_equal(item[key], ref[key]), key
        assert dict(item["target"]) == dict(ref["target"])


def test_annotation_readers_match_avt_tpu(salads_root):
    salads = salads_root / "DATA"
    videos = ["rgb-01-1.txt\n", "rgb-03-1.txt\n"]
    classes = bf.load_mappings_file(salads / "annotations" / "50salads" / "mapping.txt")
    assert classes == jbf.load_mappings_file(salads / "annotations" / "50salads" / "mapping.txt")
    root = salads / "videos" / "50Salads"
    info = {"fps": 10.0}.copy
    kw = dict(annots_dir=root / "activityAnnotations", timestamps_dir=root / "timestamps")
    assert bf.read_orig_50salads_annotations(videos, root / "rgb", classes, **kw) == \
        jbf.read_orig_50salads_annotations(videos, root / "rgb", classes, **kw)
    assert bf.read_orig_50salads_annotations(
        videos, root / "rgb", classes, video_info_fn=lambda p: info(), **kw) == \
        jbf.read_orig_50salads_annotations(videos, root / "rgb", classes, **kw)
    kw = dict(annots_dir=salads / "annotations" / "50salads" / "groundTruth",
              bundle_entry_to_vname_fn=bf.bundle_entry_to_video_fname_50salads)
    jkw = dict(kw, bundle_entry_to_vname_fn=jbf.bundle_entry_to_video_fname_50salads)
    got = bf.read_abu_farha_annotations(videos, root / "rgb", classes, **kw)
    assert got == jbf.read_abu_farha_annotations(videos, root / "rgb", classes, **jkw)
    assert bf.read_abu_farha_annotations(videos, root / "rgb", classes, frame_rate=15.0, **kw) \
        == jbf.read_abu_farha_annotations(videos, root / "rgb", classes, frame_rate=15.0, **jkw)
    # the runs of one label: 7 a video, less where an action bears the
    # background's name and merges with it
    assert len(got) == 10


def test_breakfast_labels_and_file_names_match_avt_tpu(tmp_path):
    """Breakfast .labels at 15 fps, a stereo camera whose annotations sit
    on channel 1 only, an unknown activity skipped."""
    for rel, text in (("P03/cam01/P03_cereals.avi.labels", "1-30 SIL\n31-95 take_bowl\n"),
                      ("P04/stereo/P04_coffee_ch1.avi.labels",
                       "1-12 SIL\n13-40 pour_milk\n41-60 dance\n")):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    classes = {"SIL": 0, "take_bowl": 1, "pour_milk": 2}
    videos = ["P03_cam01_P03_cereals.txt", "P04_stereo01_P04_coffee.txt"]
    for v in videos:
        assert bf.bundle_entry_to_video_fname_breakfast(v, tmp_path) == \
            jbf.bundle_entry_to_video_fname_breakfast(v, tmp_path)
    got = bf.read_orig_breakfast_annotations(videos, tmp_path, classes)
    assert got == jbf.read_orig_breakfast_annotations(videos, tmp_path, classes)
    assert [s[1] for s in got][-1] == "P04/stereo/P04_coffee_ch1.avi" and len(got) == 4
    assert bf.bundle_entry_to_video_fname_50salads("rgb-27-2.txt") == \
        jbf.bundle_entry_to_video_fname_50salads("rgb-27-2.txt")


@pytest.mark.parametrize("fmt", ["gz", "npy"])
def test_sener_feats_readers_match_avt_tpu(tmp_path, fmt):
    feats = np.random.default_rng(0).standard_normal((40, 6)).astype(np.float32)
    if fmt == "gz":
        with gzip.open(tmp_path / "rgb-01-1.gz", "wt") as f:
            f.write("\n".join(" ".join(f"{v:.6f}" for v in row) for row in feats) + "\n")
        reader, jreader = bf.GZFormatReader(), jbf.GZFormatReader()
    else:
        np.save(tmp_path / "rgb-01-1.npy", feats.T)
        reader, jreader = bf.NPYFormatReader(), jbf.NPYFormatReader()
    row = {"video_bundle_name": "rgb-01-1.txt\n"}
    info = lambda path: {"fps": 15.0}  # noqa: E731
    sener = bf.SenerFeatsReader(tmp_path, reader, video_info_fn=info)
    jsener = jbf.SenerFeatsReader(tmp_path, jreader, video_info_fn=info)
    assert sener.get_frame_rate("x.avi") == jsener.get_frame_rate("x.avi") == 15.0
    for start, end in ((0.0, 1.0), (0.4, 2.0), (2.0, 9.0)):
        out, ref = sener("x.avi", start, end, 15.0, row), jsener("x.avi", start, end, 15.0, row)
        assert out[0].shape[1:3] == (1, 1) and np.array_equal(out[0], ref[0])
