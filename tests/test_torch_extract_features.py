"""tools/torch_extract_features.py (raw video -> featext through the port ->
a RULSTM-layout store) against tools/extract_features.py and avt_tpu.

  * the frame keying and the rejection of an endpoint that is not
    aggregated, as the JAX tool's;
  * `pack` over the port's npz sink (two ranks' files) read back bit for
    bit through both of the port's readers, the LMDB one on
    tests/_fake_lmdb.py;
  * a whole extraction on the CPU (a depth-1 ViT of width 32 on 64x48
    videos, the mean aggregator): every packed row against avt_tpu's model
    applied with the same weights (the port loads `params_from_jax` of the
    JAX parameters through train.init_from_model) to the clips avt_tpu's
    dataset decodes and its eval preprocessing makes, at 2e-4;
  * two gloo ranks on the CPU, each extracting its share of the videos,
    rank 0 packing after the barrier: the same store.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

import _fake_lmdb  # noqa: E402
import extract_features as jxf  # noqa: E402
import torch_extract_features as txf  # noqa: E402

from avt_tpu_torch.data.readers import FeatsReaderBase, LMDBFeatsReader  # noqa: E402
from avt_tpu_torch.evaluate.results import store_append  # noqa: E402

C = 24
N_CLS = 6
FPS = 10.0
TOL = 2e-4


@pytest.mark.parametrize("t", [1.0, 0.999, 0.0, 2.5, 7.25, 123.4567, 0.02])
def test_frame_id_for_time_matches_the_jax_tool(t):
    assert txf.frame_id_for_time(t) == jxf.frame_id_for_time(t)
    assert txf.frame_id_for_time(t, 10.0) == jxf.frame_id_for_time(t, 10.0)


def test_an_exact_time_readback_hits_the_key():
    fid = txf.frame_id_for_time(2.5)
    frames = FeatsReaderBase(read_type="normal").frame_ids_for_window(
        (fid - 1) / 30.0, fid / 30.0, 30.0)
    assert frames.tolist() == [fid] == [75]


def _sink(tmp_path):
    """Two ranks' npz results of features every 0.25 s over two videos, and
    the index; a second batch of rank 1 re-extracts two of its uids (a
    resumed run), whose later rows must win."""
    rng = np.random.default_rng(0)
    results = tmp_path / "results"
    index, rows = {}, []
    for v in range(2):
        stem = f"P0{v}_01"
        for t in np.arange(0.25, 20.0, 0.25):
            uid = f"{stem}_{t}"
            index[uid] = (stem, float(t))
            rows.append((uid, rng.normal(size=C).astype(np.float32)))
    for rank in (0, 1):
        chunk = rows[rank::2]
        for part in (chunk[:40], chunk[40:]):
            store_append({"temp_agg": np.stack([f for _, f in part]),
                          "uid": np.asarray([u for u, _ in part]),
                          "idx": np.arange(len(part)), "epoch": np.asarray([0.0])},
                         str(results), rank=rank)
    redo = rows[1::2][:2]
    redo = [(u, f + 1.0) for u, f in redo]
    store_append({"temp_agg": np.stack([f for _, f in redo]),
                  "uid": np.asarray([u for u, _ in redo]), "idx": np.arange(2),
                  "epoch": np.asarray([0.0])}, str(results), rank=1)
    want = dict(rows)
    want.update(redo)
    return results, index, want


def test_pack_and_read_back_bit_for_bit_through_both_readers(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb)
    results, index, want = _sink(tmp_path)
    out = tmp_path / "store"
    stats = txf.pack(str(results), index, str(out), endpoint="temp_agg",
                     formats=("npy", "lmdb"))
    assert stats == {"rows": len(index) + 2, "skipped": 0, "videos": 2}
    for stem in ("P00_01", "P01_01"):
        arr = np.load(out / "npy" / f"{stem}.npy")
        assert arr.shape == (txf.frame_id_for_time(19.75), C) and arr.dtype == np.float32
        for uid, (s, t) in index.items():
            if s == stem:
                np.testing.assert_array_equal(arr[txf.frame_id_for_time(t) - 1], want[uid])
        keyed = {txf.frame_id_for_time(t) - 1 for u, (s, t) in index.items() if s == stem}
        assert np.isnan(arr[[i for i in range(len(arr)) if i not in keyed]]).all()
    lmdb_reader = LMDBFeatsReader(str(out / "lmdb"), read_type="normal",
                                  warn_if_using_closeby_frame=False)
    uid = "P01_01_7.25"
    got, _ = lmdb_reader("P01_01.mp4", 7.25 - 2 / 30, 7.25, 30.0, None)
    np.testing.assert_array_equal(got[-1].reshape(-1), want[uid])
    # every stored row, through both readers, against the sink's last rows
    n = txf.verify_roundtrip(str(results), index, str(out), endpoint="temp_agg", n_check=None)
    assert n == 2 * len(index)


def test_pack_matches_the_jax_tool_on_the_same_rows(tmp_path):
    """The JAX tool packs the same rows from its H5 sink: the same npy
    store, NaN rows included."""
    h5py = pytest.importorskip("h5py")
    from avt_tpu.evaluate.results import store_append_h5

    results, index, _ = _sink(tmp_path)
    jresults = tmp_path / "jresults"
    for rank in (0, 1):
        for fpath in sorted((results / str(rank)).glob("*.npz")):
            with np.load(fpath) as d:
                store_append_h5({k: (np.asarray([u.decode() for u in d[k]])
                                     if d[k].dtype.kind == "S" else d[k]) for k in d.files},
                                str(jresults), rank=rank)
    assert h5py is not None
    txf.pack(str(results), index, str(tmp_path / "t"), formats=("npy",))
    jxf.pack(str(jresults), index, str(tmp_path / "j"), formats=("npy",))
    for stem in ("P00_01", "P01_01"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / "npy" / f"{stem}.npy"),
                                      np.load(tmp_path / "j" / "npy" / f"{stem}.npy"))


def test_pack_rejects_an_endpoint_that_is_not_aggregated(tmp_path):
    store_append({"backbone": np.zeros((2, 4, C), np.float32),  # (B, T, C)
                  "uid": np.asarray(["P00_01_1.0", "P00_01_2.0"]), "idx": np.arange(2)},
                 str(tmp_path / "results"))
    index = {"P00_01_1.0": ("P00_01", 1.0), "P00_01_2.0": ("P00_01", 2.0)}
    with pytest.raises(ValueError, match="aggregated endpoint"):
        txf.pack(str(tmp_path / "results"), index, str(tmp_path / "s"), endpoint="backbone",
                 formats=("npy",))
    with pytest.raises(KeyError, match="--endpoint"):
        txf.pack(str(tmp_path / "results"), index, str(tmp_path / "s"), endpoint="temp_agg",
                 formats=("npy",))


# ---------------------------------------------------------- whole extraction
@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """Three 12 s videos of 64x48 at 10 fps (P02 is the eval split), each
    frame a seeded colour field with a moving block, and EK100 annotations
    (3 verbs, 2 nouns, 6 actions)."""
    cv2 = pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("torch_featext")
    annot = tmp / "annot"
    annot.mkdir()
    (annot / "EPIC_100_verb_classes.csv").write_text(
        "id,key\n" + "\n".join(f"{i},v{i}" for i in range(3)))
    (annot / "EPIC_100_noun_classes.csv").write_text(
        "id,key\n" + "\n".join(f"{i},n{i}" for i in range(2)))
    (annot / "actions.csv").write_text(
        "id,verb,noun,action\n" + "\n".join(f"{i},{i % 3},{i % 2},a{i}" for i in range(N_CLS)))
    rng = np.random.default_rng(1)
    rows = {"training": [], "validation": []}
    uid = 0
    for v in range(3):
        part = f"P0{v}"
        (tmp / "vids" / part).mkdir(parents=True)
        writer = cv2.VideoWriter(str(tmp / "vids" / part / f"{part}_01.MP4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), FPS, (64, 48))
        field = rng.integers(0, 256, size=(48, 64, 3)).astype(np.float32)
        for i in range(int(12 * FPS)):
            frame = ((field + 3 * i) % 256).astype(np.uint8)
            frame[16:32, (2 * i) % 48:(2 * i) % 48 + 16] = 255
            writer.write(frame)
        writer.release()
        for k in range(2):
            at = 5.0 + 3 * k
            rows["validation" if v == 2 else "training"].append(
                f"{uid},{part}_01,{int(at * 30)},{int((at + 1) * 30)},{uid % 3},{uid % 2},"
                f"{uid % N_CLS}")
            uid += 1
    for split, lines in rows.items():
        (annot / f"{split}.csv").write_text("\n".join(lines))
    return tmp


def _overrides(tmp, init=None):
    out = [
        f"dataset.epic_kitchens100.common.annot_dir={tmp}/annot/",
        f"dataset.epic_kitchens100.common.rulstm_annot_dir={tmp}/annot/",
        "train.batch_size=1", "eval.batch_size=8",
        "model/backbone=avt_b", "model.backbone_last_n_modules_to_drop=0",
        "+model.backbone.img_size=32", "+model.backbone.patch_size=16",
        "+model.backbone.embed_dim=32", "+model.backbone.depth=1",
        "+model.backbone.num_heads=2", "model.backbone_dim=32",
        "model/temporal_aggregator=mean", "model/future_predictor=identity",
        "data_train.num_frames=2", "data_train.frame_rate=2",
        "data_eval.num_frames=2", "data_eval.frame_rate=2",
        "data_train.scale_h=36", "data_train.scale_w=-1", "data_train.crop_size=32",
        "data_eval.scale_h=36", "data_eval.scale_w=-1", "data_eval.crop_size=32",
        "data_train.workers=2", "data_eval.workers=2",
        "dataset_train.sample_strategy=last_clip", "dataset_eval.sample_strategy=last_clip",
        "dataset_train.conv_to_anticipate_fn.tau_a=1",
        "dataset_train.conv_to_anticipate_fn.tau_o=2",
        f"dataset_train.annotation_path=[{tmp}/annot/training.csv]",
        f"dataset_eval.annotation_path=[{tmp}/annot/training.csv, "
        f"{tmp}/annot/validation.csv]",
        f"dataset_train.root=[{tmp}/vids]", f"dataset_eval.root=[{tmp}/vids]",
    ]
    return out + ([f"train.init_from_model=[[{init}]]"] if init else [])


ARGS = ["--endpoint", "temp_agg", "--clip-len", "1.0", "--stride", "1.0", "--formats", "npy"]


@pytest.fixture(scope="module")
def jax_weights(video_tree, tmp_path_factory):
    """avt_tpu's model of the extraction's config, its parameters and
    their `params_from_jax` state_dict in a file for train.init_from_model."""
    import jax

    from avt_tpu.config import build as jbuild
    from avt_tpu_torch.models.convert import params_from_jax

    args = jxf.argparse.Namespace(clip_len=1.0, stride=1.0, resume=False,
                                  run_dir=str(tmp_path_factory.mktemp("jrun")),
                                  endpoint="temp_agg")
    jcfg = jxf.compose_cfg(None, _overrides(video_tree), args, str(ROOT / "conf"),
                           for_index=True)
    jtrain = jbuild.build_dataset(jcfg["dataset_train"], jcfg["data_train"])
    jds = jbuild.build_dataset(jcfg["dataset_eval"], jcfg["data_eval"])
    num_classes = {k: len(v) for k, v in jtrain.classes.items()}
    jm = jbuild.build_model(jcfg, num_classes, jtrain.class_mappings)
    _, eval_pp = jbuild.build_preprocess_fns(jcfg)
    video = eval_pp(jax.numpy.asarray(jds[0]["video"][None]))
    params = jm.init(jax.random.PRNGKey(3), video, (1,))
    path = tmp_path_factory.mktemp("init") / "avt_tpu_params.pth"
    torch.save({k: v.contiguous() for k, v in params_from_jax(params).items()}, path)
    return jm, params, jds, eval_pp, str(path)


def test_extraction_on_the_cpu_matches_avt_tpu(video_tree, jax_weights, tmp_path):
    import jax

    jm, params, jds, eval_pp, init = jax_weights
    run_dir, out = tmp_path / "run", tmp_path / "store"
    stats = txf.main(["--run-dir", str(run_dir), "--out", str(out)] + ARGS
                     + _overrides(video_tree, init), device="cpu")
    index = txf.read_index(str(run_dir / txf.INDEX_NAME))
    assert stats == {"rows": len(index), "skipped": 0, "videos": 3} and len(index) == 36
    assert len(jds) == len(index)
    apply = jax.jit(lambda p, v: jm.apply(p, v, (v.shape[0],))[0]["temp_agg"])
    stores = {s: np.load(out / "npy" / f"{s}.npy") for s in ("P00_01", "P01_01", "P02_01")}
    for i in range(len(jds)):
        item = jds[i]
        want = np.asarray(apply(params, eval_pp(jax.numpy.asarray(item["video"][None]))))[0]
        stem, end = index[str(item["uid"])]
        got = stores[stem][txf.frame_id_for_time(end) - 1]
        assert got.shape == want.shape == (32,)
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0,
                                   err_msg=str(item["uid"]))


def test_two_gloo_ranks_extract_their_shares_and_rank0_packs(video_tree, jax_weights,
                                                             tmp_path):
    init = jax_weights[-1]
    one = tmp_path / "one"
    txf.main(["--run-dir", str(tmp_path / "run1"), "--out", str(one)] + ARGS
             + _overrides(video_tree, init), device="cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    run_dir, out = tmp_path / "run2", tmp_path / "two"
    cmd = [sys.executable, str(ROOT / "tools" / "torch_extract_features.py"),
           "--run-dir", str(run_dir), "--out", str(out)] + ARGS + _overrides(video_tree, init)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(AVT_PLATFORM="cpu", WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    # rank 0 alone packed and verified (rank 1 logs warnings only)
    assert "packed 36 features" in logs[0] and "verified" in logs[0]
    assert "packed" not in logs[1]
    # each rank wrote its own share of the videos
    assert sorted(os.listdir(run_dir / "results")) == ["0", "1"]
    for stem in ("P00_01", "P01_01", "P02_01"):
        a, b = np.load(one / "npy" / f"{stem}.npy"), np.load(out / "npy" / f"{stem}.npy")
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_dense_clips_probe_the_video_length_with_opencv_without_the_decoder(video_tree,
                                                                           monkeypatch):
    """Where the native decoder does not build (the card's image has no libav
    headers), the dense sampler's lengths come from OpenCV: the same as the
    decoder's on these videos."""
    from avt_tpu_torch.config import build
    from avt_tpu_torch.data import video_decoder

    paths = sorted(str(p) for p in (video_tree / "vids").rglob("*.MP4"))
    want = [video_decoder.get_video_info(p)["len"] for p in paths]
    build._video_len_cached.cache_clear()
    monkeypatch.setattr(video_decoder, "native_decoder_error", lambda: "no libav headers")
    try:
        got = [build._video_len_cached(p) for p in paths]
    finally:
        build._video_len_cached.cache_clear()
    assert got == want == [12.0] * 3


@pytest.mark.parametrize("read_type", ["normal", "exact_rulstm"])
def test_a_store_packed_at_a_stride_reads_as_the_frame_by_frame_search(tmp_path, read_type):
    """NpyFeatsReader's search over a whole window at once, on a store with
    most rows missing (keys every 7-8 frames, a gap wider than the search
    radius, rows past the end): the same array as the frame-by-frame
    `read_window` and as avt_tpu's reader, zero rows included; a window
    with no row in reach raises as both do."""
    from avt_tpu.data.readers import NpyFeatsReader as JNpyFeatsReader
    from avt_tpu_torch.data.readers import NpyFeatsReader

    rng = np.random.default_rng(9)
    arr = np.full((900, 6), np.nan, np.float32)
    for t in np.arange(0.0, 30.0, 0.25):
        arr[txf.frame_id_for_time(t) - 1] = rng.normal(size=6)
    arr[300:340] = np.nan  # a gap the search cannot cross
    np.save(tmp_path / "P01_01.npy", arr)
    ours = NpyFeatsReader(str(tmp_path), read_type=read_type)
    ref = JNpyFeatsReader(str(tmp_path), read_type=read_type)
    windows = [(0.0, 4.0), (5.0, 12.3), (9.9, 11.5), (26.0, 30.5), (29.5, 33.0), (0.0, 30.0)]
    for start, end in windows:
        if start > 26.0 and read_type == "exact_rulstm":  # 2.5 s, all of it past the end
            for reader in (ours, ref):
                with pytest.raises(ValueError, match="No features found"):
                    reader("P01_01.mp4", start, end, 30.0, None)
            continue
        got, _ = ours("P01_01.mp4", start, end, 30.0, None)
        frames = ours.frame_ids_for_window(start, end, 30.0)
        loop = ours.read_window("P01_01", frames, fetch=lambda s, f: ours._fetch_root(0, s, f))
        want, _ = ref("P01_01.mp4", start, end, 30.0, None)
        np.testing.assert_array_equal(got[:, 0, 0], loop)
        np.testing.assert_array_equal(got, want)
    if read_type == "normal":
        assert (got[:, 0, 0] == 0).all(axis=-1).any()  # zero rows in the gap
    with pytest.raises(ValueError, match="No features found"):
        ours("P01_01.mp4", 45.0, 50.0, 30.0, None)
