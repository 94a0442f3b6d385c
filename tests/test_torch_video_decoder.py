"""The port's raw-video readers against avt_tpu's.

Both packages read the same cv2-written mp4s: the port's `LibavVideoReader`
(the native decoder built from native/videodecode/videodecode.cpp into the
port's `_build/` directory) and `OpenCVVideoReader` against avt_tpu's, bit
for bit (frames, timestamps, fps and duration, a remuxed copy, reads past
the end, a missing file, the handle pool under threads); the
`datasets.reader_fns.DefaultReader` rule; the build, which leaves native/
as it was and raises with the compiler's message when it fails.
"""
import hashlib
import logging
import threading
from pathlib import Path

import numpy as np
import pytest

import avt_tpu.config.registry as jregistry
import avt_tpu.data.readers as jreaders
import avt_tpu.data.video_decoder as jvd
from avt_tpu_torch.config import instantiate, resolve_target
from avt_tpu_torch.config import registry
from avt_tpu_torch.data import readers
from avt_tpu_torch.data import video_decoder as vd

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "native"
FPS, W, H, N = 30.0, 64, 48, 150


def _native_digest():
    h = hashlib.sha256()
    for f in sorted(NATIVE.rglob("*")):
        if f.is_file():
            h.update(str(f.relative_to(NATIVE)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """mp4v frames of a seeded noise pattern, their red channel the frame
    index."""
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    base = np.random.default_rng(0).integers(40, 200, size=(H, W, 3)).astype(np.uint8)
    for i in range(N):
        frame = base.copy()
        frame[:, :, 2] = i
        writer.write(frame)
    writer.release()
    return path


def test_decoder_builds_into_the_port_build_dir_and_leaves_native_alone(tmp_path, monkeypatch):
    before = _native_digest()
    monkeypatch.setattr(vd, "BUILD_DIR", tmp_path / "_build")
    lib = vd.build()
    assert lib.parent == tmp_path / "_build" and lib.exists()
    assert lib.name.startswith("libvideodecode-") and lib.name.endswith(".so")
    assert vd.build() == lib  # built once
    assert _native_digest() == before
    monkeypatch.undo()
    assert vd.library_path().parent == ROOT / "avt_tpu_torch" / "_build"
    assert vd.SOURCE == NATIVE / "videodecode" / "videodecode.cpp"


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(vd, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        vd.build(bad)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_probe_matches_avt_tpu(video):
    assert vd.get_video_info(video) == jvd.get_video_info(video)
    assert vd.LibavVideoReader().get_frame_rate(video) == jvd.LibavVideoReader().get_frame_rate(
        video)


RANGES = [(0.0, 0.2), (1.0, 2.0), (1.37, 1.5), (2.5, 4.9), (4.5, 99.0), (6.0, 7.0)]


@pytest.mark.parametrize("start,end", RANGES)
def test_libav_reader_matches_avt_tpu_bit_for_bit(video, start, end):
    frames, info = vd.LibavVideoReader()(video, start, end, FPS, None)
    jframes, jinfo = jvd.LibavVideoReader()(video, start, end, FPS, None)
    assert frames.dtype == np.uint8 and np.array_equal(frames, jframes) and info == jinfo
    handle, jhandle = vd._Handle(video), jvd._Handle(video)
    (f, pts), (jf, jpts) = handle.read_range(start, end), jhandle.read_range(start, end)
    assert np.array_equal(f, jf) and np.array_equal(pts, jpts)
    first = int(np.ceil(start * FPS - 1e-6))
    last = min(int(np.floor(end * FPS + 1e-6)), N - 1)
    np.testing.assert_allclose(pts, np.arange(first, last + 1) / FPS, atol=1e-6)
    assert np.array_equal(f, frames)


def test_missing_file_matches_avt_tpu(tmp_path):
    missing = tmp_path / "nope.mp4"
    for reader in (vd.LibavVideoReader(), jvd.LibavVideoReader()):
        assert reader.get_frame_rate(missing) == 0.0
        frames, info = reader(missing, 0.0, 1.0, FPS, None)
        assert frames.shape == (0, 1, 1, 3) and info == {}
    with pytest.raises(IOError, match="decoder open failed"):
        vd.get_video_info(missing)


def test_remux_matches_avt_tpu(video, tmp_path):
    out, jout = tmp_path / "port.mp4", tmp_path / "jax.mp4"
    vd.remux(video, out, pts_scale=1.5, pts_quad=0.01)
    jvd.remux(video, jout, pts_scale=1.5, pts_quad=0.01)
    assert vd.get_video_info(out) == jvd.get_video_info(jout)
    (f, pts), (jf, jpts) = vd._Handle(out).read_range(1.0, 3.0), \
        jvd._Handle(jout).read_range(1.0, 3.0)
    assert len(f) > 0 and np.array_equal(f, jf) and np.array_equal(pts, jpts)
    with pytest.raises(IOError):
        vd.remux(tmp_path / "nope.mp4", tmp_path / "x.mp4")


def test_handle_pool_under_threads_matches_avt_tpu(video):
    """Eight threads read clips of one video through one reader at once; each
    gets the frames avt_tpu's reader gives alone."""
    reader = vd.LibavVideoReader(max_pool_per_path=4)
    starts = [0.1 * i for i in range(16)]
    ref = {s: jvd.LibavVideoReader()(video, s, s + 0.9, FPS, None)[0] for s in starts}
    got, errors = {}, []

    def work(chunk):
        try:
            for s in chunk:
                got[s] = reader(video, s, s + 0.9, FPS, None)[0]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(starts[i::8],)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert all(np.array_equal(got[s], ref[s]) for s in starts)
    free = reader._pool._free[str(video)]
    assert 1 <= len(free) <= 4 and reader._pool._total == len(free)


@pytest.mark.parametrize("start,end", RANGES)
def test_opencv_reader_matches_avt_tpu(video, start, end):
    frames, info = readers.OpenCVVideoReader()(video, start, end, FPS, None)
    jframes, jinfo = jreaders.OpenCVVideoReader()(video, start, end, FPS, None)
    assert np.array_equal(frames, jframes) and info == jinfo
    assert readers.OpenCVVideoReader().get_frame_rate(video) == \
        jreaders.OpenCVVideoReader().get_frame_rate(video)


def test_opencv_reader_of_a_missing_file(tmp_path):
    frames, info = readers.OpenCVVideoReader()(tmp_path / "nope.mp4", 0.0, 1.0, FPS, None)
    assert frames.shape == (0, 1, 1, 3) and info == {}


@pytest.mark.parametrize("target", ["datasets.reader_fns.DefaultReader",
                                    "avt_tpu.data.LibavVideoReader"])
def test_default_reader_rule_matches_avt_tpu(target, video, monkeypatch, caplog):
    """The native decoder when it builds, OpenCV when it does not, as the JAX
    package's `_default_video_reader`; one log line names the reader and,
    on the fallback, why."""
    with caplog.at_level(logging.INFO, logger=registry.LOG.name):
        reader = instantiate({"_target_": target})
    assert type(reader) is vd.LibavVideoReader
    assert type(jregistry.resolve_target(target)()).__name__ == "LibavVideoReader"
    assert [r.message for r in caplog.records] == [
        "video reader: LibavVideoReader (the native libav decoder)"]
    caplog.clear()
    monkeypatch.setattr(vd, "native_decoder_error", lambda: "RuntimeError: no libav")
    monkeypatch.setattr(jvd, "have_native_decoder", lambda: False)
    with caplog.at_level(logging.INFO, logger=registry.LOG.name):
        reader = resolve_target(target)()
    assert type(reader) is readers.OpenCVVideoReader
    assert type(jregistry.resolve_target(target)()) is jreaders.OpenCVVideoReader
    assert len(caplog.records) == 1 and "OpenCVVideoReader" in caplog.records[0].message
    assert "no libav" in caplog.records[0].message
    frames, _ = reader(video, 1.0, 1.2, FPS, None)
    assert np.array_equal(frames, jreaders.OpenCVVideoReader()(video, 1.0, 1.2, FPS, None)[0])


def test_have_native_decoder_reports_a_failed_build(monkeypatch):
    assert vd.have_native_decoder() and vd.native_decoder_error() is None

    def fail():
        raise RuntimeError("video decoder build failed (exit 1): no libav")

    monkeypatch.setattr(vd, "_load_lib", fail)
    assert not vd.have_native_decoder()
    assert "no libav" in vd.native_decoder_error()


@pytest.mark.parametrize("skip_done", [False, True], ids=["fresh", "resume"])
def test_dense_sampling_probes_videos_as_avt_tpu(tmp_path, monkeypatch, skip_done):
    """`sample_clips_densely_fn` on expts/01's eval dataset over chip_smoke.py's
    raw-video EK100 tree: each video's length comes from the decoder's
    probe, and the clips match avt_tpu's; resuming a feature extraction
    skips the uids already in the results (the port's numpy result files,
    avt_tpu's H5 file)."""
    import sys

    from avt_tpu.config import Composer as JComposer
    from avt_tpu.config import parse_override as jparse_override
    from avt_tpu.config import parse_overrides_file as jparse_overrides_file
    from avt_tpu.config.build import build_dataset as jbuild_dataset
    from avt_tpu.evaluate.results import store_append_h5
    from avt_tpu_torch import train_net
    from avt_tpu_torch.config import Composer, parse_override, parse_overrides_file
    from avt_tpu_torch.config.build import build_dataset
    from avt_tpu_torch.evaluate import store_append

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    tree = chip_smoke.write_ek100_tree(str(tmp_path / "tree"), train_videos=1, eval_videos=2,
                                       actions_per_video=3, first_action_s=12, seed=7,
                                       video=(64, 48, 10))
    dense = "{_target_: datasets.base_video_dataset.dense_clip_sampler, stride: 2.5"
    if skip_done:
        done = np.asarray(["P02_01_5.0", "P02_02_10.0"])
        store_append({"uid": done, "idx": np.arange(2)}, str(tmp_path / "port"))
        store_append_h5({"uid": done, "idx": np.arange(2)}, str(tmp_path / "jax"))
        dense += ", featext_skip_done: true, featext_results_dir: RESULTS"
    probe = _counting(vd.get_video_info)
    monkeypatch.setattr(vd, "get_video_info", probe)
    datasets = []
    for comp, parse_file, parse, build, results in (
            (Composer, parse_overrides_file, parse_override, build_dataset, "port"),
            (JComposer, jparse_overrides_file, jparse_override, jbuild_dataset, "jax")):
        overrides = tree + ["+dataset_eval.sample_clips_densely_fn="
                            + dense.replace("RESULTS", str(tmp_path / results)) + "}"]
        cfg = comp(train_net.CONF_DIR).compose("config", parse_file(
            ROOT / "expts" / "01_ek100_avt.txt") + [parse(o) for o in overrides])
        datasets.append(build(cfg["dataset_eval"], cfg["data_eval"]))
    ds, jds = datasets
    assert probe.calls == 2  # one probe a video, cached
    assert len(ds) == len(jds) > 6
    for col in ("uid", "start", "end", "orig_start", "orig_end", "action_class"):
        assert np.array_equal(ds.df[col], jds.df[col].to_numpy()), col
    uids = set(ds.df["uid"].tolist())
    assert not skip_done or not uids & {"P02_01_5.0", "P02_02_10.0"}
    assert skip_done or {"P02_01_5.0", "P02_02_10.0"} <= uids


def _counting(fn):
    def counted(path):
        counted.calls += 1
        return fn(path)

    counted.calls = 0
    return counted
