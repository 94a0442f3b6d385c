"""The port's tools against the JAX package's, on the CPU:
  * tools/torch_compute_centroids.py against tools/compute_centroids.py on
    the same npy files and seed (well-separated blobs: the same centroids
    up to a permutation, at 1e-5), an LMDB source (tests/_fake_lmdb.py)
    and a sparse store's NaN rows;
  * tools/torch_viz_attention.py's maps against avt_tpu's `gpt2_att_<k>`
    endpoints at 2e-4, the same weights (`params_from_jax`) and the same
    decoded frames, with both figures of each step written;
  * tools/torch_smoke_train.py: both modes compose as avt_tpu composes the
    same overrides, and the feature mode trains one epoch through the
    port's train_net.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

import _fake_lmdb  # noqa: E402
import compute_centroids as jcc  # noqa: E402
import smoke_train as jsmoke  # noqa: E402
import torch_compute_centroids as tcc  # noqa: E402
import torch_smoke_train as tsmoke  # noqa: E402
import torch_viz_attention as tviz  # noqa: E402
import viz_attention as jviz  # noqa: E402

from avt_tpu_torch.models import load_centroids  # noqa: E402

TOL = 2e-4


def _blobs(tmp_path):
    """Two npy files ((N, C) and (N, T, C)) of 6 well-separated blobs."""
    rng = np.random.default_rng(4)
    true = 4.0 * np.eye(6, 8, dtype=np.float32) + 1.0
    feats = np.concatenate([c + 0.05 * rng.normal(size=(60, 8)) for c in true]
                           ).astype(np.float32)[rng.permutation(360)]
    np.save(tmp_path / "a.npy", feats[:120])
    np.save(tmp_path / "b.npy", feats[120:].reshape(40, 6, 8))
    return feats, [str(tmp_path / "a.npy"), str(tmp_path / "b.npy")]


def _order(c):
    return c[np.lexsort(c.T[::-1])]


@pytest.mark.parametrize("norm", [False, True])
def test_compute_centroids_matches_the_jax_tool(tmp_path, norm):
    _, files = _blobs(tmp_path)
    args = ["-k", "6", "--iters", "10", "--seed", "3"] + (["--norm"] if norm else [])
    jcc.main(files + args + ["-o", str(tmp_path / "j.npy")])
    tcc.main(files + args + ["-o", str(tmp_path / "t.npy")], device="cpu")
    got, want = load_centroids(str(tmp_path / "t.npy")), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape == (6, 8) and got.dtype == np.float32
    np.testing.assert_allclose(_order(got), _order(want), atol=1e-5, rtol=1e-5)


def test_compute_centroids_reads_an_lmdb_store_and_drops_missing_rows(tmp_path, monkeypatch):
    """The same features as an LMDB store, and as a sparse npy store whose
    missing frames are NaN rows: the centroids of the dense files."""
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb)
    feats, files = _blobs(tmp_path)
    args = ["-k", "6", "--iters", "10", "--seed", "3"]
    want = tcc.main(files + args + ["-o", str(tmp_path / "dense.npy")], device="cpu")
    env = _fake_lmdb.open(str(tmp_path / "lmdb"), map_size=1 << 24)
    with env.begin(write=True) as txn:
        for i, row in enumerate(feats):
            txn.put(f"P01_01_frame_{i + 1:010d}.jpg".encode(), row.tobytes())
    got = tcc.main([str(tmp_path / "lmdb"), "--lmdb"] + args + ["-o", str(tmp_path / "l.npy")],
                   device="cpu")
    np.testing.assert_allclose(_order(got), _order(want), atol=1e-5, rtol=1e-5)
    sparse = np.full((3 * len(feats), 8), np.nan, np.float32)
    sparse[::3] = feats
    np.save(tmp_path / "sparse.npy", sparse)
    got = tcc.main([str(tmp_path / "sparse.npy")] + args + ["-o", str(tmp_path / "s.npy")],
                   device="cpu")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(_order(got), _order(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def clip_video(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("viz") / "clip.MP4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 48))
    field = np.random.default_rng(2).integers(0, 256, size=(48, 64, 3)).astype(np.float32)
    for i in range(60):
        frame = ((field + 4 * i) % 256).astype(np.uint8)
        frame[10:30, (3 * i) % 40:(3 * i) % 40 + 20] = 250
        writer.write(frame)
    writer.release()
    return path


def _viz_config(tmp_path):
    """smoke_train's raw-video model (a 2-block ViT of width 32, AVT-h of 2
    layers of 2 heads) with 4 frames and a rollout of 3 steps."""
    lines = [o for o in tsmoke.raw_overrides(tmp_path, 1)
             if not o.startswith(("+model.future_predictor.output_len", "data_eval.num_frames"))]
    lines += ["+model.future_predictor.output_len=3", "data_eval.num_frames=4"]
    path = tmp_path / "viz.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_viz_attention_maps_match_avt_tpu(clip_video, tmp_path):
    import jax

    from avt_tpu.config import Composer as JComposer
    from avt_tpu.config import parse_overrides_file as jparse_overrides_file
    from avt_tpu.config.build import build_model as jbuild_model
    from avt_tpu.config.build import build_preprocess_fns as jbuild_preprocess_fns
    from avt_tpu_torch.models.convert import params_from_jax

    expt = _viz_config(tmp_path)
    cfg = tviz.compose(expt)
    frames = tviz.decode_frames(clip_video, 0.5, 5.0, cfg["data_eval"]["num_frames"])
    jframes = jviz._decode_frames(clip_video, 0.5, 5.0, cfg["data_eval"]["num_frames"])
    np.testing.assert_array_equal(frames, jframes)

    jcfg = JComposer(str(ROOT / "conf")).compose("config", jparse_overrides_file(expt))
    jcfg["model"]["future_predictor"]["output_attentions"] = True
    _, jpp = jbuild_preprocess_fns(jcfg)
    video = jpp(jax.numpy.asarray(frames[None]))
    jm = jbuild_model(jcfg, {"action": 7}, class_mappings={})
    params = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0), video, (1,))
    jout, _ = jax.jit(jm.apply, static_argnums=2)(params, video, (1,))
    ckpt = tmp_path / "params.pth"
    torch.save({k: v.contiguous() for k, v in params_from_jax(params).items()}, ckpt)

    maps = tviz.attention_maps(cfg, frames, ckpt=str(ckpt), num_classes=7, device="cpu")
    assert list(maps) == ["gpt2_att_0", "gpt2_att_1", "gpt2_att_2"]
    for key, att in maps.items():
        want = np.asarray(jout[key])
        want = want.reshape((-1,) + want.shape[-4:])[0]
        assert att.shape == want.shape
        np.testing.assert_allclose(att, want, atol=TOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(att.sum(-1), 1.0, atol=1e-5)
    assert maps["gpt2_att_0"].shape == (2, 2, 4, 4)
    assert maps["gpt2_att_2"].shape == (2, 2, 1, 6)
    assert np.triu(maps["gpt2_att_0"], 1).max() == 0  # causal
    pytest.importorskip("matplotlib")
    written = tviz.render(maps, frames, str(tmp_path / "viz"))
    assert [Path(w).name for w in written] == [
        f"step{k}_{kind}.png" for k in range(3) for kind in ("heads", "overlay")]
    assert all(Path(w).stat().st_size > 0 for w in written)


def _jax_equal(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_jax_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_jax_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("mode", ["feature", "raw"])
def test_smoke_train_composes_in_both_modes_as_avt_tpu(tmp_path, mode):
    from avt_tpu.config import Composer as JComposer
    from avt_tpu.config import parse_override as jparse_override

    if mode == "raw":
        overrides = tsmoke.raw_overrides(tmp_path, 3)
        assert overrides == jsmoke.raw_overrides(tmp_path, 3)
    else:
        overrides = tsmoke.feature_overrides(tmp_path, 3)
    cfg = tsmoke.compose(overrides)
    jcfg = JComposer(str(ROOT / "conf")).compose("config",
                                                 [jparse_override(o) for o in overrides])
    assert _jax_equal(cfg, jcfg)
    assert cfg["train"]["num_epochs"] == 3


def test_smoke_train_feature_mode_trains_through_train_net(tmp_path, capsys):
    rc = tsmoke.main(["--epochs", "1", "--min-metric", "-1", "--workdir", str(tmp_path / "run")],
                     device="cpu")
    out = capsys.readouterr().out
    assert rc == 0 and "SMOKE OK" in out and "final primary metric" in out
    assert (tmp_path / "run" / "results").is_dir()
