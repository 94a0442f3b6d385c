"""The port's train-time preprocessing (avt_tpu_torch/data/transforms.py
`VideoPreprocessor.train_fn`) against avt_tpu's on the CPU: JAX's random
draws are replayed from the key exactly as its train_fn makes them and fed to
the port's deterministic `train_crop`, whose output must match JAX's
`train_fn(frames, key)` (the fused antialiased resize+crop of
jax.image.scale_and_translate, the flip and the color jitter). The port's own
draws are checked for their ranges and shares."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avt_tpu.data import transforms as jtf
from avt_tpu_torch.data import transforms as ttf

CROP = 224
FRAMES = (3, 2, 256, 342, 3)  # bench.py's clips, 2 frames each
NORM = dict(mean=(0.5,) * 3, std=(0.5,) * 3)
# After (x/255 - 0.5)/0.5: f32, the same resampling summed in another order;
# bf16, two pixel units (bf16 weights and products, rounded at the same
# places, but summed in another order).
TOL = {"float32": 1e-4, "bfloat16": 2 / 127.5}


def _jax_draws(pp, key, shape):
    """JAX train_fn's per-clip draws, replayed from `key` (transforms.py
    per_clip: split(key, B), then split(clip key, 5), then the jitter's
    split(kc, 4))."""
    B, _, H, W, _ = shape
    smin, smax = jtf._parse_size(pp.scale_h)
    draws = {k: [] for k in ("s", "i", "j", "flip", "brightness", "contrast", "saturation",
                              "hue")}
    for key_b in jax.random.split(key, B):
        ks, ki, kj, kf, kc = jax.random.split(key_b, 5)
        s = jnp.floor(jax.random.uniform(ks, (), minval=smin, maxval=smax + 1.0))
        f = s / min(H, W)
        draws["s"].append(s)
        draws["i"].append(jnp.floor(jax.random.uniform(ki, ()) * jnp.maximum(H * f - CROP, 0)))
        draws["j"].append(jnp.floor(jax.random.uniform(kj, ()) * jnp.maximum(W * f - CROP, 0)))
        draws["flip"].append(jax.random.uniform(kf, ()) < pp.flip_p)
        b, c, sat, hue = pp.jitter
        for name, k, lo, hi in zip(("brightness", "contrast", "saturation", "hue"),
                                   jax.random.split(kc, 4),
                                   (max(0.0, 1 - b), max(0.0, 1 - c), max(0.0, 1 - sat), -hue),
                                   (1 + b, 1 + c, 1 + sat, hue)):
            draws[name].append(jax.random.uniform(k, (), minval=lo, maxval=hi))
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items() if k in ("s", "i", "j",
                                                                                  "flip")}
    for name, v in zip(("brightness", "contrast", "saturation", "hue"), pp.jitter):
        if v > 0:
            out[name] = torch.from_numpy(np.asarray(draws[name]))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_h,jitter", [
    pytest.param("248-280", (0.0,) * 4, id="down-and-up"),
    pytest.param(256, (0.0,) * 4, id="identity"),
    pytest.param("248-280", (0.4, 0.4, 0.4, 0.1), id="jitter"),
])
def test_train_crop_matches_jax_train_fn(scale_h, jitter, dtype):
    frames = np.random.default_rng(0).integers(0, 256, size=FRAMES, dtype=np.uint8)
    kw = dict(crop_size=CROP, scale_h=scale_h, scale_w=-1, flip_p=0.5, **NORM,
              **dict(zip(("color_jitter_brightness", "color_jitter_contrast",
                          "color_jitter_saturation", "color_jitter_hue"), jitter)))
    jpp = jtf.VideoPreprocessor(**kw, compute_dtype=getattr(jnp, dtype))
    tpp = ttf.VideoPreprocessor(**kw, compute_dtype=getattr(torch, dtype), device="cpu")
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jpp.train_fn(jnp.asarray(frames), key), np.float32)
    draws = _jax_draws(jpp, key, FRAMES)
    if scale_h == "248-280":  # the draws cover down- and up-scaling
        assert draws["s"].min() < 256 < draws["s"].max()
    out = tpp.train_crop(torch.from_numpy(frames), **draws)
    assert out.shape == ref.shape == (FRAMES[0], 3, FRAMES[1], CROP, CROP)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=0)


def test_train_draws_ranges_and_flip_share():
    pp = ttf.VideoPreprocessor(crop_size=CROP, scale_h="248-280", flip_p=0.3,
                               color_jitter_brightness=0.4, color_jitter_hue=0.1, device="cpu")
    B, H, W = 4000, 256, 342
    d = pp.train_draws((B, 1, H, W, 3), torch.Generator().manual_seed(0))
    s = d["s"]
    assert torch.equal(s, s.floor()) and s.min() == 248 and s.max() == 280
    for name, side in (("i", H), ("j", W)):
        x = d[name]
        assert torch.equal(x, x.floor()) and (x >= 0).all()
        assert (x <= torch.clamp_min(side * s / H - CROP, 0)).all()
    assert abs(d["flip"].float().mean().item() - 0.3) < 0.03
    assert d["brightness"].min() >= 0.6 and d["brightness"].max() <= 1.4
    assert d["hue"].abs().max() <= 0.1
    assert "contrast" not in d and "saturation" not in d
    again = pp.train_draws((B, 1, H, W, 3), torch.Generator().manual_seed(0))
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_train_fn_shape_and_flip():
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(2, 2, 64, 86, 3), dtype=np.uint8))
    pp = ttf.VideoPreprocessor(crop_size=56, scale_h=64, flip_p=0.0, device="cpu", **NORM)
    out = pp.train_fn(frames, torch.Generator().manual_seed(0))
    assert out.shape == (2, 3, 2, 56, 56) and out.dtype == torch.float32
    d = pp.train_draws(frames.shape, torch.Generator().manual_seed(0))
    flipped = pp.train_crop(frames, d["s"], d["i"], d["j"], torch.ones(2, dtype=torch.bool))
    torch.testing.assert_close(flipped, out.flip(-1))


# conf/data/default.yaml's train form, the reference's Resize((h, w)) before
# its random crop, at a small size: a fixed scale_w other than scale_h
FIXED_W = dict(crop_size=28, scale_h=32, scale_w=44, flip_p=0.5, **NORM)


def _per_axis_reference(frames, pp, s, i, j, flip, dtype):
    """Each clip resized to (s, scale_w), each side by its own factor, and
    cropped at (i, j) by jax.image.scale_and_translate with scale (s / H,
    scale_w / W) and translation (-i, -j), then /255, the flip and the
    normalisation: (B, 3, T, crop, crop)."""
    B, T, H, W, _ = frames.shape
    cs, dt = pp.crop_size, getattr(jnp, dtype)
    out = []
    for b in range(B):
        x = jax.image.scale_and_translate(
            jnp.asarray(frames[b]).astype(dt), shape=(T, cs, cs, 3), spatial_dims=(1, 2),
            scale=jnp.array([np.float32(s[b]) / H, np.float32(pp.scale_w / W)], dt),
            translation=jnp.array([-i[b], -j[b]], dt), method="linear")
        x = np.asarray(x, np.float32) / 255.0
        if flip[b]:
            x = x[:, :, ::-1]
        out.append(((x - 0.5) / 0.5).transpose(3, 0, 1, 2))
    return np.stack(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames_shape", [
    pytest.param((2, 2, 40, 64, 3), id="down"),
    pytest.param((2, 2, 24, 40, 3), id="up"),
])
def test_train_crop_with_a_fixed_scale_w_matches_a_per_axis_reference(frames_shape, dtype):
    """Non-square frames resized to (scale_h, scale_w) = (32, 44), down or
    up on both sides by different factors, and cropped at offsets other than
    0 on both axes, one clip flipped."""
    frames = np.random.default_rng(4).integers(0, 256, size=frames_shape, dtype=np.uint8)
    pp = ttf.VideoPreprocessor(**FIXED_W, compute_dtype=getattr(torch, dtype), device="cpu")
    s, i, j, flip = [32.0, 32.0], [3.0, 1.0], [11.0, 6.0], [False, True]
    out = pp.train_crop(torch.from_numpy(frames), torch.tensor(s), torch.tensor(i),
                        torch.tensor(j), torch.tensor(flip))
    ref = _per_axis_reference(frames, pp, s, i, j, flip, dtype)
    assert out.shape == ref.shape == (2, 3, 2, 28, 28)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=0)


def test_train_draws_with_a_fixed_scale_w():
    """The crop offsets range over the resized (scale_h, scale_w) frame:
    i below scale_h - crop, j below scale_w - crop."""
    pp = ttf.VideoPreprocessor(**FIXED_W, device="cpu")
    d = pp.train_draws((4000, 1, 40, 64, 3), torch.Generator().manual_seed(0))
    assert (d["s"] == 32).all()
    for name, span in (("i", 32 - 28), ("j", 44 - 28)):
        x = d[name]
        assert torch.equal(x, x.floor()) and x.min() == 0 and x.max() == span - 1, name


# the reference's exported transforms no shipped pipeline wires in:
# resized_crop_bilinear_torch (a run-time box), random_resized_crop,
# temporal_center_crop and unfold_clips, against avt_tpu's
BOXES = [(3, 5, 20, 30, 16, 16), (0, 0, 37, 53, 24, 24), (10, 40, 7, 13, 32, 8),
         (36, 52, 1, 1, 8, 8)]


@pytest.mark.parametrize("box", BOXES, ids=lambda b: "x".join(map(str, b)))
def test_resized_crop_bilinear_matches_avt_tpu(box):
    """A traced box in JAX (jit), ints in the port: down, whole, up on one
    axis and down on the other, a 1x1 box."""
    x = np.random.default_rng(5).integers(0, 256, size=(2, 37, 53, 3)).astype(np.float32)
    i, j, h, w, oh, ow = box
    fn = jax.jit(lambda a, ii, jj, hh, ww: jtf.resized_crop_bilinear_torch(a, ii, jj, hh, ww,
                                                                           oh, ow))
    ref = np.asarray(fn(jnp.asarray(x), i, j, h, w))
    out = ttf.resized_crop_bilinear_torch(torch.from_numpy(x), i, j, h, w, oh, ow)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4 * 255, rtol=0)


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="defaults"),
    pytest.param(dict(scale=(1.0, 1.0), ratio=(1.0, 1.0)), id="whole-image"),
    pytest.param(dict(ratio=(50.0, 60.0)), id="no-fit-fallback"),
    pytest.param(dict(scale=(0.5, 0.9), ratio=(0.5, 2.0)), id="wide-ratio"),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_resized_crop_box_and_crop_match_avt_tpu(kw, seed):
    """JAX's draws replayed from its key (split(rng, 4): area, log ratio,
    the two offsets) through the port's `random_resized_crop_box`: the same
    box exactly, and the crop against JAX's `random_resized_crop`."""
    x = np.random.default_rng(seed).random((3, 32, 48, 3)).astype(np.float32)
    scale, ratio = kw.get("scale", (0.08, 1.0)), kw.get("ratio", (3.0 / 4.0, 4.0 / 3.0))
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = np.asarray(jax.random.uniform(k1, (10,), minval=scale[0], maxval=scale[1]))
    log_ratio = np.asarray(jax.random.uniform(k2, (10,), minval=float(np.log(ratio[0])),
                                              maxval=float(np.log(ratio[1]))))
    u_i, u_j = float(jax.random.uniform(k3, ())), float(jax.random.uniform(k4, ()))
    box = ttf.random_resized_crop_box(32, 48, torch.tensor(area), torch.tensor(log_ratio),
                                      u_i, u_j, ratio)
    # JAX's box, recomputed from the same draws with its own operations
    ar = jnp.exp(jnp.asarray(log_ratio))
    target = jnp.asarray(area) * float(32 * 48)
    ws = np.asarray(jnp.round(jnp.sqrt(target * ar)).astype(jnp.int32))
    hs = np.asarray(jnp.round(jnp.sqrt(target / ar)).astype(jnp.int32))
    valid = (ws > 0) & (ws <= 48) & (hs > 0) & (hs <= 32)
    if valid.any():
        p = int(np.argmax(valid))
        h, w = int(hs[p]), int(ws[p])
        want = (int(np.clip(np.floor(np.float32(u_i) * (32 - h + 1)), 0, 32 - h)),
                int(np.clip(np.floor(np.float32(u_j) * (48 - w + 1)), 0, 48 - w)), h, w)
    elif 48 / 32 < ratio[0]:
        h = max(1, int(round(48 / ratio[0])))
        want = ((32 - h) // 2, 0, h, 48)
    else:
        w = max(1, int(round(32 * ratio[1]))) if 48 / 32 > ratio[1] else 48
        want = (0, (48 - w) // 2, 32, w)
    assert box == want
    ref = np.asarray(jtf.random_resized_crop(jnp.asarray(x), key, 16, **kw))
    out = ttf.resized_crop_bilinear_torch(torch.from_numpy(x), *box, 16, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)


def test_random_resized_crop_draws_its_own_box():
    """The port's draws: one box for every frame, the output's shape and
    range, a seeded generator repeats itself, and a whole-image box equals
    the plain resize."""
    x = torch.rand(4, 32, 48, 3)
    out = ttf.random_resized_crop(x, 16, generator=torch.Generator().manual_seed(3))
    again = ttf.random_resized_crop(x, 16, generator=torch.Generator().manual_seed(3))
    assert out.shape == (4, 16, 16, 3) and torch.equal(out, again)
    assert out.min() >= x.min() - 1e-6 and out.max() <= x.max() + 1e-6
    sq = x[:, :, :32]
    whole = ttf.random_resized_crop(sq, 16, scale=(1.0, 1.0), ratio=(1.0, 1.0),
                                    generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(whole, ttf.resize_bilinear_torch(sq, 16, 16), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,L", [(10, 4), (11, 4), (10, 3), (9, 5), (4, 4), (3, 8)])
def test_temporal_center_crop_matches_avt_tpu(T, L):
    clip = np.random.default_rng(T * 10 + L).random((2, 3, T, 4, 5)).astype(np.float32)
    ref = np.asarray(jtf.temporal_center_crop(jnp.asarray(clip), L))
    out = ttf.temporal_center_crop(torch.from_numpy(clip), L).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("T,L,overlap", [(12, 4, 1.0), (13, 4, 0.5), (3, 4, 1.0), (8, 8, 0.25)])
def test_unfold_clips_matches_avt_tpu(T, L, overlap):
    clip = np.random.default_rng(T + L).random((3, T, 4, 5)).astype(np.float32)
    ref = np.asarray(jtf.unfold_clips(jnp.asarray(clip), L, overlap))
    out = ttf.unfold_clips(torch.from_numpy(clip), L).numpy()  # avt_tpu ignores overlap
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
