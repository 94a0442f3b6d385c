"""The port's k-means (avt_tpu_torch/models/cluster.py) and
QuantizeAndCrossEntropy against avt_tpu's on the CPU: `KmeansAssigner` ids
and centroid features on well-separated centroids (so that rounding cannot
flip an argmin), the norm option and out-of-range ids; `load_centroids`
from .npy and torch files; `kmeans_fit` recovering blobs, reseeding empty
clusters, and its centroids against avt_tpu's on the same blobs, up to a
permutation; `quantize_and_cross_entropy` and the config wrapper, f32 at 2e-5
relative / 1e-5 absolute."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avt_tpu.losses import quantize_and_cross_entropy as jquantize_and_cross_entropy
from avt_tpu.models.cluster import KmeansAssigner as JKmeansAssigner
from avt_tpu.models.cluster import kmeans_fit as jkmeans_fit
from avt_tpu_torch.config.registry import instantiate
from avt_tpu_torch.losses import QuantizeAndCrossEntropy, quantize_and_cross_entropy
from avt_tpu_torch.models import KmeansAssigner, kmeans_fit, load_centroids

RTOL, ATOL = 2e-5, 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _blobs(rng, centers, n_per):
    return np.concatenate([c + 0.05 * rng.normal(size=(n_per, len(c))) for c in centers]
                          ).astype(np.float32)


def _separated(k=16, c=24):
    """k well-separated centroids and features near them."""
    cents = 5.0 * np.eye(k, c, dtype=np.float32) + 0.1 * _rand((k, c), 0)
    ids = np.random.default_rng(1).integers(0, k, size=(3, 7))
    return cents, cents[ids] + 0.1 * _rand((3, 7, c), 2), ids


@pytest.mark.parametrize("norm", [False, True])
def test_assigner_matches_avt_tpu(norm):
    cents, feats, ids = _separated()
    ours = KmeansAssigner(cents, norm=norm, device="cpu")
    ref = JKmeansAssigner(cents, norm=norm)
    got = ours(torch.from_numpy(feats))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(jnp.asarray(feats))))
    if not norm:
        np.testing.assert_array_equal(got.numpy(), ids)
    tid = torch.from_numpy(ids)
    np.testing.assert_array_equal(ours(tid).numpy(), np.asarray(ref(jnp.asarray(ids))))
    assert ours(tid).shape == (3, 7, 24) and ours.num_clusters == 16
    # an id out of range is clamped, as a JAX gather clamps
    far = np.array([[0, 15, 16, 400]])
    np.testing.assert_array_equal(ours.cluster2feat(torch.from_numpy(far)).numpy(),
                                  np.asarray(ref.cluster2feat(jnp.asarray(far))))


@pytest.mark.parametrize("form", ["npy", "weight", "tensor"])
def test_load_centroids(tmp_path, form):
    cents = _rand((5, 3), 3)
    path = tmp_path / ("c.npy" if form == "npy" else "c.pth")
    if form == "npy":
        np.save(path, cents)
    else:
        t = torch.from_numpy(cents)
        torch.save({"weight": t} if form == "weight" else t, path)
    np.testing.assert_array_equal(load_centroids(str(path)), cents)
    np.testing.assert_array_equal(KmeansAssigner(str(path), device="cpu").centroids.numpy(),
                                  cents)


def test_kmeans_fit_recovers_blobs():
    """Port counterpart of tests/test_tools.py's blob test: each true
    centre has a centroid within the blob scale, and each blob is one
    cluster."""
    rng = np.random.default_rng(0)
    true = np.array([[0.0, 0.0], [3.0, 3.0], [-3.0, 2.0]], np.float32)
    feats = _blobs(rng, true, 200)
    cents = kmeans_fit(feats, k=3, iters=20, seed=1, chunk=128, device="cpu")
    assert cents.dtype == np.float32 and cents.shape == (3, 2)
    d = np.linalg.norm(true[:, None] - cents[None], axis=-1)
    assert (d.min(axis=1) < 0.05).all(), d
    labels = KmeansAssigner(cents, device="cpu")(torch.from_numpy(feats)).numpy()
    for row in labels.reshape(3, 200):
        assert (row == row[0]).all()


def test_kmeans_fit_reseeds_empty_clusters():
    """k close to n on one blob: k finite, distinct centroids, each of
    them some point's nearest (no dead codeword)."""
    feats = _blobs(np.random.default_rng(2), np.zeros((1, 4), np.float32), 64)
    cents = kmeans_fit(feats, k=16, iters=5, seed=0, chunk=32, device="cpu")
    assert cents.shape == (16, 4) and np.isfinite(cents).all()
    d = np.linalg.norm(cents[:, None] - cents[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 0, "duplicate centroids survived reseeding"
    labels = KmeansAssigner(cents, device="cpu")(torch.from_numpy(feats)).numpy()
    assert set(labels.tolist()) == set(range(16)), "dead codewords"


@pytest.mark.parametrize("norm", [False, True])
def test_kmeans_fit_matches_avt_tpu_on_blobs(norm):
    """The same blobs through both fits: the same centroids up to a
    permutation (the two draw their seeds from different generators)."""
    rng = np.random.default_rng(4)
    true = 4.0 * np.eye(5, 8, dtype=np.float32) + 1.0
    feats = _blobs(rng, true, 80)
    ours = kmeans_fit(feats, k=5, iters=10, seed=3, norm=norm, chunk=100, device="cpu")
    ref = np.asarray(jkmeans_fit(feats, k=5, iters=10, seed=3, norm=norm, chunk=100))

    def order(c):
        return c[np.lexsort(c.T[::-1])]

    np.testing.assert_allclose(order(ours), order(ref), rtol=RTOL, atol=ATOL)


def test_kmeans_fit_refuses_more_clusters_than_rows():
    with pytest.raises(ValueError, match="k=5 > n=4"):
        kmeans_fit(np.zeros((4, 2), np.float32), k=5, device="cpu")


@pytest.mark.parametrize("norm", [True, False])
def test_quantize_and_cross_entropy_matches_avt_tpu(tmp_path, norm):
    """Normalised (or not) features scored against the centroids, the
    target the nearest centroid; per element, then through the config
    target the reference names, centroids read from a file."""
    cents, _, _ = _separated()
    inp, tgt = _rand((3, 7, 24), 5), _rand((3, 7, 24), 6)
    ref = jquantize_and_cross_entropy(jnp.asarray(inp), jnp.asarray(tgt), jnp.asarray(cents),
                                      norm=norm)
    got = quantize_and_cross_entropy(torch.from_numpy(inp), torch.from_numpy(tgt),
                                     torch.from_numpy(cents), norm=norm)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.save(tmp_path / "c.npy", cents)
    loss = instantiate({"_target_": "loss_fn.multidim_xentropy.QuantizeAndCrossEntropy",
                        "centroids_fpath": str(tmp_path / "c.npy"), "norm": norm},
                       reduction="mean")
    assert isinstance(loss, QuantizeAndCrossEntropy)
    np.testing.assert_allclose(loss(torch.from_numpy(inp), torch.from_numpy(tgt)).item(),
                               float(np.asarray(ref).mean()), rtol=RTOL, atol=ATOL)
