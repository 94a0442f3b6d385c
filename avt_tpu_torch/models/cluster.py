"""K-means centroids: fitting, loading and assignment.

Counterpart of avt_tpu/models/cluster.py (`load_centroids`, `kmeans_fit`,
`KmeansAssigner`), the reference's common/cluster.py: a float input maps to
its nearest centroid's id, an integer input to that centroid's feature.
Centroids load from a .npy file or a torch file ({'weight': K x C} or the
bare array). `kmeans_fit` runs on the device (CUDA unless device="cpu" is
asked for), as the JAX package's runs on the TPU.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from avt_tpu_torch.utils.device import resolve_device


def load_centroids(fpath: str) -> np.ndarray:
    """(K, C) centroids from a .npy file or a torch file."""
    if str(fpath).endswith(".npy"):
        return np.load(fpath)
    obj = torch.load(fpath, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "weight" in obj:
        obj = obj["weight"]
    return obj.numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _seed_plus_plus(sub: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding over the rows of `sub`, each next centre drawn with
    probability proportional to its squared distance to the nearest centre
    so far; stays on the device (no host sync a draw)."""
    first = torch.randint(0, sub.shape[0], (1,), generator=generator, device=sub.device)
    centers = sub.new_zeros((k, sub.shape[1]))
    centers[0] = sub[first][0]
    d2 = ((sub - sub[first]) ** 2).sum(dim=-1)
    for i in range(1, k):
        idx = torch.multinomial(d2.clamp_min(1e-30), 1, generator=generator)
        nxt = sub[idx]  # (1, C)
        centers[i] = nxt[0]
        d2 = torch.minimum(d2, ((sub - nxt) ** 2).sum(dim=-1))
    return centers


def _lloyd(chunks, cents: torch.Tensor):
    """One Lloyd iteration over the (chunk, C) feature blocks: the new
    centres (an empty cluster keeps its old one), the cluster sizes, and
    each chunk's farthest point from its centre by the full squared
    distance |f|^2 + |c|^2 - 2 f.c, farthest first (the reseed
    candidates)."""
    k, c = cents.shape
    sums = cents.new_zeros((k, c))
    counts = cents.new_zeros((k,))
    far_pts, far_d = [], []
    cn2 = (cents ** 2).sum(dim=-1)
    for f in chunks:
        d = cn2[None] - 2.0 * (f @ cents.T)
        dmin, lab = d.min(dim=-1)
        sums.index_add_(0, lab, f)
        counts += torch.bincount(lab, minlength=k).to(counts.dtype)
        full = (f ** 2).sum(dim=-1) + dmin
        far = full.argmax().reshape(1)
        far_pts.append(f.index_select(0, far)[0])
        far_d.append(full.index_select(0, far)[0])
    new = torch.where((counts > 0)[:, None], sums / counts.clamp_min(1)[:, None], cents)
    order = torch.argsort(-torch.stack(far_d))
    return new, counts, torch.stack(far_pts)[order]


def kmeans_fit(feats: np.ndarray, k: int, iters: int = 50, seed: int = 0, norm: bool = False,
               chunk: int = 65536, device=None) -> np.ndarray:
    """Lloyd's k-means on (N, C) features -> (k, C) f32 centroids.

    The features go to the device once; k-means++ seeds from a subsample of
    max(64 k, 4096) rows (numpy's generator from `seed` picks it, a torch
    generator from `seed` draws the centres); each iteration takes the
    distance products a chunk of rows at a time and sums each cluster's
    rows with a scatter-add, and only the cluster sizes come to the host.
    An empty cluster is reseeded at a chunk's farthest point (at most one
    a chunk an iteration); after the last iteration up to 5 more rounds run
    while any cluster was empty, so that no raw or stale row is returned."""
    device = resolve_device(device)
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    n, c = feats.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    rng = np.random.default_rng(seed)
    chunk = min(chunk, max(n, 1))
    fdev = torch.from_numpy(feats).to(device)
    if norm:
        fdev = _l2_normalize(fdev)
    chunks = fdev.split(chunk)

    sub_n = int(min(n, max(k * 64, 4096)))
    sub = fdev[torch.from_numpy(rng.choice(n, size=sub_n, replace=False)).to(device)]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    cents = _seed_plus_plus(sub, k, generator)

    def step(cents):
        cents, counts, far_pts = _lloyd(chunks, cents)
        empty = torch.nonzero(counts == 0).flatten()
        m = min(int(empty.numel()), far_pts.shape[0])  # the iteration's one host sync
        if m:
            cents = cents.index_copy(0, empty[:m], far_pts[:m])
        return cents, int(empty.numel())

    n_empty = 0
    for _ in range(iters):
        cents, n_empty = step(cents)
    for _ in range(5):
        if n_empty == 0:
            break
        cents, n_empty = step(cents)
    return cents.cpu().numpy()


class KmeansAssigner:
    """Nearest-centroid ids of features, and centroid features of ids.
    `centroids`: a (K, C) array or a file for `load_centroids`; `norm`
    L2-normalises the features before they are assigned."""

    def __init__(self, centroids: Union[str, np.ndarray, torch.Tensor], norm: bool = False,
                 device=None):
        if isinstance(centroids, str):
            centroids = load_centroids(centroids)
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                         device=resolve_device(device))  # (K, C)
        self.norm = norm

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    def feat2cluster(self, feats: torch.Tensor) -> torch.Tensor:
        """argmin_k |f - c_k|^2, as argmin(|c|^2 - 2 f.c): (...,) ids."""
        flat = feats.reshape(-1, feats.shape[-1]).float()
        if self.norm:
            flat = _l2_normalize(flat)
        d = (self.centroids ** 2).sum(dim=-1)[None] - 2.0 * (flat @ self.centroids.T)
        return d.argmin(dim=-1).reshape(feats.shape[:-1])

    def cluster2feat(self, idx: torch.Tensor) -> torch.Tensor:
        """The centroids of ids (...,) -> (..., C). An id out of range is
        clamped into it, as a JAX gather clamps."""
        K = self.num_clusters
        idx = torch.where(idx < 0, idx + K, idx).clamp(0, K - 1)
        return self.centroids[idx.reshape(-1)].reshape(tuple(idx.shape) + (-1,))

    def __call__(self, inp: torch.Tensor) -> torch.Tensor:
        if not inp.is_floating_point():
            return self.cluster2feat(inp)
        return self.feat2cluster(inp)
