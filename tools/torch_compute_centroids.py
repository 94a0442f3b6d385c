#!/usr/bin/env python
"""Fit k-means centroids over stored features -> .npy for KmeansAssigner,
through the PyTorch port (`avt_tpu_torch.models.cluster.kmeans_fit`, on
the GPU unless AVT_PLATFORM=cpu or main(..., device="cpu") asks for the
CPU).

The counterpart of tools/compute_centroids.py. Feature sources:

  * .npy file(s): (N, C) or (N, T, C) arrays (per-video RULSTM-style dumps
    are concatenated over files). Rows that are all NaN, the missing frames
    of a sparse store that tools/torch_extract_features.py packed, are
    dropped;
  * an LMDB feature-store directory (as LMDBFeatsReader reads it): every
    value is one frame's (C,) feature.

Usage:
  python tools/torch_compute_centroids.py feats1.npy feats2.npy -k 1024 -o cent.npy
  python tools/torch_compute_centroids.py DATA/rulstm_feats/rgb --lmdb -k 512 \\
      --max-samples 2000000 --norm -o centroids.npy

The output loads through avt_tpu_torch.models.cluster.load_centroids /
KmeansAssigner (and the model.future_predictor quantized configs).
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _load_npy(paths):
    arrs = []
    for p in paths:
        a = np.load(p, mmap_mode="r")
        a = np.asarray(a).reshape(-1, a.shape[-1])
        arrs.append(a[~np.isnan(a).all(axis=1)])
    return np.concatenate(arrs, axis=0)


def _load_lmdb(path):
    import lmdb  # only an LMDB source needs it

    env = lmdb.open(str(path), readonly=True, lock=False, max_readers=256)
    rows = []
    with env.begin() as txn:
        for _, val in txn.cursor():
            rows.append(np.frombuffer(val, dtype=np.float32))
    return np.stack(rows)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sources", nargs="+", help=".npy files or an LMDB dir")
    ap.add_argument("--lmdb", action="store_true",
                    help="treat the (single) source as an LMDB store dir")
    ap.add_argument("-k", type=int, required=True, help="number of centroids")
    ap.add_argument("-o", "--output", required=True, help="output .npy")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--norm", action="store_true",
                    help="l2-normalize features before clustering (match KmeansAssigner(norm=True))")
    ap.add_argument("--max-samples", type=int, default=None,
                    help="random subsample cap before fitting")
    args = ap.parse_args(argv)

    from avt_tpu_torch.models.cluster import kmeans_fit
    from avt_tpu_torch.train_net import platform_device

    if args.lmdb:
        assert len(args.sources) == 1, "--lmdb takes one store directory"
        feats = _load_lmdb(args.sources[0])
    else:
        feats = _load_npy(args.sources)
    if args.max_samples and len(feats) > args.max_samples:
        rng = np.random.default_rng(args.seed)
        feats = feats[rng.choice(len(feats), size=args.max_samples, replace=False)]
    print(f"# fitting k={args.k} on {feats.shape} features", file=sys.stderr)
    centroids = kmeans_fit(feats, args.k, iters=args.iters, seed=args.seed, norm=args.norm,
                           device=platform_device(device))
    np.save(args.output, centroids)
    print(f"# wrote {centroids.shape} centroids to {args.output}", file=sys.stderr)
    return centroids


if __name__ == "__main__":
    main()
