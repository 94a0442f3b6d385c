"""Feature extraction through the PyTorch port: raw video -> backbone
features on the GPU -> a RULSTM-layout store.

The counterpart of tools/extract_features.py, on `avt_tpu_torch`:
  1. dense-sample clips over whole videos (`dense_clip_sampler`),
  2. run the model in feature-extraction mode (`avt_tpu_torch.train_net`
     with eval.eval_fn.only_run_featext) and dump each rank's endpoint rows
     to the npz result sink (<run-dir>/results/<rank>/<n>.npz),
  3. pack those rows into the stores the feature readers consume: an LMDB
     keyed '<video>_frame_%010d.jpg' (the RULSTM layout, read by
     LMDBFeatsReader) and/or per-video .npy shards (NpyFeatsReader),
so that an expts/02-style AVT-h config trains from its own features.

Frame keying follows the RULSTM convention the readers assume: the feature
of the dense clip ending at t seconds is stored at frame floor(t * fps),
fps = RULSTM_TSN_FPS (30). A stride coarser than a frame period leaves gaps
that the readers fill by their backward search (radius 10).

Under a launcher (RANK, WORLD_SIZE, ... set; `shard_per_worker` splits the
videos) every rank extracts its share, and rank 0 packs after a barrier.
Extraction runs on the GPU; main(..., device="cpu") or AVT_PLATFORM=cpu
asks for the CPU.

Usage:
  python tools/torch_extract_features.py -c expts/01_ek100_avt.txt \\
      --out DATA/extracted_features/my_avtb --stride 0.25 --clip-len 1.0 \\
      model/temporal_aggregator=mean
  # pack only, from an existing featext run directory:
  python tools/torch_extract_features.py --pack-only --run-dir OUTPUTS/x/0 \\
      --out DATA/extracted_features/my_avtb
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from avt_tpu_torch.data.anticipation import RULSTM_TSN_FPS  # noqa: E402
from avt_tpu_torch.parallel import ddp  # noqa: E402
from avt_tpu_torch.utils.logging import get_logger  # noqa: E402

INDEX_NAME = "featext_index.csv"
RESULTS_DIR = "results"
FORMATS = ("npy", "lmdb")  # the stores `pack` writes


def _yaml_quoted(text: str) -> str:
    """`text` as a single-quoted YAML scalar ('' stands for '), which a flow
    mapping reads whole, commas, colons and braces included."""
    return "'" + text.replace("'", "''") + "'"


def parse_formats(text: str) -> Tuple[str, ...]:
    """The --formats list: comma-separated, blanks around each name
    stripped; a name outside FORMATS raises SystemExit naming it."""
    formats = tuple(f.strip() for f in text.split(","))
    bad = [f for f in formats if f not in FORMATS]
    if bad:
        raise SystemExit(f"--formats {text!r}: {bad} not among {list(FORMATS)}")
    return formats


def _featext_overrides(args, *, shard: bool = True, resume: Optional[bool] = None) -> List[str]:
    """Overrides that put any config into feature-extraction mode."""
    resume = bool(args.resume) if resume is None else resume
    results_dir = _yaml_quoted(os.path.join(args.run_dir, RESULTS_DIR))
    dense = (
        "{_target_: datasets.base_video_dataset.dense_clip_sampler, "
        f"clip_len: {args.clip_len}, stride: {args.stride}, keep_orig_clips: false, "
        f"featext_skip_done: {str(resume).lower()}, "
        f"featext_results_dir: {results_dir}, "
        f"shard_per_worker: {str(shard).lower()}}}"
    )
    return [
        "test_only=true",
        "eval.eval_fn.only_run_featext=true",
        f"eval.eval_fn.store_endpoint={args.endpoint}",
        "eval.eval_fn.store=true",
        # the raw dense windows, not anticipation-shifted ones, which carry
        # no segment labels (the JAX tool leaves them on, and a config with
        # classifier_on_past, expts/01 for one, then fails on the first batch)
        "dataset_eval.conv_to_anticipate_fn=null",
        "data_eval.load_seg_labels=false",
        f"+dataset_eval.sample_clips_densely_fn={dense}",
    ]


def compose_cfg(config_file: Optional[str], overrides: List[str], args, conf_dir: str,
                for_index: bool = False) -> Dict:
    """The config of the extraction. for_index: the whole dataset, unsharded
    and without the resume's skips, so that every rank's pack sees the same
    uid -> frame map."""
    from avt_tpu_torch.config import Composer, expand_sweeps, parse_override, \
        parse_overrides_file

    parsed = parse_overrides_file(config_file) if config_file else []
    parsed += [parse_override(o) for o in overrides]
    extra = _featext_overrides(args, shard=not for_index,
                               resume=False if for_index else None)
    parsed += [parse_override(o) for o in extra]
    variants = expand_sweeps(parsed)
    if len(variants) > 1:
        raise SystemExit(f"config expands to {len(variants)} sweep variants; feature "
                         "extraction needs exactly one — pin the sweep keys")
    return Composer(conf_dir).compose("config", variants[0])


def write_index(cfg: Dict, run_dir: str, logger) -> str:
    """The uid -> (video_stem, end_sec) map of the dense eval dataset, from
    the dataset's own table (not parsed back from uid strings, so that other
    uid schemes stay packable)."""
    from avt_tpu_torch.config.build import build_dataset

    ds = build_dataset(cfg["dataset_eval"], cfg["data_eval"])
    index_path = os.path.join(run_dir, INDEX_NAME)
    with open(index_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["uid", "video_stem", "end"])
        for uid, path, end in zip(ds.df["uid"], ds.df["video_path"], ds.df["end"]):
            w.writerow([uid, Path(path).stem, float(end)])
    logger.info("Wrote %d-row index -> %s", len(ds.df), index_path)
    return index_path


def read_index(index_path: str) -> Dict[str, Tuple[str, float]]:
    out = {}
    with open(index_path, newline="") as f:
        for row in csv.DictReader(f):
            out[row["uid"]] = (row["video_stem"], float(row["end"]))
    return out


def frame_id_for_time(end_sec: float, fps: float = RULSTM_TSN_FPS) -> int:
    """The store's key frame of a clip ending at end_sec: floor(t * fps),
    at least 1, the floor the readers apply to timestamps, so that a
    read at the exact time hits the exact key."""
    return max(1, int(np.floor(end_sec * fps)))


def _result_files(results_dir: str) -> List[str]:
    """Every npz of the sink, ranks in numeric order (10 after 2, so that a
    later row wins as it was appended), each rank's files in order."""
    rank_dirs = [d for d in glob.glob(os.path.join(results_dir, "*")) if os.path.isdir(d)]
    rank_dirs.sort(key=lambda p: ((0, int(Path(p).name)) if Path(p).name.isdigit()
                                  else (1, Path(p).name)))
    files = [f for d in rank_dirs for f in sorted(glob.glob(os.path.join(d, "*.npz")))]
    if not files:
        raise FileNotFoundError(f"no npz result files in {results_dir}")
    return files


def _endpoint_key(keys, resfile: str, endpoint: str) -> str:
    found = [k for k in keys if k.startswith(endpoint)]
    if not found:
        raise KeyError(f"{resfile} stores {sorted(keys)}, no '{endpoint}*' — pass --endpoint "
                       "matching the extraction's store_endpoint")
    return endpoint if endpoint in found else found[0]


def _npz_shape(resfile: str, key: str) -> Tuple[int, ...]:
    """The shape of one array of an npz, from its header alone."""
    with zipfile.ZipFile(resfile) as zf, zf.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return read(f)[0]


def _decode_uid(uid) -> str:
    return uid.decode() if isinstance(uid, bytes) else str(uid)


def _locate_rows(resfiles, index, endpoint, store_fps):
    """Pass 1 over the result files: uids only, no features in memory.

    Returns (per_video: stem -> [(file_i, row_i, frame_id)], feat_dim,
    n_rows, n_skip). A later row for the same frame id wins, as in a
    resumed extraction's append order."""
    per_video: Dict[str, List[Tuple[int, int, int]]] = {}
    n_rows = n_skip = 0
    feat_dim = None
    for fi, resfile in enumerate(resfiles):
        with np.load(resfile) as data:
            key = _endpoint_key(data.files, resfile, endpoint)
            uids = data["uid"]
        shape = _npz_shape(resfile, key)
        if len(shape) != 2:
            raise ValueError(
                f"endpoint '{endpoint}' stores {tuple(shape[1:])}-shaped rows; per-frame stores "
                "need one vector per clip — extract an aggregated endpoint (temp_agg with a "
                "mean/transformer aggregator, or backbone_mean)")
        if feat_dim is None:
            feat_dim = int(shape[1])
        elif int(shape[1]) != feat_dim:
            raise ValueError(f"{resfile} feature width {shape[1]} != {feat_dim}")
        for ri, uid in enumerate(uids):
            uid = _decode_uid(uid)
            if uid not in index:
                n_skip += 1
                continue
            stem, end = index[uid]
            per_video.setdefault(stem, []).append((fi, ri, frame_id_for_time(end, store_fps)))
            n_rows += 1
    return per_video, feat_dim, n_rows, n_skip


def _gather_video(resfiles, endpoint, locs, feat_dim) -> np.ndarray:
    """(max_frame, C) float32 for ONE video, NaN rows where missing."""
    max_fid = max(fid for _, _, fid in locs)
    arr = np.full((max_fid, feat_dim), np.nan, dtype=np.float32)
    by_file: Dict[int, List[Tuple[int, int]]] = {}
    for fi, ri, fid in locs:
        by_file.setdefault(fi, []).append((ri, fid))
    for fi in sorted(by_file):
        with np.load(resfiles[fi]) as data:
            rows = data[_endpoint_key(data.files, resfiles[fi], endpoint)]
        for ri, fid in by_file[fi]:
            arr[fid - 1] = rows[ri]
    return arr


def _open_lmdb_store(lmdb_dir: str, nbytes: int, logger):
    """An LMDB environment to write the store into, or None (with a warning)
    when the lmdb module is not installed: the npy shards carry the same
    features."""
    try:
        import lmdb
    except ImportError:
        logger.warning("lmdb module unavailable; skipping the LMDB store (npy shards carry the "
                       "same features)")
        return None
    os.makedirs(lmdb_dir, exist_ok=True)
    return lmdb.open(lmdb_dir, map_size=max(nbytes * 4, 1 << 24))


def pack(results_dir: str, index: Dict[str, Tuple[str, float]], out_dir: str, *,
         endpoint: str = "temp_agg", formats: Tuple[str, ...] = FORMATS,
         store_fps: float = RULSTM_TSN_FPS, logger=None) -> Dict[str, int]:
    """Pack the featext result files into reader-consumable stores.

    npy: <out>/npy/<stem>.npy, (max_frame, C) float32, NaN rows missing
         (NpyFeatsReader's sparse-store convention).
    lmdb: <out>/lmdb/, '<stem>_frame_%010d.jpg' -> float32 bytes (the RULSTM
          layout LMDBFeatsReader reads).
    Memory holds ONE video's features: pass 1 reads uids only, pass 2
    gathers one video at a time. Returns {"rows", "skipped" (not in the
    index), "videos"}."""
    logger = logger or get_logger("torch_extract_features")
    resfiles = _result_files(results_dir)
    per_video, feat_dim, n_rows, n_skip = _locate_rows(resfiles, index, endpoint, store_fps)
    if not per_video:
        raise ValueError(f"nothing packable: {n_rows} rows matched the index, {n_skip} skipped")
    npy_dir = os.path.join(out_dir, "npy") if "npy" in formats else None
    if npy_dir:
        os.makedirs(npy_dir, exist_ok=True)
    env = None
    if "lmdb" in formats:
        env = _open_lmdb_store(os.path.join(out_dir, "lmdb"), n_rows * (feat_dim * 4 + 64),
                               logger)
    for stem, locs in per_video.items():
        arr = _gather_video(resfiles, endpoint, locs, feat_dim)
        if npy_dir:
            np.save(os.path.join(npy_dir, f"{stem}.npy"), arr)
        if env is not None:
            present = np.flatnonzero(~np.isnan(arr).all(axis=1))
            with env.begin(write=True) as txn:
                for fid0 in present:
                    txn.put(f"{stem}_frame_{fid0 + 1:010d}.jpg".encode("utf-8"),
                            np.ascontiguousarray(arr[fid0]).tobytes())
    if env is not None:
        env.close()
        logger.info("lmdb store: %d videos -> %s", len(per_video), os.path.join(out_dir, "lmdb"))
    if npy_dir:
        logger.info("npy store: %d videos -> %s", len(per_video), npy_dir)
    return {"rows": n_rows, "skipped": n_skip, "videos": len(per_video)}


def _store_readers(out_dir: str):
    """The readers of the stores under out_dir: npy always, LMDB when its
    directory is there and the lmdb module imports."""
    from avt_tpu_torch.data.readers import LMDBFeatsReader, NpyFeatsReader

    readers = []
    npy_dir = os.path.join(out_dir, "npy")
    if os.path.isdir(npy_dir):
        readers.append(("npy", NpyFeatsReader(npy_dir, read_type="normal",
                                              warn_if_using_closeby_frame=False)))
    lmdb_dir = os.path.join(out_dir, "lmdb")
    if os.path.isdir(lmdb_dir):
        try:
            readers.append(("lmdb", LMDBFeatsReader(lmdb_dir, read_type="normal",
                                                    warn_if_using_closeby_frame=False)))
        except ImportError:
            pass
    return readers


def verify_roundtrip(results_dir: str, index: Dict[str, Tuple[str, float]], out_dir: str, *,
                     endpoint: str, n_check: Optional[int] = 16,
                     store_fps: float = RULSTM_TSN_FPS, logger=None) -> int:
    """Read n_check features (None: every stored one) back through the
    readers and hold them bit for bit against the extracted rows. Returns
    the number of readbacks."""
    logger = logger or get_logger("torch_extract_features")
    resfiles = _result_files(results_dir)
    # the last (file, row) of each STORE KEY (stem, frame id): the row pack
    # kept (a superseding re-extraction, or two uids flooring to one frame)
    locs: Dict[Tuple[str, int], Tuple[str, int, int]] = {}
    for fi, resfile in enumerate(resfiles):
        with np.load(resfile) as data:
            uids = data["uid"]
        for ri, uid in enumerate(uids):
            uid = _decode_uid(uid)
            if uid in index:
                stem, end = index[uid]
                locs[(stem, frame_id_for_time(end, store_fps))] = (uid, fi, ri)
    loc_items = list(locs.values())
    if n_check is None:
        picks = range(len(loc_items))
    else:
        rng = np.random.default_rng(0)
        picks = rng.choice(len(loc_items), size=min(n_check, len(loc_items)), replace=False)
    by_file: Dict[int, List[Tuple[str, int]]] = {}
    for p in picks:
        uid, fi, ri = loc_items[int(p)]
        by_file.setdefault(fi, []).append((uid, ri))
    rows = []
    for fi, items in by_file.items():
        with np.load(resfiles[fi]) as data:
            feats = data[_endpoint_key(data.files, resfiles[fi], endpoint)]
        rows += [(uid, np.asarray(feats[ri], dtype=np.float32)) for uid, ri in items]
    readers = _store_readers(out_dir)
    n_done = 0
    for uid, want in rows:
        stem, end = index[uid]
        fid = frame_id_for_time(end, store_fps)
        # a short window ending at the index's own end time: the reader's
        # last frame is floor(end * fps), the float expression pack keyed
        # the feature with (t = fid / fps, floored again, is one frame early
        # for ~1.6% of ids). Clips ending before the first frame time were
        # keyed at frame 1: read that frame's own window.
        if end * store_fps < 1.0:
            t_start, end = 0.0, 1.49 / store_fps
        else:
            t_start = end - 2.0 / store_fps
        for name, reader in readers:
            got, _ = reader(f"{stem}.mp4", t_start, end, store_fps, None)
            got = got[-1].reshape(-1)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{name} readback mismatch for uid={uid} frame={fid}: "
                                     f"max|diff|={np.abs(got - want).max()}")
            n_done += 1
    logger.info("verified %d reader readbacks bit-exact", n_done)
    return n_done


def main(argv=None, device=None):
    """Extract (unless --pack-only), then pack and verify on rank 0.
    Returns pack's stats on rank 0, None on the other ranks."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--config-file", default=None)
    parser.add_argument("--conf-dir", default=str(Path(__file__).resolve().parent.parent / "conf"))
    parser.add_argument("--run-dir", default=None,
                        help="featext work dir (default OUTPUTS/<expt>_featext/0)")
    parser.add_argument("--out", required=True, help="store output dir (npy/ and lmdb/ subdirs)")
    parser.add_argument("--endpoint", default="temp_agg",
                        help="model endpoint to extract (store_endpoint)")
    parser.add_argument("--clip-len", default=1.0, help="dense clip seconds (or mean_action_len)")
    parser.add_argument("--stride", type=float, default=0.1, help="dense sampling stride seconds")
    parser.add_argument("--store-fps", type=float, default=RULSTM_TSN_FPS,
                        help="fps of the frame keying (RULSTM stores use 30)")
    parser.add_argument("--formats", default="npy,lmdb",
                        help=f"comma-separated stores to write, of {list(FORMATS)}")
    parser.add_argument("--resume", action="store_true",
                        help="skip uids already in the run dir's results")
    parser.add_argument("--pack-only", action="store_true",
                        help="skip extraction; pack an existing run dir")
    parser.add_argument("--no-verify", action="store_true")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    formats = parse_formats(args.formats)  # before any extraction
    logger = get_logger("torch_extract_features")

    if args.run_dir is None:
        expt = Path(args.config_file).stem if args.config_file else "default"
        args.run_dir = os.path.join("OUTPUTS", f"{expt}_featext", "0")
    os.makedirs(args.run_dir, exist_ok=True)
    results_dir = os.path.join(args.run_dir, RESULTS_DIR)
    index_path = os.path.join(args.run_dir, INDEX_NAME)
    rank = ddp.env_rank()
    if not args.pack_only:
        import torch

        from avt_tpu_torch.train_net import main as train_main

        if rank == 0:
            cfg_index = compose_cfg(args.config_file, args.overrides, args, args.conf_dir,
                                    for_index=True)
            index_path = write_index(cfg_index, args.run_dir, logger)
        cfg = compose_cfg(args.config_file, args.overrides, args, args.conf_dir)
        logger.info("Extracting '%s' features -> %s", args.endpoint, results_dir)
        joins_group = not torch.distributed.is_initialized()
        train_main(cfg, args.run_dir, device=device)
        # featext skips the eval's cross-rank syncs, so rank 0 must not pack
        # while another rank still appends: a barrier, then rank 0 packs
        if ddp.world_size() > 1:
            ddp.barrier()
        if joins_group:
            ddp.cleanup()
    if rank != 0:
        logger.info("rank %d: extraction finished; rank 0 packs", rank)
        return None
    if not os.path.exists(index_path):
        raise SystemExit(f"{index_path} missing — run extraction first (or copy the index from "
                         "the extracting run dir)")
    index = read_index(index_path)
    stats = pack(results_dir, index, args.out, endpoint=args.endpoint,
                 formats=formats, store_fps=args.store_fps, logger=logger)
    logger.info("packed %(rows)d features / %(videos)d videos (%(skipped)d rows not in index)",
                stats)
    if not args.no_verify:
        verify_roundtrip(results_dir, index, args.out, endpoint=args.endpoint,
                         store_fps=args.store_fps, logger=logger)
    return stats


if __name__ == "__main__":
    main()
