"""Per-process result files: the interface between evaluation and analysis.

Counterpart of avt_tpu/evaluate/results.py (`store_append_h5`,
`read_results`). The JAX package appends each batch to one resizable,
gzip-compressed H5 file per process, `<output_dir>/<rank>.h5`. The port
keeps to numpy: `store_append` writes each call's arrays as one
uncompressed `np.savez` file, `<output_dir>/<rank>/<n>.npz` with n counting
from 000000, uids as S64 as in the H5 file. `read_results` is the interface
the rest of the code uses, and it merges as JAX's does: the files of every
rank, each key a dense [max_idx + 1, ...] array, multiple predictions of
one idx averaged. `read_all_results`, `get_epoch_from_resdir` and
`get_logits_from_results` are the readers of the offline analysis
(evaluate/analysis.py), on the same files.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
from collections import OrderedDict
from typing import Dict, Iterator

import numpy as np

STR_UID_MAXLEN = 64


def store_append(endpoints: Dict[str, np.ndarray], output_dir: str, rank: int = 0) -> None:
    """Appends a batch of arrays to this process's results: one more file
    under `<output_dir>/<rank>/`."""
    rank_dir = osp.join(output_dir, str(rank))
    os.makedirs(rank_dir, exist_ok=True)
    arrays = {}
    for key, val in endpoints.items():
        val = np.asarray(val)
        if val.dtype.kind == "U":
            if int(val.dtype.str[2:]) >= STR_UID_MAXLEN:
                raise ValueError(f"UID strings must be < {STR_UID_MAXLEN} chars")
            val = val.astype(f"S{STR_UID_MAXLEN}")
        arrays[key] = val
    n = len(glob.glob(osp.join(rank_dir, "*.npz")))
    np.savez(osp.join(rank_dir, f"{n:06d}.npz"), **arrays)


def gen_load_resfiles(resdir: str) -> Iterator[Dict[str, np.ndarray]]:
    """Each rank's results, every key's batches concatenated in the order
    they were appended; ranks in the order of their names."""
    rank_dirs = sorted(d for d in glob.glob(osp.join(resdir, "*")) if osp.isdir(d))
    if not rank_dirs:
        raise FileNotFoundError(f"No result files in {resdir}")
    for rank_dir in rank_dirs:
        parts: Dict[str, list] = {}
        for fpath in sorted(glob.glob(osp.join(rank_dir, "*.npz"))):
            with np.load(fpath) as data:
                for key in data.files:
                    parts.setdefault(key, []).append(data[key])
        yield {key: np.concatenate(vals, axis=0) for key, vals in parts.items()}


def read_saved_results_uids(rank_dir: str) -> set:
    """The uids already in one process's results, `<output_dir>/<rank>`
    (the resume of a feature extraction); empty when there are none."""
    uids = set()
    for fpath in sorted(glob.glob(osp.join(rank_dir, "*.npz"))):
        with np.load(fpath) as data:
            if "uid" in data.files:
                uids.update(el.decode() if isinstance(el, bytes) else str(el)
                            for el in data["uid"].tolist())
    return uids


def read_results(resdir: str) -> Dict[str, np.ndarray]:
    """Merge all ranks' files; mean multiple predictions per idx."""
    data0 = next(gen_load_resfiles(resdir))
    res_per_layer = {key: OrderedDict() for key in data0 if key not in ("epoch",)}
    if not res_per_layer:
        raise ValueError(f"No data keys found in {resdir}")
    for data in gen_load_resfiles(resdir):
        for i, idx in enumerate(data["idx"]):
            idx = int(idx)
            for key in res_per_layer:
                if data[key].shape[0] <= i:
                    continue
                res_per_layer[key].setdefault(idx, []).append(data[key][i])
    final_res = {}
    for key, per_idx in res_per_layer.items():
        if not per_idx:
            continue
        max_idx = max(per_idx.keys())
        first = np.asarray(per_idx[next(iter(per_idx))][0])
        numeric = first.dtype.kind in "fiu"
        dtype = np.float64 if numeric else first.dtype
        arr = np.zeros([max_idx + 1] + list(first.shape), dtype=dtype)
        for idx, vals in per_idx.items():
            vals = np.stack([np.asarray(v) for v in vals])
            # multiple predictions per idx (e.g. repeated clips) are averaged
            arr[idx] = np.mean(vals, axis=0) if numeric else vals[0]
        final_res[key] = arr
    return final_res


def read_all_results(run_dir: str, prefix: str = "results") -> Dict[str, Dict]:
    """Every results<suffix>/ directory under run_dir, read by `read_results`
    and keyed by its name."""
    all_res = {}
    for resdir in glob.glob(osp.join(run_dir, prefix + "*")):
        all_res[osp.basename(resdir)] = read_results(resdir)
    return all_res


def get_epoch_from_resdir(resdir: str):
    """The (fractional) epoch the stored results were computed at, the
    least over the first rank's rows, or None when none was stored: it
    tells a finished eval from a stale or partial one."""
    data = next(gen_load_resfiles(resdir))
    if "epoch" not in data:
        return None
    return float(np.min(data["epoch"]))


def get_logits_from_results(results: Dict[str, np.ndarray]):
    """The logits of a `read_results` dict: the one 'logits/<task>' entry
    (or a bare 'logits'), else a dict of every logits key when the run
    stored several tasks."""
    if "logits" in results:
        return results["logits"]
    keys = [k for k in results if k.startswith("logits/")]
    if not keys:
        raise KeyError(f"no logits keys in results: {sorted(results)}")
    if len(keys) == 1:
        return results[keys[0]]
    return {k: results[k] for k in keys}
