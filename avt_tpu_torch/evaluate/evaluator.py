"""The evaluation loop.

Counterpart of avt_tpu/evaluate/evaluator.py (`evaluate`, `_pad_rows`,
`RESULTS_SAVE_DIR`): loop over the eval loaders, append each batch's
logits, targets, uids and unreduced losses to this process's result files,
recompute the final metrics from the stored files (so offline analysis and
the in-train eval agree), return the suffix-less loader's primary metric.
The eval step holds the model, so no parameters are passed; the batches
go to `device` (CUDA unless the CPU is asked for).

Under data parallelism over processes each rank evaluates its shard of the
loaders: rank 0 clears the results directory behind a barrier, each rank
appends to `<dir>/<rank>/`, the meters are summed over the ranks, and a
barrier comes before the merge, which every rank reads whole. Under tensor
parallelism the rank is the data rank: model peers evaluate the same rows,
and only model rank 0 of each replica writes them, so that the merge sees
each row once.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, Optional

import numpy as np
import torch

from avt_tpu_torch.evaluate.metrics import final_accuracies_from_results
from avt_tpu_torch.evaluate.results import read_results, store_append
from avt_tpu_torch.train.meters import MetricLogger
from avt_tpu_torch.parallel import ddp
from avt_tpu_torch.utils.device import batch_to_device, resolve_device

RESULTS_SAVE_DIR = "results"

# batch keys that go to the device for the eval step
_JIT_KEYS = ("video", "target", "target_subclips")


def _pad_rows(node, pad: int):
    """Repeat rows (wrapping) at the end (dicts recurse; lists too).

    Wrap-around indexing matters: a ragged final batch can be SMALLER than
    the pad needed (bsz=1, pad_multiple=4 -> pad=3), where a plain
    ``arr[:pad]`` slice would under-pad and the batch still wouldn't
    divide pad_multiple.
    """
    if isinstance(node, dict):
        return {k: _pad_rows(v, pad) for k, v in node.items()}
    if isinstance(node, list):
        return node + [node[i % len(node)] for i in range(pad)]
    arr = np.asarray(node)
    idx = np.arange(pad) % arr.shape[0]
    return np.concatenate([arr, arr[idx]], axis=0)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A result on the host; bf16 and f16 widen to f32 (numpy has neither)."""
    x = x.detach()
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.cpu().numpy()


def evaluate(
    eval_step: Callable,
    data_loaders: Dict[str, object],
    *,
    save_dir: str = ".",
    epoch: float = 0.0,
    store: bool = True,
    only_run_featext: bool = False,
    logger=None,
    rank: Optional[int] = None,
    device=None,
    place_batch: Optional[Callable] = None,
    pad_multiple: int = 1,
) -> float:
    """Run evaluation over every loader; return the primary metric of the
    suffix-less ('') loader.

    eval_step(batch) -> results, as `make_eval_step` builds it. place_batch
    (batch) puts the eval step's keys on the device (default: onto
    `device`). pad_multiple: a ragged final batch is padded to a multiple
    of it by repeating leading rows; read_results' mean per idx removes the
    duplicates again, while the online meters see them. rank: this
    process's data rank, which names its results directory (None: the
    mesh's)."""
    rank = ddp.data_rank() if rank is None else rank
    writes = ddp.model_rank() == 0
    if place_batch is None:
        target_device = resolve_device(device)

        def place_batch(batch):
            return batch_to_device(batch, target_device)

    final_accuracies = {}
    for data_key, loader in data_loaders.items():
        metric_logger = MetricLogger(logger=logger)
        this_save_dir = os.path.join(save_dir, RESULTS_SAVE_DIR + data_key)
        if store and not only_run_featext:
            if rank == 0 and writes:
                shutil.rmtree(this_save_dir, ignore_errors=True)
            ddp.barrier()  # no rank appends before rank 0 has cleared the directory
        for batch in metric_logger.log_every(loader, print_freq=50, header=f"[{data_key}] Test:",
                                             total=len(loader)):
            if pad_multiple > 1:
                bsz = next(iter(batch["target"].values())).shape[0]
                rem = bsz % pad_multiple
                if rem:
                    batch = _pad_rows(batch, pad_multiple - rem)
            res = eval_step(place_batch({k: batch[k] for k in _JIT_KEYS if k in batch}))
            res = {k: _to_host(v) for k, v in res.items()}
            batch_size = next(iter(batch["target"].values())).shape[0]
            if store and writes:
                # everything the eval step selected (logits or feature
                # endpoints) and the unreduced losses; scalars (the mean
                # auxiliary losses) append as (1,) rows
                to_store = {k: (v[None] if v.ndim == 0 else v)
                            for k, v in res.items() if not k.startswith("acc")}
                to_store["idx"] = np.asarray(batch["idx"])
                to_store["uid"] = np.asarray(batch["uid"])
                if not only_run_featext:
                    for k, v in batch["target"].items():
                        to_store[f"target/{k}"] = np.asarray(v)
                to_store["epoch"] = np.asarray([epoch])
                store_append(to_store, this_save_dir, rank=rank)
            loss_keys = [k for k in res if k.startswith("loss/")]
            metric_logger.update(loss=float(np.sum([np.mean(res[k]) for k in loss_keys])))
            for k, v in res.items():
                if k.startswith("acc"):
                    metric_logger.update(n=batch_size, **{k: float(v)})
                elif k.startswith("loss/"):
                    metric_logger.update(n=batch_size, **{k: float(np.mean(v))})
        n_backfilled = getattr(loader, "backfill_count", 0)
        if n_backfilled and logger is not None:
            logger.warning("[eval%s] %d failed reads were backfilled this epoch", data_key,
                           n_backfilled)
        if only_run_featext:
            continue
        metric_logger.synchronize_between_processes()
        accs = {k: m.global_avg for k, m in metric_logger.meters.items()}
        if store:
            ddp.barrier()  # every rank's results are written
            results = read_results(this_save_dir)
            accs.update(final_accuracies_from_results(results, loader.dataset.classes_manyshot))
        if logger is not None:
            for k in sorted(accs):
                logger.info("[eval%s] %s: %f", data_key, k, accs[k])
        final_accuracies[data_key] = accs
    if only_run_featext:
        return 0.0
    main = data_loaders[""]
    accs = final_accuracies[""]
    pm = main.dataset.primary_metric
    if pm not in accs:
        # store=False keeps only the online meters (the final metrics are
        # recomputed from the stored files); fall back to a top-1 meter
        fallback = next((k for k in sorted(accs) if k.startswith("acc1")), None)
        if logger is not None:
            logger.warning("primary metric %s needs store=true; returning %s", pm,
                           fallback or "0.0")
        return float(accs[fallback]) if fallback else 0.0
    return accs[pm]
