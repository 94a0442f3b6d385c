"""Batched input pipeline: dataset -> fixed-shape numpy batches.

A copy of avt_tpu/data/loader.py (`collate`, `DataLoader`): a thread-pooled
host loader with a seeded shuffle per epoch (`set_epoch`), a split by
(rank, world) between processes, `drop_last`, an explicit index sampler,
and failed reads (None items) backfilled so that every batch keeps its
shape ('random' substitutes another sample, 'repeat' a good row of the same
batch). Batches stay numpy on the host; the caller's `place_batch` moves
them to the device.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

LOG = logging.getLogger(__name__)


def collate(items) -> Dict:
    """Stack a list of dataset dicts into one batch dict of arrays."""
    out: Dict = {}
    first = items[0]
    for key, val in first.items():
        if isinstance(val, dict):
            out[key] = {
                k: np.stack([np.asarray(it[key][k]) for it in items])
                for k in val
            }
        elif isinstance(val, str):
            out[key] = np.asarray([it[key] for it in items])
        elif np.isscalar(val) or isinstance(val, np.ndarray):
            out[key] = np.stack([np.asarray(it[key]) for it in items])
        else:
            out[key] = [it[key] for it in items]
    return out


class DataLoader:
    """Thread-pooled batching over an indexable dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        keys: Optional[list] = None,
        sampler=None,
        backfill: str = "random",
    ):
        """backfill: what replaces a failed read (shapes must stay static):
        'random' substitutes a random OTHER sample (train: matches the
        reference's keep-training-on-something behavior); 'repeat'
        duplicates a good row from the same batch (eval: duplicate idx
        rows are averaged out by read_results' mean-per-idx merge, so
        final metrics never include substituted samples — reference
        func/train.py:500-508 shrinks the batch instead). A batch whose
        EVERY read fails falls back to random substitution under both
        policies: the batch COUNT must match on every process or
        lockstep multi-rank programs deadlock in their collectives.
        `backfill_count` tallies failures per epoch."""
        if backfill not in ("random", "repeat"):
            raise ValueError(f"Unknown backfill policy {backfill!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self.backfill = backfill
        self.backfill_count = 0
        self.keys = keys  # restrict returned keys (drop strings for jit)
        # explicit index sampler (e.g. clip_samplers.*) — overrides the
        # built-in shuffle/shard, like passing sampler= to torch DataLoader
        # (the reference's video_clips path, func/train.py:606-658)
        self.sampler = sampler

    def set_epoch(self, epoch: int):
        """Reshuffle differently each epoch (DistributedSampler parity)."""
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _epoch_indices(self) -> np.ndarray:
        if self.sampler is not None:
            # cached per epoch: samplers are (seed, epoch)-deterministic,
            # but materializing is O(n) and len()/__iter__ both need it
            cached = getattr(self, "_sampler_cache", None)
            if cached is not None and cached[0] == self.epoch:
                return cached[1]
            idx = np.fromiter(iter(self.sampler), dtype=np.int64)
            self._sampler_cache = (self.epoch, idx)
            return idx
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.world_size > 1:
            # pad to a multiple of world (repeat from front) then shard
            per = int(np.ceil(n / self.world_size))
            idx = np.concatenate([idx, idx[: per * self.world_size - n]])
            idx = idx[self.rank :: self.world_size]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _fetch(self, i: int):
        try:
            item = self.dataset[int(i)]
        except Exception:  # corrupt video/missing feature -> backfill
            LOG.warning("dataset[%d] raised; backfilling", i, exc_info=True)
            return None
        if item is None:
            return None
        if self.keys is not None:
            item = {k: item[k] for k in self.keys if k in item}
        return item

    def __iter__(self) -> Iterator[Dict]:
        indices = self._epoch_indices()
        bs = self.batch_size
        n = len(indices)
        nb = n // bs if self.drop_last else int(np.ceil(n / bs))
        backfill_rng = np.random.default_rng(self.seed + 7919 + self.epoch)
        self.backfill_count = 0
        with ThreadPoolExecutor(self.num_workers) as pool:
            # pipeline: submit batch i+1 while collating batch i
            def submit(bi):
                batch_idx = indices[bi * bs : (bi + 1) * bs]
                return [pool.submit(self._fetch, i) for i in batch_idx]

            pending = submit(0) if nb > 0 else []
            for bi in range(nb):
                futures = pending
                pending = submit(bi + 1) if bi + 1 < nb else []
                items = [f.result() for f in futures]
                good = [it for it in items if it is not None]
                n_failed = len(items) - len(good)
                if n_failed:
                    # a decaying dataset must be visible, whatever the policy
                    self.backfill_count += n_failed
                    LOG.warning(
                        "%d/%d reads failed in batch %d (policy=%s; "
                        "%d so far this epoch)", n_failed, len(items), bi,
                        self.backfill, self.backfill_count,
                    )
                if good and self.backfill == "repeat":
                    # duplicate in-batch rows: same idx -> merged away by
                    # read_results; no foreign sample enters the batch
                    i = 0
                    while len(good) < len(items):
                        good.append(good[i % len(good)])
                        i += 1
                else:
                    # random substitutes keep training on full batches —
                    # and keep the BATCH COUNT identical on every process
                    # (dropping a batch would desync lockstep multi-rank
                    # programs into a collective deadlock). Bounded: a
                    # fully unreadable dataset must raise, not spin.
                    attempts = 0
                    max_attempts = max(100, 20 * len(items))
                    while len(good) < len(items):
                        if attempts >= max_attempts:
                            raise RuntimeError(
                                f"batch {bi}: {len(items) - len(good)} "
                                f"slots still unfilled after "
                                f"{max_attempts} random backfill "
                                "attempts — dataset unreadable?"
                            )
                        attempts += 1
                        j = int(backfill_rng.integers(len(indices)))
                        it = self._fetch(indices[j])
                        if it is not None:
                            good.append(it)
                yield collate(good)
