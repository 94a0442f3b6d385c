"""The training loop.

Counterpart of avt_tpu/train/loop.py (`Preempted`, `train_one_epoch`,
`run_training`): the epoch loop with a reshuffle per epoch, checkpoints
every `save_freq` of an epoch and every `save_freq_min` minutes (at
fractional epochs), eval every `eval_freq` epochs with the best checkpoint
kept, the NaN-loss abort, graceful preemption on a signal, and the
fractional-epoch resume that fast-forwards the loader.

The port's steps update the model and the optimizer in place, so the loop
takes both where JAX takes a TrainState. Batches come from the loader as
host numpy arrays; `place_batch` moves the step's keys to the model's
device and leaves `idx` and `uid` on the host. Step j of the run draws its
dropout masks and crops from `step_generator(seed, j)` alone, in place of
JAX's `fold_in(rng, j)`: a run chunked by `unroll_steps` and a resumed run
take the same steps as a plain run (the masks differ from JAX's).

Under data parallelism over processes (parallel/ddp.py) every rank runs this
loop on its shard of each batch, in lockstep: the checkpoints are written by
rank 0 behind a barrier, and the two decisions that a rank's own clock or
signal would make alone are taken together, every PREEMPT_SYNC_EVERY chunks,
so that no rank is left waiting in a collective: the wall-clock save is rank
0's, the preemption stop any rank's. TensorBoard is written on rank 0.

Under a profiler the wait for the next chunk from the loader is the span
`avt.loop.data_wait` and the fetch of a chunk's metrics, the loop's one
sync, `avt.loop.drain`; each step carries its own `avt.train.step`
(utils/trace.py).
"""
from __future__ import annotations

import datetime
import itertools
import math
import signal as _signal
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from avt_tpu_torch.train.checkpoint import BEST_NAME, CKPT_NAME, restore_checkpoint, save_checkpoint
from avt_tpu_torch.train.meters import MetricLogger, make_tb_writer
from avt_tpu_torch.train.step import step_generator
from avt_tpu_torch.parallel import ddp
from avt_tpu_torch.utils import trace
from avt_tpu_torch.utils.device import batch_to_device

_JIT_KEYS = ("video", "target", "target_subclips")
_VIDEO_LOG_DISABLED = False
# how often (in chunks) the ranks of a multi-process run agree on a
# preemption stop and on a wall-clock save
PREEMPT_SYNC_EVERY = 16


class Preempted(RuntimeError):
    """A graceful-shutdown signal arrived mid-epoch; the rolling checkpoint
    was written at the batch boundary where training stopped, so a relaunch
    auto-resumes from exactly there and takes the steps the uninterrupted
    run would have taken."""

    def __init__(self, epoch: float):
        super().__init__(f"preempted at epoch {epoch:.4f}; checkpoint saved")
        self.epoch = epoch


def _store_video_logs(batch, step_id, print_large_freq, metric_logger):
    """TB grids of every 6-D '*video' batch key: flatten (B, #clips),
    transpose to tensorboard's (N, T, C, H, W), min-max normalize. Disabled
    after the first failure (tensorboardX's video encoder needs moviepy,
    which may be absent)."""
    global _VIDEO_LOG_DISABLED
    if metric_logger.writer is None or not print_large_freq or _VIDEO_LOG_DISABLED:
        return
    for key, video in batch.items():
        arr = np.asarray(video)
        if not key.endswith("video") or arr.ndim != 6:
            continue
        v = arr.reshape((-1,) + arr.shape[2:]).transpose(0, 2, 1, 3, 4)
        v = v.astype(np.float32)
        v -= v.min()
        vmax = v.max()
        if vmax > 0:
            v /= vmax
        try:
            metric_logger.writer.add_video(key, v, step_id, fps=4)
        except Exception:
            _VIDEO_LOG_DISABLED = True
            return


def _start_fetch(metrics):
    """Starts the copy of a chunk's metrics (each (n,) on the device) to
    the host as one (n_keys, n) f32 tensor: (keys, host tensor, the event
    after which it is filled, or None on the CPU). On a card the copy goes
    into pinned memory without waiting, and the event lets the fetch wait
    for this chunk alone, not for the chunks queued after it."""
    keys = list(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    if not stacked.is_cuda:
        return keys, stacked, None
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(stacked.device))
    return keys, host, ready


def _jit_batch(batch):
    """The keys the train step reads (incl. SSL future clips)."""
    return {k: v for k, v in batch.items()
            if k in _JIT_KEYS or (k.startswith("future_") and k.endswith("_video"))}


def train_one_epoch(
    train_step: Callable,
    model,
    optimizer,
    loader,
    *,
    epoch: int,
    partial_epoch: float = 0.0,
    seed: int = 42,
    multi_step: Optional[Callable] = None,
    unroll_steps: int = 1,
    place_batch: Optional[Callable] = None,
    metric_logger: Optional[MetricLogger] = None,
    logger=None,
    print_freq: int = 10,
    print_large_freq: int = 1000,
    save_freq: Optional[float] = None,
    save_freq_min: Optional[float] = None,
    save_intermediates: bool = False,
    ckpt_dir: Optional[str] = None,
    last_saved_time: Optional[datetime.datetime] = None,
    rank: Optional[int] = None,
    writer=None,
    host_state_fn: Optional[Callable] = None,
    preempt_check: Optional[Callable[[], bool]] = None,
) -> datetime.datetime:
    """Run (the rest of) one epoch; returns the time of the last save.

    train_step(batch, generator) -> metrics and multi_step(batches,
    step_id0, seed) -> metrics stacked (K,), as `make_train_step` and
    `make_multi_step` build them. Full chunks of `unroll_steps` batches go
    through `multi_step`; short tails (the epoch's end, a fractional
    resume's remainder) through `train_step`, one batch at a time.
    place_batch(batch) -> the batch on the device (default: the model's).

    preempt_check: polled once per chunk; when it turns true the in-flight
    chunk is drained, the rolling checkpoint is written at the current
    batch boundary, and Preempted is raised. rank: this process's (None:
    the process group's)."""
    rank = ddp.rank() if rank is None else rank
    n_procs = ddp.world_size()
    if place_batch is None:
        device = next(model.parameters()).device

        def place_batch(batch):
            return batch_to_device(batch, device)

    metric_logger = metric_logger or MetricLogger(logger=logger, writer=writer)
    batches_per_epoch = len(loader)
    # the stored fraction is consumed_batches / batches_per_epoch, so round()
    # recovers the exact count (int() would replay a batch whenever the
    # fraction's float rounds down, e.g. 1/5 -> 0.1999..)
    partial_iters = int(round(batches_per_epoch * partial_epoch))
    last_saved_time = last_saved_time or datetime.datetime.now()
    save_freq_steps = int(save_freq * batches_per_epoch) if save_freq else None
    it = iter(loader)
    for _ in range(partial_iters):  # fast-forward a fractional resume
        next(it)
    K = max(1, unroll_steps) if multi_step is not None else 1

    def chunked():
        while True:
            with trace.span("avt.loop.data_wait"):
                buf = list(itertools.islice(it, K))
            if not buf:
                return
            yield buf

    n_chunks = -(-(batches_per_epoch - partial_iters) // K)
    step_id = epoch * batches_per_epoch + partial_iters
    # a bucket counter keeps the "save every save_freq * iters steps"
    # cadence under chunked dispatch; the first chunk saves only on an
    # exact boundary (step_id % save_freq_steps == 0), not at every epoch start
    last_save_bucket = -1
    if save_freq_steps:
        last_save_bucket = step_id // save_freq_steps
        if step_id % save_freq_steps == 0:
            last_save_bucket -= 1

    # One-chunk-deep pipeline: the metrics of chunk i are fetched only after
    # chunk i+1 has been queued, so the host prepares the next chunk while
    # the device computes this one (the fetch is the only sync, and waits
    # for chunk i alone). The NaN abort therefore fires one chunk late.
    pending = None  # (_start_fetch's triple, n_steps, batch size, step_id0)
    last_dispatch = time.time()

    def drain(entry):
        nonlocal last_dispatch
        (keys, host, ready), n_steps, batch_size, sid0 = entry
        with trace.span("avt.loop.drain"):
            if ready is not None:
                ready.synchronize()  # the sync
            values = host.tolist()
        dt = time.time() - last_dispatch
        last_dispatch = time.time()
        per_step = [{k: values[i][j] for i, k in enumerate(keys)} for j in range(n_steps)]
        for m in per_step:
            loss = m["loss"]
            if math.isnan(loss):
                raise ValueError("The loss is NaN!")
            metric_logger.update(loss=loss)
            for k, v in m.items():
                if k.startswith("acc"):
                    metric_logger.update(n=batch_size, **{k: v})
                elif k.startswith("loss/"):
                    metric_logger.update(**{k: v})
        metric_logger["clips/s"].update(batch_size * n_steps / dt)
        if (sid0 // K) % print_freq == 0:
            for k, v in per_step[-1].items():
                metric_logger.write_scalar(f"train_per_iter/{k}", v, sid0 + n_steps - 1)

    for chunk_idx, chunk in enumerate(metric_logger.log_every(
            chunked(), print_freq, f"Epoch [{epoch}]", total=n_chunks)):
        cur_epoch = step_id / batches_per_epoch
        if preempt_check is not None and preempt_check():
            if pending is not None:
                drain(pending)
                pending = None
            if ckpt_dir:
                save_checkpoint(ckpt_dir, model, optimizer, cur_epoch, rank=rank,
                                host_state=host_state_fn() if host_state_fn else None)
            raise Preempted(cur_epoch)
        now = datetime.datetime.now()
        mins_since = (now - last_saved_time).total_seconds() / 60.0
        time_due = bool(save_freq_min and mins_since >= save_freq_min)
        if save_freq_min and n_procs > 1:
            # the save is a collective and clocks differ between ranks: rank
            # 0's clock decides, on a chunk schedule that every rank keeps
            time_due = (chunk_idx % PREEMPT_SYNC_EVERY == 0) and ddp.from_rank0(time_due)
        bucket = step_id // save_freq_steps if save_freq_steps else -1
        if ckpt_dir and ((save_freq_steps and bucket > last_save_bucket) or time_due):
            # drain the in-flight chunk first, so that its NaN abort fires
            # before a (possibly NaN) model overwrites the rolling checkpoint
            if pending is not None:
                drain(pending)
                pending = None
            names = [CKPT_NAME]
            if save_intermediates:
                names.append(f"{CKPT_NAME}_ep{cur_epoch:.8f}")
            save_checkpoint(ckpt_dir, model, optimizer, cur_epoch, names=tuple(names),
                            rank=rank, host_state=host_state_fn() if host_state_fn else None)
            last_saved_time = now
            last_save_bucket = bucket

        # TB video grids once per print_large_freq steps (step_id advances
        # by K per chunk, so fire on the crossing chunk)
        if print_large_freq and step_id % print_large_freq < K:
            _store_video_logs(chunk[0], step_id, print_large_freq, metric_logger)
        placed = [place_batch(_jit_batch(b)) for b in chunk]
        if len(chunk) == K and K > 1:
            metrics = multi_step(placed, step_id, seed)
        else:  # tail (or K == 1): one batch at a time
            per_step = [
                train_step(b, step_generator(seed, step_id + j, b["video"].device))
                for j, b in enumerate(placed)]
            metrics = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
        batch_size = next(iter(chunk[0]["target"].values())).shape[0]
        entry = (_start_fetch(metrics), len(chunk), batch_size, step_id)
        if pending is not None:
            drain(pending)
        pending = entry
        step_id += len(chunk)
    if pending is not None:
        drain(pending)
    metric_logger.dump_to_tb(epoch)
    return last_saved_time


def run_training(
    *,
    train_step: Callable,
    model,
    optimizer,
    train_loader,
    eval_fn: Optional[Callable] = None,  # (epoch) -> primary metric
    num_epochs: int,
    multi_step: Optional[Callable] = None,
    unroll_steps: int = 1,
    place_batch: Optional[Callable] = None,
    plateau=None,  # ReduceLROnPlateau: plateau.step(optimizer, metric)
    ckpt_dir: Optional[str] = None,
    eval_freq: int = 1,
    store_best: bool = False,
    print_freq: int = 10,
    print_large_freq: int = 1000,
    save_freq: Optional[float] = None,
    save_freq_min: Optional[float] = 60.0,
    save_intermediates: bool = False,
    seed: int = 42,
    logger=None,
    rank: Optional[int] = None,
    tb_dir: Optional[str] = None,
    graceful_signals: Tuple[int, ...] = (),
):
    """The training entry point, with auto-resume from `<ckpt_dir>/checkpoint`;
    trains `model` and `optimizer` in place and returns the model.

    graceful_signals: OS signals (e.g. SIGTERM) that trigger a graceful
    checkpoint-and-exit: the current chunk finishes, the rolling checkpoint
    is written, and Preempted propagates so the launcher can requeue. The
    original handlers are restored on exit; main thread only. Under data
    parallelism the stop is collective: every PREEMPT_SYNC_EVERY chunks the
    ranks learn whether any of them got a signal, and all stop at the same
    chunk. rank: this process's (None: the process group's)."""
    rank = ddp.rank() if rank is None else rank
    writer = make_tb_writer(tb_dir, rank) if tb_dir else None
    # the plateau counters ride the checkpoint's host state
    host_state_fn = plateau.state_dict if hasattr(plateau, "state_dict") else None
    start_epoch = 0.0
    if ckpt_dir:
        restored = restore_checkpoint(
            ckpt_dir, model, optimizer,
            host_template=host_state_fn() if host_state_fn else None)
        if restored is not None:
            if host_state_fn:
                start_epoch, host = restored
                plateau.load_state_dict(host)
            else:
                start_epoch = restored
            if logger:
                logger.info("Resumed from epoch %.4f", start_epoch)
    # the reference seeds best_acc1 = 0.0 and stores on acc1 >= best_acc1:
    # ties go to the latest epoch and the first eval always stores
    best_metric = 0.0
    last_saved = datetime.datetime.now()
    epoch = int(start_epoch)
    partial = start_epoch - epoch
    preempt_sig = {"signum": None}
    orig_handlers = {}

    def _on_signal(signum, frame):
        preempt_sig["signum"] = signum
        if logger:
            logger.info("Signal %d received — will checkpoint and exit at the next chunk "
                        "boundary", signum)

    preempt_check = None
    if graceful_signals and ddp.world_size() > 1:
        polls = {"n": 0}

        def preempt_check():
            # the poll count advances alike on every rank (one loader length)
            n = polls["n"]
            polls["n"] = n + 1
            return n % PREEMPT_SYNC_EVERY == 0 and ddp.any_rank(preempt_sig["signum"] is not None)
    elif graceful_signals:
        def preempt_check():
            return preempt_sig["signum"] is not None
    try:
        for s in graceful_signals:
            orig_handlers[s] = _signal.signal(s, _on_signal)
        while epoch < num_epochs:
            train_loader.set_epoch(epoch)
            last_saved = train_one_epoch(
                train_step, model, optimizer, train_loader,
                epoch=epoch,
                partial_epoch=partial if epoch == int(start_epoch) else 0.0,
                seed=seed,
                multi_step=multi_step,
                unroll_steps=unroll_steps,
                place_batch=place_batch,
                logger=logger,
                print_freq=print_freq,
                print_large_freq=print_large_freq,
                save_freq=save_freq,
                save_freq_min=save_freq_min,
                save_intermediates=save_intermediates,
                ckpt_dir=ckpt_dir,
                last_saved_time=last_saved,
                rank=rank,
                writer=writer,
                host_state_fn=host_state_fn,
                preempt_check=preempt_check,
            )
            partial = 0.0
            if ckpt_dir:
                save_checkpoint(ckpt_dir, model, optimizer, float(epoch + 1), rank=rank,
                                host_state=host_state_fn() if host_state_fn else None)
                last_saved = datetime.datetime.now()
            # eval after epochs 0, eval_freq, 2 * eval_freq, ... (the 0-based
            # epoch just finished), with metric 0 on the other epochs feeding
            # the best checkpoint and the plateau, as the reference's acc1 = 0
            if eval_fn is not None and eval_freq and epoch % eval_freq == 0:
                metric = eval_fn(float(epoch + 1))
                if logger:
                    logger.info("Epoch %d primary metric: %f", epoch + 1, metric)
                if writer is not None:
                    writer.add_scalar("eval_per_epoch/primary_metric", metric, epoch + 1)
            else:
                metric = 0.0
            # the best checkpoint before the plateau step, which may lower
            # the LR multipliers
            if store_best and metric >= best_metric and ckpt_dir:
                best_metric = metric
                save_checkpoint(ckpt_dir, model, optimizer, float(epoch + 1), names=(BEST_NAME,),
                                rank=rank,
                                host_state=host_state_fn() if host_state_fn else None)
            if plateau is not None and eval_fn is not None:
                # stepped every epoch on the eval metric (0 on non-eval epochs)
                plateau.step(optimizer, metric)
            epoch += 1
    finally:
        for s, h in orig_handlers.items():
            _signal.signal(s, h)
    return model
