"""Training entry point.

Counterpart of avt_tpu/train_net.py (`main`, `cli`), in one process:
compose the config from conf/ and the overrides (sweeps expand to one run
each), build the datasets, loaders and model, load train.init_from_model's
checkpoints into it, build the optimizer, auto-resume from the run
directory, train with an eval every eval_freq epochs (the SSL step under
train_eval_op=pred_future_feat), or only evaluate (test_only).

Usage:
  python -m avt_tpu_torch.train_net [key=value +key=value ...]  # conf/config.yaml:
      # r2plus1d_34 on EK100 raw video
  python -m avt_tpu_torch.train_net --config-file expts/02_ek100_avt_tsn.txt \\
      [--run-dir OUTPUTS/x/0] [extra overrides]

It runs on the GPU. The CPU is taken only when asked for: AVT_PLATFORM=cpu
(the JAX package's switch) or main(..., device="cpu"); with neither and no
GPU it raises. Its multi-process form waits for the DDP slice.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from avt_tpu_torch.config import Composer, expand_sweeps, parse_override, parse_overrides_file
from avt_tpu_torch.config.build import (
    build_all_datasets,
    build_model,
    build_optimizer_from_cfg,
    build_preprocess_fns,
    loss_weights,
)
from avt_tpu_torch.config.registry import instantiate
from avt_tpu_torch.data.clip_samplers import build_clip_samplers
from avt_tpu_torch.data.dataset import ConcatDataset
from avt_tpu_torch.data.loader import DataLoader
from avt_tpu_torch.evaluate import evaluate
from avt_tpu_torch.models.import_torch import init_from_model
from avt_tpu_torch.train import (
    Preempted,
    ReduceLROnPlateau,
    make_eval_step,
    make_multi_step,
    make_ssl_train_step,
    make_train_step,
    run_training,
)
from avt_tpu_torch.train.ops import balance_weights_from_counts
from avt_tpu_torch.utils.device import require_one_process, resolve_device
from avt_tpu_torch.utils.logging import get_logger

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"


def platform_device(device=None) -> torch.device:
    """The run's device: `device` when given, else the CPU when
    AVT_PLATFORM=cpu, else the GPU (raising when there is none)."""
    if device is None:
        plat = os.environ.get("AVT_PLATFORM")
        if plat == "cpu":
            device = "cpu"
        elif plat not in (None, "", "cuda", "gpu"):
            raise ValueError(f"AVT_PLATFORM={plat!r}: the port runs on 'cuda' or 'cpu'")
    return resolve_device(device)


def _ssl_step(cfg: Dict, op_cfg: Dict, batch0: Dict, model, optimizer, num_classes,
              class_weights):
    """train_eval_op=pred_future_feat's step (`make_ssl_train_step`), its
    future count taken from the first batch's `future_<i>_video` keys."""
    cls_cfg = op_cfg.get("cls_loss_acc_fn") or {}
    combine = op_cfg.get("combine_future_losses", "min")
    if isinstance(combine, dict):  # the reference's {_target_: torch.min}
        combine = combine["_target_"].rsplit(".", 1)[-1]
    nfutures = len([k for k in batch0 if k.startswith("future_") and k.endswith("_video")])
    if nfutures == 0:
        raise ValueError("train_eval_op=pred_future_feat needs future clips: set "
                         "dataset_train.return_future_clips_too=true")
    return make_ssl_train_step(
        model, optimizer, loss_weights(cfg), num_classes,
        reg_criterion=instantiate(op_cfg["reg_criterion"]), nfutures=nfutures,
        future_target=op_cfg.get("future_target", "temp_agg_projected"),
        incur_loss_style=op_cfg.get("incur_loss_style", "separately"),
        combine_future_losses=combine,
        cumulative_future=op_cfg.get("cumulative_future", False),
        class_weights=class_weights, use_cls_loss=cls_cfg.get("name", "basic") != "no")


def main(cfg: Dict, work_dir: str = ".", device=None) -> float:
    """One run of the composed config `cfg` in `work_dir` (checkpoints,
    results, tb/); returns the primary metric of the last eval (0.0 when
    there is no eval dataset)."""
    require_one_process("train_net.main")
    device = platform_device(device)
    logger = get_logger("avt_tpu_torch.train")
    seed = cfg.get("seed", 42)
    np.random.seed(seed)
    torch.manual_seed(seed)

    train_datasets, eval_datasets = build_all_datasets(cfg)
    train_dataset = (train_datasets[0] if len(train_datasets) == 1
                     else ConcatDataset(train_datasets))
    num_classes = {k: len(v) for k, v in train_dataset.classes.items()}
    class_mappings = train_dataset.class_mappings

    # one process: the config's per-replica batch size is the batch; a null
    # eval batch size falls back to 4x the train one (no backward)
    batch_size = cfg["train"]["batch_size"]
    eval_bs = cfg["eval"].get("batch_size") or batch_size * 4
    # SSL future clips: one key per future_<i>_start column of the tables
    dfs = [getattr(d, "df", None) for d in train_datasets + list(eval_datasets.values())]
    n_futures = max([len([c for c in df.columns
                          if c.startswith("future_") and c.endswith("_start")])
                     for df in dfs if df is not None] or [0])
    keys = ["video", "target", "target_subclips", "idx", "uid"] + [
        f"future_{i}_video" for i in range(n_futures)]
    train_sampler, eval_samplers = build_clip_samplers(
        train_dataset, eval_datasets,
        train_bs_multiplier=cfg["data_train"].get("train_bs_multiplier", 5),
        val_clips_per_video=cfg["data_eval"].get("val_clips_per_video", 1),
        shuffle_data=cfg["train"].get("shuffle_data", True),
    )
    train_loader = DataLoader(
        train_dataset, batch_size,
        shuffle=cfg["train"].get("shuffle_data", True),
        drop_last=True,
        num_workers=cfg["data_train"].get("workers", 8),
        seed=seed,
        keys=keys,
        sampler=train_sampler,
    )
    only_featext = bool(cfg["eval"]["eval_fn"].get("only_run_featext"))
    eval_loaders = {
        suffix: DataLoader(
            ds, eval_bs, shuffle=False, drop_last=False,
            num_workers=cfg["data_eval"].get("workers", 8), keys=keys,
            sampler=eval_samplers[suffix],
            # failed reads repeat an in-batch row (same idx, averaged away
            # on merge) rather than bring a foreign sample into the metrics
            backfill="repeat",
        )
        for suffix, ds in eval_datasets.items()
    }

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    model = build_model(cfg, num_classes, class_mappings, device=device, generator=gen)
    if cfg["train"].get("init_from_model"):
        # before the optimizer; a checkpoint in the run directory still wins
        # (run_training restores it)
        init_from_model(model, cfg["train"]["init_from_model"])
    # raw-video batches (B, T, H, W, 3 uint8) are preprocessed on the device
    # inside the steps: resize, crop, augment and the subclip fold
    batch0 = next(iter(train_loader))
    video0 = np.asarray(batch0["video"])
    train_pp_fn = eval_pp_fn = None
    if video0.ndim == 5 and video0.shape[-1] == 3:
        train_pp_fn, eval_pp_fn = build_preprocess_fns(cfg, device)

    iters_per_epoch = max(len(train_loader), 1)
    optimizer, _ = build_optimizer_from_cfg(cfg, model, iters_per_epoch=iters_per_epoch)
    op_cfg = cfg.get("train_eval_op") or {}
    cls_cfg = op_cfg.get("cls_loss_acc_fn") or {}
    class_weights = None
    if cls_cfg.get("balance_classes"):
        # inverse-frequency CE weights from the dataset's class counts
        class_weights = {task: balance_weights_from_counts(
            train_dataset.classes_counts[task], n, device=device)
            for task, n in num_classes.items()}
    if op_cfg.get("name") == "pred_future_feat":
        train_step = _ssl_step(cfg, op_cfg, batch0, model, optimizer, num_classes,
                               class_weights)
    else:
        train_step = make_train_step(model, optimizer, loss_weights(cfg), num_classes,
                                     class_weights=class_weights, preprocess_fn=train_pp_fn)
    unroll_steps = int(cfg["train"].get("unroll_steps") or 1)
    multi_step = make_multi_step(train_step, unroll_steps) if unroll_steps > 1 else None
    eval_step = make_eval_step(
        model, num_classes,
        store_endpoint=cfg["eval"]["eval_fn"].get("store_endpoint", "logits"),
        preprocess_fn=eval_pp_fn)

    # ReduceLROnPlateau: stepped on the eval metric after each eval
    plateau = None
    scfg = cfg["opt"]["scheduler"]
    if scfg.get("name") == "reduce_lr_on_plateau":
        plateau = ReduceLROnPlateau(
            mode=scfg.get("mode", "min"),
            factor=scfg.get("factor", 0.1),
            patience=scfg.get("patience", 10),
            threshold=scfg.get("threshold", 1e-4),
            threshold_mode=scfg.get("threshold_mode", "rel"),
            cooldown=scfg.get("cooldown", 0),
        )

    last_eval = {}

    def eval_fn(epoch: float) -> float:
        metric = evaluate(
            eval_step, eval_loaders, save_dir=work_dir, epoch=epoch,
            store=cfg["eval"]["eval_fn"].get("store", True),
            only_run_featext=only_featext, logger=logger, device=device)
        last_eval["metric"] = metric
        return metric

    if cfg.get("test_only"):
        return eval_fn(0.0)

    tcfg = cfg["train"]["train_one_epoch_fn"]
    # graceful preemption: SIGTERM (cluster preemption) and SIGUSR1 (the
    # timeout notice submitit listens for) checkpoint at the next chunk
    # boundary and raise Preempted; a relaunch auto-resumes from there
    run_training(
        graceful_signals=(signal.SIGTERM, signal.SIGUSR1),
        train_step=train_step,
        model=model,
        optimizer=optimizer,
        train_loader=train_loader,
        eval_fn=eval_fn if eval_loaders else None,
        num_epochs=cfg["train"]["num_epochs"],
        multi_step=multi_step,
        unroll_steps=unroll_steps,
        plateau=plateau,
        ckpt_dir=work_dir,
        eval_freq=cfg["train"].get("eval_freq", 1),
        store_best=cfg["train"].get("store_best", False),
        print_freq=tcfg.get("print_freq", 10),
        print_large_freq=tcfg.get("print_large_freq", 1000),
        save_freq=tcfg.get("save_freq"),
        save_freq_min=tcfg.get("save_freq_min"),
        save_intermediates=tcfg.get("save_intermediates", False),
        seed=seed,
        logger=logger,
        tb_dir=os.path.join(work_dir, "tb"),
    )
    if not eval_loaders:
        return 0.0
    # the loop evals after epochs 0, eval_freq, ...; when it evaluated the
    # final epoch, that metric is the run's (the reference does not eval
    # again after its loop, func/train.py:816-841)
    n_ep = cfg["train"]["num_epochs"]
    efreq = cfg["train"].get("eval_freq", 1)
    if "metric" in last_eval and efreq and (n_ep - 1) % efreq == 0:
        return last_eval["metric"]
    return eval_fn(float(n_ep))


def cli(argv=None):
    """Parse `argv` (sys.argv[1:] when None) and run every sweep variant
    (or the one --run-id picks); returns their metrics."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--config-file", default=None,
                        help="TXT experiment file of overrides")
    parser.add_argument("--conf-dir", default=str(CONF_DIR))
    parser.add_argument("--run-dir", default=None,
                        help="Work dir (default OUTPUTS/<expt>/<run_id>)")
    parser.add_argument("--run-id", type=int, default=None,
                        help="Pick one sweep variant; default: run all")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    overrides = []
    if args.config_file:
        overrides += parse_overrides_file(args.config_file)
    overrides += [parse_override(o) for o in args.overrides]
    variants = expand_sweeps(overrides)
    composer = Composer(args.conf_dir)
    logger = get_logger("avt_tpu_torch.train")
    results = []
    for run_id, variant in enumerate(variants):
        if args.run_id is not None and run_id != args.run_id:
            continue
        cfg = composer.compose("config", variant)
        if args.run_dir:
            work_dir = args.run_dir
        else:
            expt = Path(args.config_file).stem if args.config_file else "default"
            work_dir = os.path.join("OUTPUTS", expt, str(run_id))
        os.makedirs(work_dir, exist_ok=True)
        logger.info("Run %d -> %s", run_id, work_dir)
        # run.pid lets a launcher stop this run by its exact PID
        pid_file = os.path.join(work_dir, "run.pid")
        with open(pid_file, "w") as f:
            f.write(str(os.getpid()))
        try:
            results.append(main(cfg, work_dir))
        except Preempted as e:
            # 128 + SIGTERM, so that a scheduler tells preemption (requeue)
            # from failure
            logger.info("%s — exiting for requeue", e)
            sys.exit(143)
        finally:
            try:
                os.remove(pid_file)
            except OSError:
                pass
    return results


if __name__ == "__main__":
    cli()
