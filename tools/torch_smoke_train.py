"""End-to-end trainer smoke of the PyTorch port (on the GPU, unless
AVT_PLATFORM=cpu or main(..., device="cpu") asks for the CPU).

The counterpart of tools/smoke_train.py: fabricates a tiny learnable
EK100-shaped dataset and drives the port's CLI path, compose(conf/) ->
avt_tpu_torch.train_net.main -> training -> eval -> the npz results ->
AR5, with a pass/fail learnability bar.

Two modes:
  default  — RULSTM-style csv annotations + an npy FEATURE store (identity
             backbone + AVT-h; the expts/02 topology).
  --raw    — cv2-written VIDEOS whose pre-action window is tinted by class:
             decode (the native libav decoder, or OpenCV where it does not
             build) -> preprocessing on the device -> a tiny ViT -> AVT-h
             with 3 crops + flips at eval (the expts/01 topology at toy
             scale).

Usage:  python tools/torch_smoke_train.py [--raw] [--epochs N] [--workdir DIR]
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_CLS = 6
C = 16
FPS = 30.0


def make_dataset(root: Path):
    annot = root / "annot"
    annot.mkdir(parents=True)
    (annot / "EPIC_100_verb_classes.csv").write_text(
        "id,key\n" + "\n".join(f"{i},v{i}" for i in range(3))
    )
    (annot / "EPIC_100_noun_classes.csv").write_text(
        "id,key\n" + "\n".join(f"{i},n{i}" for i in range(2))
    )
    (annot / "actions.csv").write_text(
        "id,verb,noun,action\n"
        + "\n".join(f"{i},{i % 3},{i % 2},a{i}" for i in range(N_CLS))
    )
    rng = np.random.default_rng(0)
    feats = root / "feats"
    feats.mkdir()
    rows_tr, rows_ev = [], []
    uid = 0
    for v in range(3):
        n_frames = 9000
        arr = rng.normal(scale=0.3, size=(n_frames, C)).astype(np.float32)
        t = 20.0
        while t < n_frames / FPS - 20:
            cls = int(rng.integers(N_CLS))
            lo, hi = int((t - 12) * FPS), int(t * FPS)
            arr[lo:hi, cls] += 3.0
            line = (
                f"{uid},P0{v}_01,{int(t*FPS)},{int((t+2)*FPS)},"
                f"{cls%3},{cls%2},{cls}"
            )
            (rows_ev if v == 2 else rows_tr).append(line)
            uid += 1
            t += 15.0
        np.save(feats / f"P0{v}_01.npy", arr)
    (annot / "training.csv").write_text("\n".join(rows_tr))
    (annot / "validation.csv").write_text("\n".join(rows_ev))


def make_video_dataset(root: Path):
    """cv2-written videos, pre-action window tinted by class (3 classes)."""
    import cv2

    fps = 10.0
    annot = root / "annot"
    annot.mkdir(parents=True)
    (annot / "EPIC_100_verb_classes.csv").write_text(
        "id,key\n0,v0\n1,v1\n2,v2")
    (annot / "EPIC_100_noun_classes.csv").write_text(
        "id,key\n0,n0\n1,n1\n2,n2")
    (annot / "actions.csv").write_text(
        "id,verb,noun,action\n" + "\n".join(f"{i},{i},{i},a{i}"
                                            for i in range(3)))
    rng = np.random.default_rng(0)
    vids = root / "vids"
    rows = []
    uid = 0
    for v, part in enumerate(["P00", "P01"]):
        (vids / part).mkdir(parents=True)
        path = str(vids / part / f"{part}_01.MP4")
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 48))
        n_frames = 1200
        actions = []
        t = 10.0
        while t < n_frames / fps - 5:
            actions.append((t, int(rng.integers(3))))
            t += 12.0
        for i in range(n_frames):
            sec = i / fps
            frame = np.full((48, 64, 3), 100, np.uint8)
            for (at, cls) in actions:
                if at - 6 <= sec < at:
                    frame[:, :, cls] = 230
            writer.write(frame)
        writer.release()
        for (at, cls) in actions:
            rows.append(f"{uid},{part}_01,{int(at*30)},{int((at+2)*30)},"
                        f"{cls},{cls},{cls}")
            uid += 1
    (annot / "training.csv").write_text("\n".join(rows))


def raw_overrides(tmp: Path, epochs: int):
    """--raw: a toy ViT (2 blocks of width 32 at 32 px) + AVT-h on the
    tinted videos of `make_video_dataset`, 3 crops + flips at eval."""
    return [
        "train.batch_size=4",
        "eval.batch_size=4",
        f"train.num_epochs={epochs}",
        "train.eval_freq=0",  # skip in-loop evals; train_net.main runs the final one
        "train.train_one_epoch_fn.loss_wts.feat=1.0",
        "train.train_one_epoch_fn.save_freq_min=null",
        "model/backbone=avt_b",
        "model.backbone_last_n_modules_to_drop=0",
        "+model.backbone.img_size=32",
        "+model.backbone.patch_size=16",
        "+model.backbone.embed_dim=32",
        "+model.backbone.depth=2",
        "+model.backbone.num_heads=2",
        "model.backbone_dim=32",
        "model/temporal_aggregator=identity",
        "model/future_predictor=avth",
        "+model.future_predictor.n_head=2",
        "+model.future_predictor.n_layer=2",
        "+model.future_predictor.inter_dim=32",
        "+model.future_predictor.output_len=1",
        "+model.future_predictor.avg_last_n=1",
        "+model.future_predictor.return_past_too=true",
        "+model.future_predictor.future_pred_loss={_target_: torch.nn.MSELoss}",
        "opt/scheduler=cosine",
        "opt.lr_wd=[[__all__,0.02,0.000001]]",
        "opt.warmup.num_epochs=1",
        "data_train.num_frames=4",
        "data_train.frame_rate=1",
        "data_train.subclips.num_frames=1",
        "data_train.subclips.stride=1",
        "data_train.scale_h=36-44",
        "data_train.scale_w=-1",
        "data_train.crop_size=32",
        "data_train.mean=[0.5, 0.5, 0.5]",
        "data_train.std=[0.5, 0.5, 0.5]",
        "data_train.workers=2",
        "data_eval.num_frames=4",
        "data_eval.frame_rate=1",
        "data_eval.subclips.num_frames=1",
        "data_eval.subclips.stride=1",
        "data_eval.scale_h=36",
        "data_eval.scale_w=-1",
        "data_eval.crop_size=32",
        "data_eval.mean=[0.5, 0.5, 0.5]",
        "data_eval.std=[0.5, 0.5, 0.5]",
        "data_eval.eval_num_crops=3",
        "data_eval.eval_flip_crops=true",
        "data_eval.workers=2",
        "dataset_train.sample_strategy=last_clip",
        "dataset_eval.sample_strategy=last_clip",
        "dataset_train.conv_to_anticipate_fn.tau_a=1",
        "dataset_train.conv_to_anticipate_fn.tau_o=4",
        "dataset_eval.conv_to_anticipate_fn.tau_a=1",
        "dataset_eval.conv_to_anticipate_fn.tau_o=4",
        f"dataset_train.annotation_path=[{tmp}/annot/training.csv]",
        f"dataset_eval.annotation_path=[{tmp}/annot/training.csv]",
        f"dataset.epic_kitchens100.common.annot_dir={tmp}/annot/",
        f"dataset.epic_kitchens100.common.rulstm_annot_dir={tmp}/annot/",
        f"dataset_train.root=[{tmp}/vids]",
        f"dataset_eval.root=[{tmp}/vids]",
    ]


def feature_overrides(tmp: Path, epochs: int):
    """The default mode: identity backbone + AVT-h on `make_dataset`'s
    16-d npy features."""
    return [
        "train.batch_size=16",
        "eval.batch_size=16",
        f"train.num_epochs={epochs}",
        "train.eval_freq=0",  # no eval inside the loop; train_net.main runs the final one
        "train.train_one_epoch_fn.loss_wts.feat=1.0",
        "train.train_one_epoch_fn.loss_wts.past_cls_action=1.0",
        "train.train_one_epoch_fn.save_freq_min=null",
        "model/backbone=identity",
        f"model.backbone_dim={C}",
        "model/temporal_aggregator=identity",
        "model/future_predictor=avth",
        "model.dropout=0.1",
        "model.classifier_on_past=true",
        "+model.future_predictor.n_head=2",
        "+model.future_predictor.n_layer=2",
        "+model.future_predictor.inter_dim=32",
        "+model.future_predictor.output_len=1",
        "+model.future_predictor.avg_last_n=1",
        "+model.future_predictor.return_past_too=true",
        "+model.future_predictor.future_pred_loss={_target_: torch.nn.MSELoss}",
        "opt/scheduler=cosine",
        "opt.lr_wd=[[__all__,0.01,0.000001]]",
        "opt.optimizer.nesterov=true",
        "opt.warmup.num_epochs=1",
        "data_train.num_frames=10",
        "data_train.frame_rate=1",
        "data_train.subclips.num_frames=1",
        "data_train.subclips.stride=1",
        "data_train.workers=2",
        "data_eval.num_frames=10",
        "data_eval.frame_rate=1",
        "data_eval.subclips.num_frames=1",
        "data_eval.subclips.stride=1",
        "data_eval.workers=2",
        "dataset_train.sample_strategy=last_clip",
        "dataset_eval.sample_strategy=last_clip",
        "dataset_train.conv_to_anticipate_fn.tau_a=1",
        "dataset_train.conv_to_anticipate_fn.tau_o=10",
        "dataset_eval.conv_to_anticipate_fn.tau_a=1",
        "dataset_eval.conv_to_anticipate_fn.tau_o=10",
        f"dataset_train.annotation_path=[{tmp}/annot/training.csv]",
        f"dataset_eval.annotation_path=[{tmp}/annot/validation.csv]",
        f"dataset.epic_kitchens100.common.annot_dir={tmp}/annot/",
        f"dataset.epic_kitchens100.common.rulstm_annot_dir={tmp}/annot/",
        f"dataset_train.root={tmp}/feats",
        f"dataset_eval.root={tmp}/feats",
        "+dataset_train.reader_fn={_target_: avt_tpu.data.NpyFeatsReader, "
        f"root: {tmp}/feats, read_type: normal}}",
        "+dataset_eval.reader_fn={_target_: avt_tpu.data.NpyFeatsReader, "
        f"root: {tmp}/feats, read_type: normal}}",
    ]


def compose(overrides):
    """The port's config of an override list."""
    from avt_tpu_torch.config import Composer, parse_override
    from avt_tpu_torch.train_net import CONF_DIR

    return Composer(str(CONF_DIR)).compose("config", [parse_override(o) for o in overrides])


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", action="store_true",
                    help="raw-video mode: decode + preprocessing on the device + tiny ViT "
                         "(expts/01 topology at toy scale)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--min-metric", type=float, default=None,
                    help="AR5 bar (default: 60 feature mode / 50 raw mode)")
    args = ap.parse_args(argv)
    if args.min_metric is None:
        args.min_metric = 50.0 if args.raw else 60.0
    tmp = Path(tempfile.mkdtemp(prefix="avt_torch_smoke_"))
    if args.raw:
        make_video_dataset(tmp)
        return run(raw_overrides(tmp, args.epochs), tmp, args, device)
    make_dataset(tmp)
    return run(feature_overrides(tmp, args.epochs), tmp, args, device)


def run(overrides, tmp: Path, args, device=None) -> int:
    from avt_tpu_torch.train_net import main as train_main, platform_device

    cfg = compose(overrides)
    work_dir = args.workdir or str(tmp / "run")
    os.makedirs(work_dir, exist_ok=True)
    device = platform_device(device)
    print(f"# smoke: device={device} workdir={work_dir}", flush=True)
    metric = train_main(cfg, work_dir, device=device)
    print(f"# smoke: final primary metric (AR5 %) = {metric:.2f}")
    ok = metric > args.min_metric
    print("SMOKE OK" if ok else "SMOKE FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
