#!/usr/bin/env python
"""Export a trained run of the PyTorch port as a serving artifact (a
`torch.export` program saved as .pt2).

Composes the run's config, rebuilds the model, restores its checkpoint,
and exports the eval forward, optionally fused with the device-side
preprocessing (raw uint8 frames in), for the given batch geometry:

  python tools/torch_export_model.py -c expts/01_ek100_avt.txt \\
      --ckpt-dir OUTPUTS/01_ek100_avt/0 -o avt.pt2 \\
      -B 16 -T 10 --raw-hw 256 454

  python tools/torch_export_model.py ... --no-preproc   # preprocessed video in
  python tools/torch_export_model.py -c expts/02_ek100_avt_tsn.txt ... \\
      --no-preproc --feat-dim 1024                     # the feature path

--platforms names the one device the program is exported for: cuda (the
hand-written kernels; the default) or cpu (their plain versions).

The artifact loads in a process that imports only avt_tpu_torch.ops:
  from avt_tpu_torch.serve import load_exported, batch_predict
  prog = load_exported('avt.pt2'); probs = batch_predict(prog, frames)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-c", "--config", default=None,
                    help="expts txt of overrides (as train_net takes)")
    ap.add_argument("overrides", nargs="*",
                    help="extra key=value overrides (train_net grammar)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="run dir holding the checkpoint (omit to export with "
                         "the seeded initialisation, e.g. for benchmarks)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-B", type=int, default=16, help="serving batch size")
    ap.add_argument("-T", type=int, default=10, help="frames per clip")
    ap.add_argument("--raw-hw", type=int, nargs=2, default=(256, 454),
                    metavar=("H", "W"),
                    help="raw frame size fed to the fused preprocessing")
    ap.add_argument("--no-preproc", action="store_true",
                    help="export the model-only forward on preprocessed "
                         "(B,1,C,T,crop,crop) video instead of raw frames")
    ap.add_argument("--feat-dim", type=int, default=None,
                    help="with --no-preproc: the feature configs' input, "
                         "(B,T,feat_dim,1,1,1) pre-extracted features")
    ap.add_argument("--outputs", nargs="+", default=["logits/action"])
    ap.add_argument("--platforms", nargs="+", default=["cuda"],
                    help="the device to export for: cuda or cpu (one)")
    ap.add_argument("--separate-params", action="store_true",
                    help="keep params as a runtime argument instead of "
                         "baking them into the artifact")
    args = ap.parse_args(argv)

    from avt_tpu_torch.config import Composer, parse_override, parse_overrides_file
    from avt_tpu_torch.config.build import build_all_datasets, build_model, build_preprocessor
    from avt_tpu_torch.data.dataset import ConcatDataset
    from avt_tpu_torch.serve import export_eval_forward, save_exported
    from avt_tpu_torch.train.checkpoint import restore_checkpoint
    from avt_tpu_torch.train_net import CONF_DIR

    if len(args.platforms) != 1:
        ap.error("--platforms takes one device: a program is exported for one")
    device = args.platforms[0]
    overrides = parse_overrides_file(args.config) if args.config else []
    overrides += [parse_override(o) for o in args.overrides]
    cfg = Composer(str(CONF_DIR)).compose("config", overrides)
    train_datasets, _ = build_all_datasets(cfg)
    train_dataset = (train_datasets[0] if len(train_datasets) == 1
                     else ConcatDataset(train_datasets))
    num_classes = {k: len(v) for k, v in train_dataset.classes.items()}
    model = build_model(cfg, num_classes, train_dataset.class_mappings, device=device)
    if args.ckpt_dir:
        epoch = restore_checkpoint(args.ckpt_dir, model, None)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {args.ckpt_dir}")
        print(f"# restored epoch {epoch:.2f} checkpoint", file=sys.stderr)

    dcfg = cfg.get("data_eval") or cfg["data"]
    pp = None
    if args.no_preproc and args.feat_dim:
        in_shape = (args.B, args.T, args.feat_dim, 1, 1, 1)
    elif args.no_preproc:
        crop = int(dcfg.get("crop_size") or 224)
        in_shape = (args.B, 1, 3, args.T, crop, crop)
    else:
        pp = build_preprocessor(dcfg, device)
        H, W = args.raw_hw
        in_shape = (args.B, args.T, H, W, 3)
    program = export_eval_forward(
        model, in_shape, preprocessor=pp, outputs=tuple(args.outputs),
        platforms=(device,), bake_params=not args.separate_params)
    save_exported(program, args.output)
    print(f"# wrote {args.output}: device={device} in={in_shape} outputs={args.outputs}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
