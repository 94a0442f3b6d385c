"""Attention maps of AVT-h rollouts through the PyTorch port (the paper's
figures).

The counterpart of tools/viz_attention.py: decode a clip with the port's
video reader (the native libav decoder, or OpenCV where it does not build),
run the config's eval preprocessing, forward the model with
output_attentions=True on the GPU (`attention_maps`, which returns the
`gpt2_att_<k>` maps as numpy), then render on the host

  * per rollout step: a (layer x head) grid of (Tq, Tk) attention
    heatmaps, `step<k>_heads.png`;
  * per rollout step: the observed frames in a strip with a bar under
    each showing how much the final (anticipation) query attends to it,
    averaged over layers and heads, `step<k>_overlay.png`.
matplotlib is imported by the renderers alone.

Usage:
  python tools/torch_viz_attention.py VIDEO -c expts/01_ek100_avt.txt \\
      [--ckpt CKPT] [--num-classes 3806] [--start 0 --end 4] \\
      [-o attention_viz] [extra key=value overrides]

The config must use the AVTh future predictor and a raw-video backbone
(feature-store configs have no clip to decode).
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"


def decode_frames(video: str, start: float, end: float, num_frames: int) -> np.ndarray:
    """(num_frames, H, W, 3) uint8: the clip's frames, subsampled uniformly."""
    from avt_tpu_torch.config.registry import resolve_target

    reader = resolve_target("datasets.reader_fns.DefaultReader")()
    frames, _info = reader(video, start, end, None, None)
    if frames.shape[0] == 0:
        raise SystemExit(f"could not decode any frames from {video}")
    idx = np.linspace(0, frames.shape[0] - 1, num_frames).round().astype(int)
    return frames[idx]


def compose(config_file: str, overrides=(), conf_dir=str(CONF_DIR)) -> Dict:
    """The config with output_attentions on; refuses configs whose maps
    cannot be drawn."""
    from avt_tpu_torch.config import Composer, parse_override, parse_overrides_file

    parsed = parse_overrides_file(config_file) + [parse_override(o) for o in overrides]
    cfg = Composer(conf_dir).compose("config", parsed)
    fp_target = cfg["model"]["future_predictor"].get("_target_", "")
    if "AVTh" not in fp_target:
        raise SystemExit(f"config's future predictor is {fp_target!r}; attention maps need the "
                         "AVTh GPT-2 head (model/future_predictor=avth)")
    cfg["model"]["future_predictor"]["output_attentions"] = True
    if "Identity" in cfg["model"]["backbone"]["_target_"]:
        raise SystemExit("feature-store config: nothing to decode — use a raw-video expt "
                         "(e.g. expts/01) or extract features upstream")
    return cfg


def attention_maps(cfg: Dict, frames: np.ndarray, *, ckpt: Optional[str] = None,
                   num_classes: int = 3806, device=None, model=None) -> Dict[str, np.ndarray]:
    """The model's `gpt2_att_<k>` maps on one clip of uint8 frames (T, H, W,
    3), each (layers, heads, Tq, Tk) of the first view, as numpy. The model
    is built from `cfg` on `device` (the GPU unless 'cpu' or AVT_PLATFORM=cpu
    asks for the CPU) and loaded from `ckpt` by init_from_model, unless
    `model` is given."""
    import torch

    from avt_tpu_torch.config.build import build_model, build_preprocess_fns
    from avt_tpu_torch.models.import_torch import init_from_model
    from avt_tpu_torch.train_net import platform_device

    device = platform_device(device)
    _, eval_pp_fn = build_preprocess_fns(cfg, device)
    if model is None:
        model = build_model(cfg, {"action": num_classes}, {}, device=device)
        if ckpt:
            init_from_model(model, [[ckpt]])
    model.eval()
    with torch.no_grad():
        video = eval_pp_fn(torch.from_numpy(np.ascontiguousarray(frames[None])).to(device))
        outputs, _ = model(video, (1,))
    keys = sorted((k for k in outputs if k.startswith("gpt2_att_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    if not keys:
        raise SystemExit("model returned no gpt2_att_* endpoints")
    # crop and clip views fold into the leading dims; the first is drawn
    return {k: outputs[k].float().cpu().numpy().reshape((-1,) + tuple(outputs[k].shape[-4:]))[0]
            for k in keys}


def render_heads(att, out_path: str, step: int):
    """att: (L, H, Tq, Tk) post-softmax probabilities."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    L, H = att.shape[:2]
    fig, axes = plt.subplots(L, H, figsize=(2.2 * H, 2.0 * L), squeeze=False)
    for li in range(L):
        for hi in range(H):
            ax = axes[li][hi]
            ax.imshow(att[li, hi], cmap="viridis", vmin=0.0, aspect="auto",
                      interpolation="nearest")
            ax.set_xticks([])
            ax.set_yticks([])
            if li == 0:
                ax.set_title(f"head {hi}", fontsize=8)
            if hi == 0:
                ax.set_ylabel(f"layer {li}", fontsize=8)
    fig.suptitle(f"gpt2_att_{step}: query x key attention")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def render_overlay(att, frames, out_path: str, step: int):
    """The frame strip and a bar a frame for the FINAL query (the
    anticipation position): its key weights over the T observed frames,
    averaged over layers and heads, say which past frames drove the
    prediction."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = att.mean(axis=(0, 1))[-1]  # (Tk,)
    T = frames.shape[0]
    w = w[:T]  # keys past the observed frames (the rollout's) are dropped
    w = w / max(float(w.max()), 1e-9)
    fig, axes = plt.subplots(2, T, figsize=(1.6 * T, 2.4),
                             gridspec_kw={"height_ratios": [4, 1]}, squeeze=False)
    for t in range(T):
        axes[0][t].imshow(frames[t])
        axes[0][t].set_xticks([])
        axes[0][t].set_yticks([])
        axes[0][t].set_title(f"t={t}", fontsize=7)
        axes[1][t].bar([0], [float(w[t])], color="crimson")
        axes[1][t].set_ylim(0, 1)
        axes[1][t].set_xticks([])
        axes[1][t].set_yticks([])
    fig.suptitle(f"step {step}: final-query attention over observed frames")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def render(maps: Dict[str, np.ndarray], frames: np.ndarray, out_dir: str):
    """Both figures of every step; returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for key, att in maps.items():
        step = int(key.rsplit("_", 1)[1])
        heads_png = os.path.join(out_dir, f"step{step}_heads.png")
        overlay_png = os.path.join(out_dir, f"step{step}_overlay.png")
        render_heads(att, heads_png, step)
        render_overlay(att, frames, overlay_png, step)
        written += [heads_png, overlay_png]
    return written


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("video", help="video file to decode")
    ap.add_argument("-c", "--config-file", required=True,
                    help="TXT experiment file (raw-video AVTh config)")
    ap.add_argument("--conf-dir", default=str(CONF_DIR))
    ap.add_argument("-o", "--out", default="attention_viz")
    ap.add_argument("--ckpt", default=None,
                    help="init_from_model checkpoint (a torch .pth, or the port's run checkpoint)")
    ap.add_argument("--num-classes", type=int, default=3806,
                    help="action classes for the classifier head (EK100 default; irrelevant "
                         "for the attention maps)")
    ap.add_argument("--start", type=float, default=0.0)
    ap.add_argument("--end", type=float, default=4.0)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from avt_tpu_torch.utils.logging import get_logger

    logger = get_logger("avt_tpu_torch.viz_attention")
    cfg = compose(args.config_file, args.overrides, args.conf_dir)
    frames = decode_frames(args.video, args.start, args.end, cfg["data_eval"]["num_frames"])
    logger.info("Decoded %s -> %s frames of %s", args.video, frames.shape[0], frames.shape[1:3])
    maps = attention_maps(cfg, frames, ckpt=args.ckpt, num_classes=args.num_classes,
                          device=device)
    written = render(maps, frames, args.out)
    for key in maps:
        logger.info("%s: %s", key, maps[key].shape)
    print("\n".join(written))
    return written


if __name__ == "__main__":
    main()
