"""Build runtime objects from a resolved config.

Counterpart of avt_tpu/config/build.py (`build_preprocessor`,
`build_preprocess_fns`, `build_dataset`, `build_all_datasets`,
`build_model`, `build_optimizer_from_cfg`, `loss_weights`): the wiring of
the reference's func/train.py:539-844 (transforms -> datasets -> model ->
parameter groups -> optimizer) as build functions over the composed
config dict, onto the port's modules.

`build_model` builds every model of conf/model: the identity, ViT
(`avt_b*`), video-ResNet (r3d_18, r2plus1d_18/34/152, ir/ip-CSN) and
BN-Inception backbones, the last two with `model.bn.{eps,mom}`; the
identity, mean, RULSTM and Transformer aggregators; AVT-h with every option
(rollouts, the KV-cache mode, attention maps, cluster-id inputs and
centroids) and with the Moonlight-16B-A3B decoder as its core (`core:`,
conf/model/future_predictor/avth_mla_moe.yaml), the MLP and identity future
predictors; the linear and MLP classifiers (on the first task only under
`use_cls_mappings`); and AVTModel's options.
"""
from __future__ import annotations

import functools
import logging
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch

from avt_tpu_torch.config.registry import instantiate, resolve_target
from avt_tpu_torch.parallel import ddp

LOG = logging.getLogger(__name__)
DATASET_TRAIN_KEY = "dataset_train"
DATASET_EVAL_KEY = "dataset_eval"


def _torch_dtype(name) -> torch.dtype:
    return torch.bfloat16 if str(name) in ("bf16", "bfloat16") else torch.float32


# ------------------------------------------------------------------ data
def build_preprocessor(data_cfg: Dict, device=None):
    """Preprocessing on the device from a data config (raw-video path)."""
    from avt_tpu_torch.data.transforms import VideoPreprocessor

    return VideoPreprocessor(
        compute_dtype=_torch_dtype(data_cfg.get("compute_dtype") or "float32"),
        out_dtype=_torch_dtype(data_cfg.get("out_dtype") or "float32"),
        crop_size=data_cfg.get("crop_size"),
        scale_h=data_cfg.get("scale_h", 256),
        scale_w=data_cfg.get("scale_w", -1),
        mean=data_cfg.get("mean"),
        std=data_cfg.get("std"),
        flip_p=data_cfg.get("flip_p", 0.5),
        color_jitter_brightness=data_cfg.get("color_jitter_brightness", 0.0),
        color_jitter_contrast=data_cfg.get("color_jitter_contrast", 0.0),
        color_jitter_saturation=data_cfg.get("color_jitter_saturation", 0.0),
        color_jitter_hue=data_cfg.get("color_jitter_hue", 0.0),
        scale_pix_val=data_cfg.get("scale_pix_val", 1.0),
        reverse_channels=data_cfg.get("reverse_channels", False),
        eval_num_crops=data_cfg.get("eval_num_crops", 1),
        eval_flip_crops=data_cfg.get("eval_flip_crops", False),
        device=device,
    )


def build_preprocess_fns(cfg: Dict, device=None):
    """(train_pp_fn(frames, generator), eval_pp_fn(frames)) for the
    raw-video path: uint8 (B, T, H, W, 3) batches to the model's input.
    Train applies the augment pipeline and the subclip fold; eval gives
    (B, #clips, #crops, 3, T', crop, crop) with every crop view stacked."""
    from avt_tpu_torch.data.transforms import fold_subclips

    pp_train = build_preprocessor(cfg["data_train"], device)
    pp_eval = build_preprocessor(cfg["data_eval"], device)
    sub_tr = cfg["data_train"].get("subclips") or {}
    n_tr = sub_tr.get("num_frames") or cfg["data_train"]["num_frames"]
    s_tr = sub_tr.get("stride") or cfg["data_train"]["num_frames"]
    sub_ev = cfg["data_eval"].get("subclips") or {}
    n_ev = sub_ev.get("num_frames") or cfg["data_eval"]["num_frames"]
    s_ev = sub_ev.get("stride") or cfg["data_eval"]["num_frames"]

    def train_pp_fn(frames, generator=None):
        return fold_subclips(pp_train.train_fn(frames, generator), n_tr, s_tr)

    def eval_pp_fn(frames):
        crops = pp_eval.eval_fn(frames)  # (B, #crops, 3, T, cs, cs)
        folded = [fold_subclips(crops[:, i], n_ev, s_ev) for i in range(crops.shape[1])]
        return torch.stack(folded, dim=2)  # (B, #clips, #crops, 3, T', cs, cs)

    return train_pp_fn, eval_pp_fn


def build_dataset(dataset_cfg: Dict, data_cfg: Dict, transform=None):
    """Dataset from its config group and the data config (num_frames ->
    frames_per_clip, subclips, segment labels), as the reference's
    datasets/data.py:get_dataset builds it.

    `_precomputed_metadata_file`: cached video-clip metadata, as a pickle
    (reference datasets/data.py:22-29, 45-55). When the file exists it is
    loaded and handed to the dataset as `_precomputed_metadata`; a dataset
    over torchvision-style decoded clips (`video_clips`) then recomputes
    its clip windows for this config's frame count and rate; when the file
    does not exist, rank 0 saves the dataset's `metadata` to it (written
    to a temporary name and renamed, so that a crash or a concurrent reader
    never sees a truncated pickle), or warns when the dataset has none."""
    cfg = dict(dataset_cfg)
    precomp_fpath = cfg.pop("_precomputed_metadata_file", None)
    precomp_kwargs = {}
    if precomp_fpath and os.path.exists(precomp_fpath):
        with open(precomp_fpath, "rb") as f:
            precomp_kwargs["_precomputed_metadata"] = pickle.load(f)
    reader_cfg = cfg.pop("reader_fn", None)
    reader = (instantiate(reader_cfg) if reader_cfg is not None
              else resolve_target("datasets.reader_fns.DefaultReader")())
    conv_cfg = cfg.pop("conv_to_anticipate_fn", None)
    conv = instantiate(conv_cfg, _partial_=True) if conv_cfg else None
    conv_rt_cfg = cfg.pop("conv_to_anticipate_fn_runtime", None)
    conv_rt = instantiate(conv_rt_cfg, _partial_=True) if conv_rt_cfg else None
    # dense clip sampling for SSL and feature extraction
    dense_cfg = cfg.pop("sample_clips_densely_fn", None)
    if cfg.pop("sample_clips_densely", False) and dense_cfg is None:
        dense_cfg = {"_target_": "datasets.base_video_dataset.dense_clip_sampler"}
    dense_fn = None
    if dense_cfg is not None:
        dense_fn = _build_dense_sampler(dict(dense_cfg), cfg.get("root", ""))
    subclips = dict(data_cfg.get("subclips") or {})
    num_frames = data_cfg.get("num_frames", 16)
    subclips_options = {
        "num_frames": subclips.get("num_frames") or num_frames,
        "stride": subclips.get("stride") or num_frames,
    }
    kwargs = dict(
        frames_per_clip=num_frames,
        frame_rate=data_cfg.get("frame_rate"),
        subclips_options=subclips_options,
        load_seg_labels=data_cfg.get("load_seg_labels", False),
        reader=reader,
        transform=transform,
        conv_to_anticipate_fn=conv,
        conv_to_anticipate_fn_runtime=conv_rt,
        sample_clips_densely_fn=dense_fn,
    )
    ar_cfg = cfg.pop("annot_reader_fn", None)
    if ar_cfg is not None:
        ar = dict(ar_cfg)
        bfn = ar.get("bundle_entry_to_vname_fn")
        if isinstance(bfn, dict):
            ar["bundle_entry_to_vname_fn"] = resolve_target(bfn["_target_"])
        elif isinstance(bfn, str):
            ar["bundle_entry_to_vname_fn"] = resolve_target(bfn)
        kwargs["annot_reader_fn"] = instantiate(ar, _partial_=True)
    kwargs.update({k: v for k, v in cfg.items() if k != "_target_"})
    kwargs.update(precomp_kwargs)
    target = resolve_target(cfg["_target_"])
    ds = target(**{k: v for k, v in kwargs.items() if v is not None or k in (
        "frame_rate", "transform", "conv_to_anticipate_fn")})
    if hasattr(ds, "video_clips"):
        ds.video_clips.compute_clips(num_frames, 1, frame_rate=data_cfg.get("frame_rate"))
    if precomp_fpath and not os.path.exists(precomp_fpath):
        metadata = getattr(ds, "metadata", None)
        if metadata is None:
            LOG.warning("_precomputed_metadata_file=%s configured but %s has no .metadata "
                        "attribute; skipping save", precomp_fpath, type(ds).__name__)
        elif ddp.rank() == 0:
            tmp = f"{precomp_fpath}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(metadata, f)
            os.replace(tmp, precomp_fpath)
    return ds


def _build_dense_sampler(dense_cfg: Dict, root) -> Any:
    """`dense_clip_sampler` with each video's length probed by the video
    decoder, the videos sharded per process and, with featext_skip_done,
    the uids of an earlier extraction's results skipped (the reference's
    base_video_dataset.py:200-267)."""
    from avt_tpu_torch.data.anticipation import dense_clip_sampler, get_abs_path

    dense_cfg.pop("_target_", None)
    featext_skip_done = dense_cfg.pop("featext_skip_done", False)
    results_dir = dense_cfg.pop("featext_results_dir", "./results")
    shard_per_worker = dense_cfg.pop("shard_per_worker", False)
    rank, world = 0, 1
    if shard_per_worker:  # by data replica: model peers read the same videos
        rank, world = ddp.data_rank(), ddp.data_world()
    skip_uids = set()
    if featext_skip_done:
        from avt_tpu_torch.evaluate.results import read_saved_results_uids

        skip_uids = read_saved_results_uids(os.path.join(results_dir, str(rank)))
        LOG.info("featext resume: %d uids already done", len(skip_uids))
    roots = [root] if isinstance(root, str) else list(root or [""])

    def video_len_fn(path):
        return _video_len_cached(str(get_abs_path(roots, path)))

    return functools.partial(dense_clip_sampler, video_len_fn=video_len_fn, shard=(rank, world),
                             skip_uids=skip_uids, **dense_cfg)


@functools.lru_cache(maxsize=None)
def _video_len_cached(abs_path: str) -> float:
    """A video's duration, probed once a process (a dense-sampled dataset
    may be built twice in a run): by the native decoder, or by OpenCV where
    the decoder does not build (the DefaultReader's rule)."""
    from avt_tpu_torch.data.video_decoder import get_video_info, native_decoder_error

    if native_decoder_error() is None:
        return get_video_info(abs_path)["len"]
    from avt_tpu_torch.data.readers import OpenCVVideoReader

    return OpenCVVideoReader().duration(abs_path)


def build_all_datasets(cfg: Dict) -> Tuple[list, Dict[str, Any]]:
    """Every dataset_train* (to be concatenated) and every dataset_eval*,
    keyed by its suffix (func/train.py:586-599)."""
    train = [build_dataset(cfg[k], cfg["data_train"])
             for k in sorted(cfg) if k.startswith(DATASET_TRAIN_KEY)]
    evals = {k[len(DATASET_EVAL_KEY):]: build_dataset(cfg[k], cfg["data_eval"])
             for k in sorted(cfg) if k.startswith(DATASET_EVAL_KEY)}
    return train, evals


# ----------------------------------------------------------------- model
def _short(target: str) -> str:
    return target.rsplit(".", 1)[-1]


def _not_in_zoo(what: str):
    return NotImplementedError(f"{what} is not in the model zoo")


# the conv backbones' output widths (avt_tpu/config/build.py:_BACKBONE_DIMS);
# the config's model.backbone_dim is not read for them
_BACKBONE_DIMS = {"r3d_18": 512, "r2plus1d_18": 512, "r2plus1d_34": 512, "r2plus1d_152": 2048,
                  "ir_csn_152": 2048, "ip_csn_152": 2048, "ip_csn_50": 2048,
                  "BNInceptionVideo": 1024}


def _validate_backbone_drop(short: str, drop_n: int) -> None:
    """backbone_last_n_modules_to_drop against the truncation the backbones
    are built with. The reference chops the last N children off the built
    backbone (base_model.py:27-33): N=2 strips a torchvision video ResNet's
    avgpool and fc, N=0 suits timm's ViT (built headless) and BN-Inception
    (whose last_linear the reference replaces itself). The port builds each
    headless, so another N, which would have built another network in the
    reference, raises."""
    expected = 0 if short in ("ViT", "BNInceptionVideo") else 2
    if drop_n != expected:
        raise ValueError(
            f"backbone_last_n_modules_to_drop={drop_n} with {short}: the backbone is built "
            f"with the reference's N={expected} truncation; set "
            f"model.backbone_last_n_modules_to_drop={expected}")


_AGGREGATORS = ("IdentityAgg", "MeanAgg", "RULSTMAgg", "TransformerAgg")
_CLASSIFIERS = ("LinearClassifier", "MLPClassifier")


def _zoo(target: str, names, what: str):
    """The port's class of an `avt_tpu.models.<name>` target among `names`."""
    from avt_tpu_torch import models

    if target.startswith("avt_tpu.models.") and _short(target) in names:
        return getattr(models, _short(target))
    raise _not_in_zoo(f"{what} {_short(target)}")


def build_model(cfg: Dict, num_classes: Dict[str, int], class_mappings: Dict, *,
                device=None, generator: Optional[torch.Generator] = None):
    """The AVTModel of cfg['model'] on `device` (CUDA unless the CPU is
    asked for), in eval mode, its weights drawn from `generator` (on that
    device; seeded from cfg['seed'] when None) with the JAX package's
    distributions (`flagship.init_weights`)."""
    from avt_tpu_torch import models
    from avt_tpu_torch.models.flagship import init_weights
    from avt_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    mcfg = cfg["model"]

    def sub(group: str) -> Dict:
        c = dict(mcfg[group])
        c.pop("pretrained", None)  # weight init is train.init_from_model's
        return c

    bcfg = sub("backbone")
    btarget = bcfg.pop("_target_")
    drop_n = mcfg.get("backbone_last_n_modules_to_drop", 0)
    if btarget == "avt_tpu.models.IdentityBackbone":
        backbone, backbone_dim = models.IdentityBackbone(), mcfg["backbone_dim"]
    elif btarget == "avt_tpu.models.ViT":
        _validate_backbone_drop("ViT", drop_n)
        if "dtype" in bcfg:
            bcfg["dtype"] = None if bcfg["dtype"] is None else _torch_dtype(bcfg["dtype"])
        backbone = models.ViT(**bcfg, device=device)
        backbone_dim = backbone.embed_dim
    elif btarget.startswith("avt_tpu.models.") and _short(btarget) in _BACKBONE_DIMS:
        short = _short(btarget)
        _validate_backbone_drop(short, drop_n)
        bn = mcfg.get("bn") or {}
        bn_kw = dict(bn_eps=bn.get("eps", 1e-3), bn_mom=bn.get("mom", 0.1), device=device)
        backbone = (models.BNInceptionVideo(**bn_kw) if short == "BNInceptionVideo"
                    else models.VIDEO_RESNETS[short](**bn_kw))
        backbone_dim = _BACKBONE_DIMS[short]
    else:
        raise _not_in_zoo(f"backbone {_short(btarget)}")
    inter_dim = mcfg.get("intermediate_featdim") or backbone_dim

    def build_agg(group: str, in_features: int):
        c = sub(group)
        cls = _zoo(c.pop("_target_"), _AGGREGATORS, "temporal aggregator")
        if cls is models.IdentityAgg or cls is models.MeanAgg:
            if c:
                raise TypeError(f"{cls.__name__} takes no options, got {sorted(c)}")
            return cls(in_features=in_features)
        return cls(in_features=in_features, device=device, **c)

    temporal_aggregator = build_agg("temporal_aggregator", inter_dim)
    agg_dim = temporal_aggregator.output_dim
    agg_dim_out = inter_dim if mcfg.get("same_temp_agg_dim") else agg_dim

    fcfg = sub("future_predictor")
    ftarget = fcfg.pop("_target_")
    fcfg.pop("future_pred_loss_wt", None)  # inert in the reference too
    if ftarget == "avt_tpu.models.AVTh":
        # reference future_prediction.py:66-75: assign_to_centroids is a
        # centroid file (a torch {'weight': K x C} or a .npy), which wins
        # over an array given as `centroids`
        cent = fcfg.pop("assign_to_centroids", None)
        if cent is None:
            cent = fcfg.pop("centroids", None)
        else:
            fcfg.pop("centroids", None)
        if isinstance(cent, str):
            from avt_tpu_torch.models.cluster import load_centroids

            cent = load_centroids(cent)
        loss_cfg = fcfg.pop("future_pred_loss", None)
        floss = instantiate(loss_cfg, reduction="none") if loss_cfg else None
        if "dtype" in fcfg:
            fcfg["dtype"] = None if fcfg["dtype"] is None else _torch_dtype(fcfg["dtype"])
        core_cfg = fcfg.pop("core", None)
        if core_cfg is not None:
            core_cfg = dict(core_cfg)
            name = core_cfg.pop("name")
            if name != "mla_moe":
                raise _not_in_zoo(f"AVT-h core {name}")
            fcfg["core"] = models.MLAMoECore(hidden_size=fcfg.get("inter_dim", 768),
                                             dtype=fcfg.get("dtype"), device=device,
                                             **core_cfg)
        future_predictor = models.AVTh(in_features=agg_dim_out, future_pred_loss=floss,
                                       centroids=cent, device=device, **fcfg)
    elif ftarget == "avt_tpu.models.IdentityFuture":
        future_predictor = models.IdentityFuture(in_features=agg_dim_out)
    elif ftarget == "avt_tpu.models.MLPFuture":
        future_predictor = models.MLPFuture(in_features=agg_dim_out, device=device, **fcfg)
    else:
        raise _not_in_zoo(f"future predictor {_short(ftarget)}")
    fut_dim = future_predictor.output_dim
    after_agg = build_agg("temporal_aggregator_after_future_pred", fut_dim)
    cls_input_dim = after_agg.output_dim

    ccfg = sub("classifier")
    cls = _zoo(ccfg.pop("_target_"), _CLASSIFIERS, "classifier")
    classifiers = {}
    for i, (task, n) in enumerate(num_classes.items()):
        if mcfg.get("use_cls_mappings") and i > 0:
            break  # the other tasks are marginalised from the first
        classifiers[task] = cls(cls_input_dim, n, device=device, **ccfg)
    model = models.AVTModel(
        backbone=backbone,
        temporal_aggregator=temporal_aggregator,
        future_predictor=future_predictor,
        temporal_aggregator_after_future_pred=after_agg,
        classifiers=classifiers,
        num_classes=tuple(num_classes.items()),
        class_mappings=tuple(class_mappings.items()) if mcfg.get("use_cls_mappings") else (),
        backbone_dim=backbone_dim,
        intermediate_featdim=mcfg.get("intermediate_featdim"),
        temp_agg_output_dim=agg_dim,
        same_temp_agg_dim=mcfg.get("same_temp_agg_dim", False),
        project_dim_for_nce=mcfg.get("project_dim_for_nce"),
        dropout=mcfg.get("dropout", 0.0),
        classifier_on_past=mcfg.get("classifier_on_past", False),
        cls_input_dim=cls_input_dim,
        add_regression_head=mcfg.get("add_regression_head", False),
        device=device,
    )
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(cfg.get("seed", 42)))
    init_weights(model, generator)
    return model.eval()


# ------------------------------------------------------------- optimizer
def build_optimizer_from_cfg(cfg: Dict, model, *, iters_per_epoch: int, world_size: int = 1):
    """(optimizer, {group: schedule}) of cfg['opt'] over `model`'s
    parameters (the port's `build_optimizer`). world_size: the number of
    data-parallel replicas (n_data; the JAX package's train_net passes
    it), which scales the learning rate as the reference's does (its
    per-GPU batch times the GPUs)."""
    from avt_tpu_torch.train import build_optimizer

    opt = cfg["opt"]
    opt_cfg = dict(opt["optimizer"])
    opt_name = opt_cfg.pop("name")
    sched_cfg = dict(opt["scheduler"])
    sched_name = sched_cfg.pop("name")
    lr_wd = opt["lr_wd"]
    if opt.get("classifier_only"):
        lr_wd = [["classifiers", lr, wd] for _, lr, wd in lr_wd]
    sched_kwargs = {}
    if sched_name == "cosine":
        sched_kwargs["eta_min"] = sched_cfg.get("eta_min", 0.0)
        num_epochs = sched_cfg.get("num_epochs", cfg["train"]["num_epochs"])
    elif sched_name == "warmup_multi_step":
        sched_kwargs.update(
            milestone_epochs=sched_cfg.get("milestone_epochs", []),
            gamma=sched_cfg.get("gamma", 0.1),
            warmup_factor=sched_cfg.get("warmup_factor", 1.0 / 3),
            scheduler_warmup_epochs=sched_cfg.get("warmup_epochs", 0),
            warmup_method=sched_cfg.get("warmup_method", "linear"),
        )
        num_epochs = cfg["train"]["num_epochs"]
    else:
        if sched_name == "reduce_lr_on_plateau":
            sched_kwargs["min_lr"] = sched_cfg.get("min_lr", 0.0)
        num_epochs = cfg["train"]["num_epochs"]
    # the cosine config already subtracts the warmup through the minus
    # resolver; build_schedule subtracts it again
    warmup_epochs = cfg["opt"]["warmup"].get("num_epochs", 0)
    if sched_name == "cosine":
        num_epochs = num_epochs + warmup_epochs
    return build_optimizer(
        model,
        lr_wd,
        optimizer_name=opt_name,
        scheduler_name=sched_name,
        iters_per_epoch=iters_per_epoch,
        num_epochs=num_epochs,
        world_size=world_size,
        batch_size=cfg["train"]["batch_size"],
        scale_lr_by_bs=opt.get("scale_lr_by_bs", False),
        bias_bn_wd_scale=opt.get("bias_bn_wd_scale", 1.0),
        grad_clip_max_norm=(opt.get("grad_clip") or {}).get("max_norm"),
        warmup_epochs=warmup_epochs,
        warmup_init_lr_ratio=cfg["opt"]["warmup"].get("init_lr_ratio", 0.0),
        optimizer_kwargs=opt_cfg,
        scheduler_kwargs=sched_kwargs,
    )


def loss_weights(cfg: Dict) -> Dict[str, float]:
    return dict(cfg["train"]["train_one_epoch_fn"]["loss_wts"])
