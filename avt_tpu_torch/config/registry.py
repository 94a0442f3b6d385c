"""_target_ registry: maps target strings to the port's constructors.

Counterpart of avt_tpu/config/registry.py (`register_target`,
`resolve_target`, `instantiate`). The same target strings are registered:
the reference's (`datasets.*`, `torch.nn.MSELoss`, `loss_fn.*`) and the
JAX package's native names (`avt_tpu.data.NpyFeatsReader`, ...). These are
strings only: each maps onto the port's class, never onto the JAX package.
"""
from __future__ import annotations

import functools
import logging
from typing import Any, Callable, Dict

LOG = logging.getLogger(__name__)
_REGISTRY: Dict[str, Callable] = {}


def register_target(name: str, fn: Callable = None):
    """Register a constructor under a target name (usable as decorator)."""
    if fn is None:
        return lambda f: register_target(name, f)
    _REGISTRY[name] = fn
    return fn


def resolve_target(name: str) -> Callable:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"Unknown _target_ {name!r}; registered: {sorted(_REGISTRY)}")


def instantiate(cfg: Any, *args, _partial_: bool = False, **kwargs):
    """Build the object described by a {'_target_': ...} dict.

    Like hydra.utils.instantiate with _recursive_=False: nested dicts are
    passed through as plain data; explicit kwargs override config keys.
    """
    if cfg is None:
        return None
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        raise ValueError(f"instantiate needs a dict with _target_: {cfg!r}")
    cfg = dict(cfg)
    target = resolve_target(cfg.pop("_target_"))
    params = {**cfg, **kwargs}
    if _partial_ or params.pop("_partial_", False):
        return functools.partial(target, *args, **params)
    return target(*args, **params)


def _default_video_reader(**kwargs):
    """The raw-video reader: the native libav decoder, or OpenCV when the
    decoder does not build or load (the JAX package's rule). Logs which one
    it took and, on the fallback, why."""
    from avt_tpu_torch.data.readers import OpenCVVideoReader
    from avt_tpu_torch.data.video_decoder import LibavVideoReader, native_decoder_error

    err = native_decoder_error()
    if err is None:
        LOG.info("video reader: LibavVideoReader (the native libav decoder)")
        return LibavVideoReader(**kwargs)
    LOG.warning("video reader: OpenCVVideoReader, as the native decoder is unavailable: %s",
                err)
    return OpenCVVideoReader(**kwargs)


def _register_builtin_targets():
    """Alias the reference's target strings and the JAX package's names."""
    from avt_tpu_torch.data import breakfast_50salads as bf
    from avt_tpu_torch.data.anticipation import convert_to_anticipation, dense_clip_sampler
    from avt_tpu_torch.data.epic_kitchens import EpicKitchens
    from avt_tpu_torch.data.readers import (
        LMDBFeatsReader,
        NpyFeatsReader,
        VideoAsLabelOnehotReader,
    )
    from avt_tpu_torch.losses import (
        MSELoss,
        MultiDimCrossEntropy,
        MultiDimSimclrInfoNCE,
        NormedMSE,
        QuantizeAndCrossEntropy,
        SimclrInfoNCE,
    )

    pairs = {
        # datasets and annotation functions (reference names)
        "datasets.epic_kitchens.EPICKitchens": EpicKitchens,
        "datasets.base_video_dataset.convert_to_anticipation": convert_to_anticipation,
        "datasets.base_video_dataset.dense_clip_sampler": dense_clip_sampler,
        "datasets.epic_kitchens.EpicRULSTMFeatsReader": LMDBFeatsReader,
        "datasets.reader_fns.DefaultReader": _default_video_reader,
        "datasets.reader_fns.VideoAsLabelOnehotReader": VideoAsLabelOnehotReader,
        # losses
        "torch.nn.MSELoss": MSELoss,
        "loss_fn.mse.NormedMSE": NormedMSE,
        "loss_fn.multidim_xentropy.MultiDimCrossEntropy": MultiDimCrossEntropy,
        "loss_fn.multidim_xentropy.QuantizeAndCrossEntropy": QuantizeAndCrossEntropy,
        "loss_fn.simclr_infonce.DistributedSimclrInfoNCELoss": SimclrInfoNCE,
        "loss_fn.simclr_infonce.MultiDimDistributedSimclrInfoNCELoss": MultiDimSimclrInfoNCE,
        # native names
        "avt_tpu.data.EpicKitchens": EpicKitchens,
        "avt_tpu.data.NpyFeatsReader": NpyFeatsReader,
        "avt_tpu.data.LibavVideoReader": _default_video_reader,
        "avt_tpu.data.LMDBFeatsReader": LMDBFeatsReader,
        "avt_tpu.data.convert_to_anticipation": convert_to_anticipation,
        "avt_tpu.data.Breakfast50Salads": bf.Breakfast50Salads,
        "avt_tpu.losses.NormedMSE": NormedMSE,
        "avt_tpu.losses.MSELoss": MSELoss,
    }
    for name in ("Breakfast50Salads", "SenerFeatsReader", "GZFormatReader", "NPYFormatReader",
                 "read_abu_farha_annotations", "read_orig_50salads_annotations",
                 "read_orig_breakfast_annotations", "bundle_entry_to_video_fname_50salads",
                 "bundle_entry_to_video_fname_breakfast"):
        pairs[f"datasets.breakfast_50salads.{name}"] = getattr(bf, name)
    for name, fn in pairs.items():
        register_target(name, fn)


_register_builtin_targets()
