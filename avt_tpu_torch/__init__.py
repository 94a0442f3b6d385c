"""avt_tpu_torch: the PyTorch/CUDA port of avt_tpu, for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax or avt_tpu. Entry points run on CUDA unless device="cpu" is asked for.
Ported so far: the 3-crop serving forward of the AVT-b + AVT-h flagship
(`build_avt`, `VideoPreprocessor.eval_fn`, `make_eval_forward`,
`batch_predict`), with its ViT attention on a hand-written sm_90a kernel
(ops/csrc/short_attention_fwd.cu); and the flagship train step
(`VideoPreprocessor.train_fn`, `build_optimizer`, `make_train_step`), whose
attention backward is a second one (ops/csrc/short_attention_bwd.cu); and the
feature path of expts/02 (`build_avt(backbone="identity")`, its train step
and `make_eval_step`), whose AVT-h attention over 128 or more observed
features runs on the blocked flash kernels (ops/csrc/flash_attention_fwd.cu
and flash_attention_bwd.cu); and the trainer core around those steps
(`run_training` with `make_multi_step`, `save_checkpoint` and
`restore_checkpoint` with fractional-epoch resume, the meters, and
`avt_tpu_torch.evaluate.evaluate` with its numpy result sink; the function
is not re-exported here, where its name would hide the subpackage); and
the serving export through `torch.export` (`avt_tpu_torch.serve`) and
data-parallel training over processes (`avt_tpu_torch.parallel`,
`avt_tpu_torch.launch`).
"""
import importlib

# name -> the module that defines it; imported at first use (PEP 562), so
# that importing one subpackage (avt_tpu_torch.ops, to load an exported
# program) does not import the models, the config or the trainer
_EXPORTS = {
    "VideoPreprocessor": "avt_tpu_torch.data.transforms",
    "basic_loss_accuracy": "avt_tpu_torch.train",
    "batch_predict": "avt_tpu_torch.serve",
    "build_avt": "avt_tpu_torch.models.flagship",
    "build_optimizer": "avt_tpu_torch.train",
    "build_schedule": "avt_tpu_torch.train",
    "load_jax_params": "avt_tpu_torch.models.convert",
    "make_eval_forward": "avt_tpu_torch.serve",
    "make_eval_step": "avt_tpu_torch.train",
    "make_multi_step": "avt_tpu_torch.train",
    "make_train_step": "avt_tpu_torch.train",
    "multidim_cross_entropy": "avt_tpu_torch.losses",
    "params_from_jax": "avt_tpu_torch.models.convert",
    "restore_checkpoint": "avt_tpu_torch.train",
    "run_training": "avt_tpu_torch.train",
    "save_checkpoint": "avt_tpu_torch.train",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
