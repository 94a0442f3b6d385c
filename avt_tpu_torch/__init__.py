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
is not re-exported here, where its name would hide the subpackage).
"""
from avt_tpu_torch.data.transforms import VideoPreprocessor
from avt_tpu_torch.losses import multidim_cross_entropy
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.models.flagship import build_avt
from avt_tpu_torch.serve import batch_predict, make_eval_forward
from avt_tpu_torch.train import (
    basic_loss_accuracy,
    build_optimizer,
    build_schedule,
    make_eval_step,
    make_multi_step,
    make_train_step,
    restore_checkpoint,
    run_training,
    save_checkpoint,
)

__all__ = [
    "VideoPreprocessor",
    "basic_loss_accuracy",
    "batch_predict",
    "build_avt",
    "build_optimizer",
    "build_schedule",
    "load_jax_params",
    "make_eval_forward",
    "make_eval_step",
    "make_multi_step",
    "make_train_step",
    "multidim_cross_entropy",
    "params_from_jax",
    "restore_checkpoint",
    "run_training",
    "save_checkpoint",
]
