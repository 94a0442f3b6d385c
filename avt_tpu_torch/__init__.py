"""avt_tpu_torch: the PyTorch/CUDA port of avt_tpu, for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax or avt_tpu. Entry points run on CUDA unless device="cpu" is asked for.
Ported so far: the 3-crop serving forward of the AVT-b + AVT-h flagship
(`build_avt`, `VideoPreprocessor.eval_fn`, `make_eval_forward`,
`batch_predict`), with its ViT attention on a hand-written sm_90a kernel
(ops/csrc/short_attention_fwd.cu).
"""
from avt_tpu_torch.data.transforms import VideoPreprocessor
from avt_tpu_torch.models.convert import load_jax_params, params_from_jax
from avt_tpu_torch.models.flagship import build_avt
from avt_tpu_torch.serve import batch_predict, make_eval_forward

__all__ = [
    "VideoPreprocessor",
    "batch_predict",
    "build_avt",
    "load_jax_params",
    "make_eval_forward",
    "params_from_jax",
]
