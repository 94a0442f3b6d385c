"""Losses."""
from avt_tpu_torch.losses.mse import MSELoss, NormedMSE, l2_normalize, mse, normed_mse
from avt_tpu_torch.losses.xent import (
    MultiDimCrossEntropy,
    QuantizeAndCrossEntropy,
    multidim_cross_entropy,
    quantize_and_cross_entropy,
)

__all__ = ["MSELoss", "MultiDimCrossEntropy", "NormedMSE", "QuantizeAndCrossEntropy",
           "l2_normalize", "mse", "multidim_cross_entropy", "normed_mse",
           "quantize_and_cross_entropy"]
