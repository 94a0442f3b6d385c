"""Losses."""
from avt_tpu_torch.losses.infonce import (
    LARGE_NUM,
    MultiDimSimclrInfoNCE,
    SimclrInfoNCE,
    mil_cross_entropy,
    simclr_infonce,
)
from avt_tpu_torch.losses.mse import MSELoss, NormedMSE, l2_normalize, mse, normed_mse
from avt_tpu_torch.losses.xent import (
    MultiDimCrossEntropy,
    QuantizeAndCrossEntropy,
    multidim_cross_entropy,
    quantize_and_cross_entropy,
)

__all__ = ["LARGE_NUM", "MSELoss", "MultiDimCrossEntropy", "MultiDimSimclrInfoNCE", "NormedMSE",
           "QuantizeAndCrossEntropy", "SimclrInfoNCE", "l2_normalize", "mil_cross_entropy",
           "mse", "multidim_cross_entropy", "normed_mse", "quantize_and_cross_entropy",
           "simclr_infonce"]
