"""Losses."""
from avt_tpu_torch.losses.mse import MSELoss, NormedMSE, l2_normalize, mse, normed_mse
from avt_tpu_torch.losses.xent import MultiDimCrossEntropy, multidim_cross_entropy

__all__ = ["MSELoss", "MultiDimCrossEntropy", "NormedMSE", "l2_normalize", "mse",
           "multidim_cross_entropy", "normed_mse"]
