"""Losses."""
from avt_tpu_torch.losses.mse import mse

__all__ = ["mse"]
