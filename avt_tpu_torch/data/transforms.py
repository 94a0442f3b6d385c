"""Device-side video preprocessing, eval path.

Counterpart of avt_tpu/data/transforms.py (`_interp_taps`,
`resize_bilinear_torch`, `_parse_size`, `VideoPreprocessor.eval_fn`):
uint8 (B, T, H, W, 3) frames -> normalised (B, #crops, 3, T, crop, crop),
with the reference's eval pipeline: /255 -> Resize (torch-exact bilinear,
no antialias) -> scale/reverse/Normalize -> 1 or 3 crops (+ flipped
copies). The train path comes with training.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avt_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def _interp_taps(in_size: int, out_size: int):
    """(lo, hi, frac) of torch's 1-D bilinear sampling (align_corners=False):
    output i samples src = (i+0.5)*in/out - 0.5, clamped to >= 0; value =
    x[lo]*(1-frac) + x[lo+1]*frac with the upper tap edge-clamped.

    torch's kernel evaluates scale*(i+0.5)-0.5 with one fused multiply-add
    on a float32 scale; an exact float64 product of the f32 scale, cast once,
    gives the same single rounding."""
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.arange(out_size)
    src = ((idx + 0.5) * np.float64(scale) - 0.5).astype(np.float32)
    src = np.maximum(src, np.float32(0.0))
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    return lo, hi, frac


def _resize_axis_torch(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if out_size == in_size:
        return x.float()
    lo, hi, frac = _interp_taps(in_size, out_size)
    # the two-tap arithmetic is always f32, torch's kernel precision, for any
    # input type (uint8-range pixels are exact in bf16)
    lo_v = x.index_select(axis, torch.from_numpy(lo).to(x.device)).float()
    hi_v = x.index_select(axis, torch.from_numpy(hi).to(x.device)).float()
    shape = [1] * x.dim()
    shape[axis] = out_size
    f = torch.from_numpy(frac).to(x.device).reshape(shape)
    return lo_v * (1.0 - f) + hi_v * f


def resize_bilinear_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch-exact bilinear resize (antialias=False) of (..., H, W, C);
    returns float32 for any input type."""
    x = _resize_axis_torch(x, out_h, x.dim() - 3)
    return _resize_axis_torch(x, out_w, x.dim() - 2)


def _parse_size(size: Union[int, str]) -> Tuple[int, int]:
    """'248-280' -> (248, 280); 224 -> (224, 224) (a fixed 'range')."""
    if isinstance(size, str):
        lo, hi = [int(el) for el in size.split("-")]
        return lo, hi
    return int(size), int(size)


class VideoPreprocessor:
    """Eval-time preprocessing on `device` (CUDA unless device="cpu")."""

    def __init__(
        self,
        crop_size: Optional[int] = 224,
        scale_h: Union[int, str] = 256,
        scale_w: Union[int, str] = -1,
        mean: Sequence[float] = (0.43216, 0.394666, 0.37645),
        std: Sequence[float] = (0.22803, 0.22145, 0.216989),
        scale_pix_val: float = 1.0,
        reverse_channels: bool = False,
        eval_num_crops: int = 1,
        eval_flip_crops: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        out_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        """compute_dtype: type of the full-resolution frames the resize
        gathers from (bf16 holds 0..255 exactly and halves the traffic; the
        interpolation itself is f32). out_dtype: type of the returned video."""
        self.device = resolve_device(device)
        self.crop_size = crop_size
        self.scale_h = scale_h
        self.scale_w = scale_w
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self.scale_pix_val = scale_pix_val
        self.reverse_channels = reverse_channels
        self.eval_num_crops = eval_num_crops
        self.eval_flip_crops = eval_flip_crops
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype

    def _finalize(self, x: torch.Tensor) -> torch.Tensor:
        """scale_pix_val -> channel reverse -> normalize; x (..., 3)."""
        x = x * self.scale_pix_val
        if self.reverse_channels:
            x = x.flip(-1)
        return ((x - self.mean) / self.std).to(self.out_dtype)

    def _eval_resize_shape(self, H: int, W: int) -> Tuple[int, int]:
        if self.scale_w == -1:
            target = _parse_size(self.scale_h)[0]
            f = target / min(H, W)
            return max(int(H * f), target), max(int(W * f), target)
        return _parse_size(self.scale_h)[0], _parse_size(self.scale_w)[0]

    def eval_fn(self, frames) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 (tensor or numpy) -> (B, #crops, 3, T, crop, crop)."""
        frames = torch.as_tensor(frames).to(self.device)
        B, T, H, W, _ = frames.shape
        cs = self.crop_size
        nh, nw = self._eval_resize_shape(H, W)
        x = resize_bilinear_torch(frames.to(self.compute_dtype), nh, nw)
        x = x / 255.0
        th = tw = cs
        if self.eval_num_crops == 1:
            pos = [(int(round((nh - th) / 2.0)), int(round((nw - tw) / 2.0)))]
        elif self.eval_num_crops == 3:
            pos = [
                (0, 0),
                (int(round((nh - th) / 2.0)), int(round((nw - tw) / 2.0))),
                (nh - th, nw - tw),
            ]
        else:
            raise NotImplementedError(f"{self.eval_num_crops} crops")
        crops = [x[:, :, i:i + th, j:j + tw, :] for i, j in pos]
        if self.eval_flip_crops:
            crops += [c.flip(3) for c in crops]
        out = self._finalize(torch.stack(crops, dim=1))  # (B, #crops, T, th, tw, 3)
        return out.permute(0, 1, 5, 2, 3, 4)  # (B, #crops, 3, T, th, tw)
