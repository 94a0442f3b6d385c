"""Device-side video preprocessing, eval and train paths.

Counterpart of avt_tpu/data/transforms.py (`_interp_taps`,
`resize_bilinear_torch`, `_parse_size`, `color_jitter`,
`VideoPreprocessor.eval_fn` and `train_fn`): uint8 (B, T, H, W, 3) frames ->
  eval:  /255 -> Resize (torch-exact bilinear, no antialias) ->
         scale/reverse/Normalize -> 1 or 3 crops (+ flipped copies),
         (B, #crops, 3, T, crop, crop);
  train: a random smaller-side scale and crop offset per clip, fused into
         one resize+crop as jax.image.scale_and_translate(method='linear')
         computes it (a triangle kernel widened by 1/scale when it
         downscales) -> /255 -> random flip -> optional color jitter ->
         scale/reverse/Normalize, (B, 3, T, crop, crop).
With a fixed scale_w other than scale_h (conf/data/default.yaml's 128 x 174,
the reference's Resize((h, w)) before its random crop), the train path
resizes to (scale_h, scale_w) instead, each side by its own factor. JAX's
train path refuses that size (it resizes the smaller side only), so that
form is the port's own, with the same resampling.
`fold_subclips` cuts the preprocessed clip into subclips on the device.
The reference's transform library also exports a RandomResizedCrop, a
temporal center crop and UnfoldClips, which no shipped pipeline wires in:
`random_resized_crop` (over `resized_crop_bilinear_torch`, a crop box given
at run time), `temporal_center_crop` and `unfold_clips` are their
counterparts, as in the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

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


def _resize_axis_dynamic(x: torch.Tensor, start, length, out_size: int,
                         axis: int) -> torch.Tensor:
    """One bilinear pass over the window [start, start + length) of `axis`,
    the window given at run time: the taps of `_interp_taps` (src = (i +
    0.5) * length / out - 0.5, clamped at 0, the upper tap clamped inside
    the window), with the scale an f32 division, as JAX computes it for a
    traced box."""
    dev = x.device
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    length = torch.as_tensor(length, dtype=torch.int64, device=dev)
    scale = length.to(torch.float32) / torch.tensor(out_size, dtype=torch.float32, device=dev)
    src = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * scale - 0.5
    src = torch.clamp_min(src, 0.0)
    lo = torch.floor(src)
    frac = src - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.minimum(lo_i + 1, length - 1)
    lo_v = x.index_select(axis, start + lo_i).float()
    hi_v = x.index_select(axis, start + hi_i).float()
    shape = [1] * x.dim()
    shape[axis] = out_size
    f = frac.reshape(shape)
    return lo_v * (1.0 - f) + hi_v * f


def resized_crop_bilinear_torch(x: torch.Tensor, i, j, h, w, out_h: int,
                                out_w: int) -> torch.Tensor:
    """Crop the (i, j, h, w) box of (..., H, W, C) and resize it bilinearly
    to (out_h, out_w): torchvision's `resized_crop` (crop, then
    F.interpolate bilinear without antialiasing), the box given as ints or
    0-d tensors. Taps outside the box clamp to its edge, as torch's do on the
    cropped tensor. Returns float32."""
    x = _resize_axis_dynamic(x, i, h, out_h, x.dim() - 3)
    return _resize_axis_dynamic(x, j, w, out_w, x.dim() - 2)


def random_resized_crop_box(H: int, W: int, area_frac: torch.Tensor, log_ratio: torch.Tensor,
                            u_i, u_j, ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)):
    """The box (i, j, h, w) of torchvision's RandomResizedCrop.get_params
    from its draws: 10 attempts of area `area_frac` * H * W and aspect
    exp(`log_ratio`) ((10,) f32 each), the first that fits wins, placed at
    floor(u * (room + 1)) for the uniforms u_i and u_j; when none fits, the
    whole image clamped to the ratio range (at least a pixel), centered.
    Computed in f32, as the JAX package computes it."""
    area_frac = torch.as_tensor(area_frac, dtype=torch.float32)
    log_ratio = torch.as_tensor(log_ratio, dtype=torch.float32)
    target_area = area_frac * float(H * W)
    ar = torch.exp(log_ratio)
    ws = torch.round(torch.sqrt(target_area * ar)).to(torch.int32)
    hs = torch.round(torch.sqrt(target_area / ar)).to(torch.int32)
    valid = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
    in_ratio = W / H
    if in_ratio < ratio[0]:
        fw, fh = W, max(1, int(round(W / ratio[0])))
    elif in_ratio > ratio[1]:
        fw, fh = max(1, int(round(H * ratio[1]))), H
    else:
        fw, fh = W, H
    if not bool(valid.any()):
        h, w = fh, fw
        return (H - h) // 2, (W - w) // 2, h, w
    pick = int(torch.nonzero(valid)[0, 0])
    h, w = int(hs[pick]), int(ws[pick])

    def offset(u, room):
        u = torch.as_tensor(u, dtype=torch.float32)
        return int(torch.clamp(torch.floor(u * float(room + 1)), 0, room))

    return offset(u_i, H - h), offset(u_j, W - w), h, w


def random_resized_crop(x: torch.Tensor, out_size: Union[int, Tuple[int, int]],
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torchvision's RandomResizedCrop of (..., H, W, C), one box a call,
    so that a (T, H, W, C) clip is cropped the same in every frame. The
    draws come from `generator` (a CPU generator) as area ~ U(scale),
    log aspect ~ U(log ratio) and two offsets ~ U[0, 1); the distribution
    is torchvision's, the draws are not JAX's. Returns float32."""
    out_h, out_w = ((int(out_size), int(out_size)) if isinstance(out_size, int)
                    else (int(out_size[0]), int(out_size[1])))
    H, W = x.shape[-3], x.shape[-2]
    u = torch.rand(22, generator=generator, dtype=torch.float32)
    area_frac = scale[0] + (scale[1] - scale[0]) * u[:10]
    lo, hi = float(np.log(ratio[0])), float(np.log(ratio[1]))
    log_ratio = lo + (hi - lo) * u[10:20]
    i, j, h, w = random_resized_crop_box(H, W, area_frac, log_ratio, u[20], u[21], ratio)
    return resized_crop_bilinear_torch(x, i, j, h, w, out_h, out_w)


def _scale_weights(in_size: int, out_size: int, scale: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) resampling weights of jax.image.scale_and_translate's
    'linear' kernel with antialiasing (jax/_src/image/scale.py
    `compute_weight_mat`), one matrix per clip. Computed, like JAX's, in the
    type of `scale` and `translation` ((B,) each): every operation rounds to
    it, except the column sums, which are taken in f32."""
    dt, dev = scale.dtype, scale.device
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)[:, None]
    sample_f = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)  # (B, out)
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=dt, device=dev)[None, :, None]).abs()
    w = torch.clamp_min(1.0 - (x / kernel_scale).abs(), 0.0)  # triangle
    total = w.float().sum(dim=1, keepdim=True).to(dt)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of (..., 3), torchvision's rgb_to_grayscale."""
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


_YIQ = torch.tensor([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]])
_IYIQ = torch.tensor([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647], [1.0, -1.106, 1.703]])


def color_jitter(x: torch.Tensor, brightness=None, contrast=None, saturation=None,
                 hue=None) -> torch.Tensor:
    """Per-clip color jitter of (B, T, H, W, 3) in [0, 1] with explicit
    factors, (B,) tensors or None for an adjustment left out: brightness ->
    contrast -> saturation -> hue (a YIQ rotation), in that fixed order,
    then clipped to [0, 1]; the same factors for every frame of a clip."""
    def per_clip(f):
        return f.to(x.dtype).reshape(-1, 1, 1, 1, 1)

    if brightness is not None:
        x = x * per_clip(brightness)
    if contrast is not None:
        f = per_clip(contrast)
        x = f * x + (1 - f) * _grayscale(x).mean(dim=(1, 2, 3, 4), keepdim=True)
    if saturation is not None:
        f = per_clip(saturation)
        x = f * x + (1 - f) * _grayscale(x)
    if hue is not None:
        theta = 2 * math.pi * hue.float()
        cos, sin = torch.cos(theta), torch.sin(theta)
        one, zero = torch.ones_like(cos), torch.zeros_like(cos)
        rot = torch.stack([torch.stack([one, zero, zero], -1),
                           torch.stack([zero, cos, -sin], -1),
                           torch.stack([zero, sin, cos], -1)], -2)  # (B, 3, 3)
        m = _IYIQ.to(x.device) @ rot @ _YIQ.to(x.device)
        x = torch.einsum("bthwc,bdc->bthwd", x, m.to(x.dtype))
    return x.clamp(0.0, 1.0)


def _parse_size(size: Union[int, str]) -> Tuple[int, int]:
    """'248-280' -> (248, 280); 224 -> (224, 224) (a fixed 'range')."""
    if isinstance(size, str):
        lo, hi = [int(el) for el in size.split("-")]
        return lo, hi
    return int(size), int(size)


class VideoPreprocessor:
    """Train- and eval-time preprocessing on `device` (CUDA unless
    device="cpu")."""

    def __init__(
        self,
        crop_size: Optional[int] = 224,
        scale_h: Union[int, str] = 256,
        scale_w: Union[int, str] = -1,
        mean: Sequence[float] = (0.43216, 0.394666, 0.37645),
        std: Sequence[float] = (0.22803, 0.22145, 0.216989),
        flip_p: float = 0.5,
        color_jitter_brightness: float = 0.0,
        color_jitter_contrast: float = 0.0,
        color_jitter_saturation: float = 0.0,
        color_jitter_hue: float = 0.0,
        scale_pix_val: float = 1.0,
        reverse_channels: bool = False,
        eval_num_crops: int = 1,
        eval_flip_crops: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        out_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        """compute_dtype: type of the full-resolution frames the resize reads
        (bf16 holds 0..255 exactly and halves the traffic). The eval resize
        interpolates in f32; the train resize+crop, like JAX's, computes its
        weights and products in compute_dtype. out_dtype: type of the
        returned video."""
        self.device = resolve_device(device)
        self.crop_size = crop_size
        self.scale_h = scale_h
        self.scale_w = scale_w
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self.flip_p = flip_p
        self.jitter = (color_jitter_brightness, color_jitter_contrast,
                       color_jitter_saturation, color_jitter_hue)
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

    # -------------------------------------------------------------- train
    def train_draws(self, frames_shape, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """The random draws of `train_fn` for (B, T, H, W, 3) frames, (B,)
        f32 tensors in JAX's order: the smaller side s = floor(U[smin,
        smax + 1)); the crop offsets i, j = floor(U * max(new side - crop,
        0)); flip = U < flip_p; and, for each color jitter > 0, its factor
        (brightness, contrast, saturation ~ U[max(0, 1 - v), 1 + v]; hue ~
        U[-v, v])."""
        B, _, H, W, _ = frames_shape
        smin, smax = _parse_size(self.scale_h)

        def uniform(lo=0.0, hi=1.0):
            u = torch.rand(B, generator=generator, device=self.device, dtype=torch.float32)
            return u * (hi - lo) + lo

        s = torch.floor(uniform(smin, smax + 1.0))
        fh, fw = self._train_scales(s, H, W)
        i = torch.floor(uniform() * torch.clamp_min(H * fh - self.crop_size, 0.0))
        j = torch.floor(uniform() * torch.clamp_min(W * fw - self.crop_size, 0.0))
        draws = {"s": s, "i": i, "j": j, "flip": uniform() < self.flip_p}
        for name, v in zip(("brightness", "contrast", "saturation"), self.jitter[:3]):
            if v > 0:
                draws[name] = uniform(max(0.0, 1 - v), 1 + v)
        if self.jitter[3] > 0:
            draws["hue"] = uniform(-self.jitter[3], self.jitter[3])
        return draws

    def _train_scales(self, s: torch.Tensor, H: int, W: int):
        """The train resize's (height, width) factors for the drawn side s:
        s over the smaller side for both, or, with a fixed scale_w other
        than scale_h, s / H and scale_w / W."""
        if self.scale_w == -1 or self.scale_w == self.scale_h:
            f = s / min(H, W)
            return f, f
        return s / H, torch.full_like(s, _parse_size(self.scale_w)[0] / W)

    def train_crop(self, frames, s: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                   flip: torch.Tensor, **jitter) -> torch.Tensor:
        """The deterministic part of `train_fn`: (B, T, H, W, 3) uint8 and
        per-clip draws -> (B, 3, T, crop, crop). The resize (to smaller side
        s, or to (s, scale_w)) and the crop at (i, j) are one resampling, contracting the width
        first and rounding the intermediate to compute_dtype, as XLA runs
        JAX's einsum."""
        frames = torch.as_tensor(frames).to(self.device)
        B, T, H, W, _ = frames.shape
        cs, dt = self.crop_size, self.compute_dtype
        fh, fw = (f.to(dt) for f in self._train_scales(s.float(), H, W))
        w_h = _scale_weights(H, cs, fh, (-i.float()).to(dt))  # (B, H, cs)
        w_w = _scale_weights(W, cs, fw, (-j.float()).to(dt))  # (B, W, cs)
        x = torch.einsum("bthwc,bwj->bthjc", frames.to(dt), w_w)
        x = torch.einsum("bthjc,bhi->btijc", x, w_h)  # (B, T, cs, cs, 3)
        x = x.float() / 255.0
        x = torch.where(flip.reshape(-1, 1, 1, 1, 1), x.flip(3), x)
        if jitter:
            x = color_jitter(x, **jitter)
        return self._finalize(x).permute(0, 4, 1, 2, 3)

    def train_fn(self, frames, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 -> (B, 3, T, crop, crop): random scale,
        crop, flip (and color jitter) per clip, drawn from `generator` (on
        this preprocessor's device; torch's default when None)."""
        frames = torch.as_tensor(frames).to(self.device)
        return self.train_crop(frames, **self.train_draws(frames.shape, generator))

    # --------------------------------------------------------------- eval
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


def fold_subclips(video: torch.Tensor, num_frames: int, stride: int) -> torch.Tensor:
    """(B, 3, T, H, W) -> (B, #clips, 3, num_frames, H, W): the subclip fold
    of the raw-video path, after the preprocessing on the device. T must be
    tiled exactly."""
    T = video.shape[2]
    if T < num_frames or (T - num_frames) % stride != 0:
        raise ValueError(f"subclips (num_frames={num_frames}, stride={stride}) must tile "
                         f"T={T} exactly")
    return torch.stack([video[:, :, i:i + num_frames]
                        for i in range(0, T - num_frames + 1, stride)], dim=1)


def temporal_center_crop(video: torch.Tensor, clip_len: int) -> torch.Tensor:
    """The center clip_len frames of (..., 3, T, H, W), from T // 2 -
    clip_len // 2 (the reference's start, not (T - clip_len) // 2); a clip
    no longer than clip_len comes back whole."""
    T = video.shape[-3]
    if T <= clip_len:
        return video
    start = T // 2 - clip_len // 2
    return video[..., start:start + clip_len, :, :]


def unfold_clips(video: torch.Tensor, clip_len: int) -> torch.Tensor:
    """(3, T, H, W) -> (#clips, 3, clip_len, H, W), stepping by clip_len
    frames: the reference's UnfoldClips passes clip_len as the step and
    never its computed overlap step, so the port takes no overlap; a clip
    shorter than clip_len comes back whole as one clip."""
    T = video.shape[1]
    if T < clip_len:
        return video[None]
    return torch.stack([video[:, i:i + clip_len]
                        for i in range(0, T - clip_len + 1, clip_len)], dim=0)
