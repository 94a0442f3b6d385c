"""The one general generator. A traffic mix is data (traffic/<mix>.json);
this module makes its inputs and its arrivals from the seed, and the
mix's `driver` (drivers/<driver>.py) offers them to the program.

The keys of a mix:
  driver          the module of portbench/drivers that drives the entry
  clips           clips a train step or a request: a number, or a list of
                  request sizes (serve: the pool holds the list's sizes in
                  turn, in an order drawn from the seed)
  length          frames (video) or features a clip
  pool            train batches or requests made, offered in turn
  batch           (serve) the clips a forward takes; batch_predict pads
                  a request's last batch to it
  arrival         (serve) {"kind": "closed"}: one client, each request sent
                  when the last one returned; {"kind": "poisson",
                  "rate_per_s": r, "burst": b}: bursts of b requests at
                  exponential gaps of mean b / r, answered in arrival order
  profile_units   steps or requests of a traced run's profile pass
  check_requests  (serve) answers compared with the reference, the largest
                  request among them
Every seed gives the same sizes and the same amount of work.

Video frames are uint8 fields with the amplitude spectrum of natural
images (1/f: texture at every scale down to the pixel, with correlated
colour channels), so that a resampling a pixel out, or a crop a few
pixels out, changes what the model sees. Features are standard normal.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from portbench.harness.seeded import sub_seed

FRAME_STD = 48.0  # grey levels, about a frame's contrast; clipped to 0..255
CHROMA = 0.5  # each channel's own field, against the shared luminance field


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _fields(n: int, H: int, W: int, gen: torch.Generator, device) -> torch.Tensor:
    """n standard fields (n, H, W) with a 1/f amplitude spectrum."""
    white = torch.randn((n, H, W), generator=gen, device=device)
    fy = torch.fft.fftfreq(H, device=device)[:, None]
    fx = torch.fft.rfftfreq(W, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx).clamp_min(1.0 / max(H, W))
    x = torch.fft.irfft2(torch.fft.rfft2(white) / f, s=(H, W))
    x = x - x.mean(dim=(-2, -1), keepdim=True)
    return x / x.std(dim=(-2, -1), keepdim=True)


def frames(n: int, H: int, W: int, C: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, H, W, C) uint8 frames."""
    luma = _fields(n, H, W, gen, device)[:, None]
    chroma = _fields(n * C, H, W, gen, device).reshape(n, C, H, W)
    x = (luma + CHROMA * chroma) / (1.0 + CHROMA * CHROMA) ** 0.5
    x = (127.5 + FRAME_STD * x).clamp(0.0, 255.0).round().to(torch.uint8)
    return x.permute(0, 2, 3, 1)


def clips(cfg: dict, n: int, length: int, gen: torch.Generator, device) -> torch.Tensor:
    """n clips: (n, length, H, W, 3) uint8 video or (n, length, C) features."""
    inp = cfg["input"]
    if inp["kind"] == "video":
        H, W, C = inp["frame_shape"]
        per = max(1, 256 // length)  # clips made at once, to bound the FFT's memory
        parts = [frames(min(per, n - i) * length, H, W, C, gen, device)
                 for i in range(0, n, per)]
        return torch.cat(parts).reshape(n, length, H, W, C)
    return torch.randn((n, length, inp["feature_dim"]), generator=gen, device=device)


def sizes(traffic: dict, seed: int) -> List[int]:
    """The clips of each pool entry: the mix's sizes in turn, shuffled by
    the seed (every seed the same sizes)."""
    per = traffic["clips"] if isinstance(traffic["clips"], list) else [traffic["clips"]]
    out = [per[i % len(per)] for i in range(traffic["pool"])]
    if len(per) > 1:
        np.random.default_rng(sub_seed(seed, 4)).shuffle(out)
    return out


def train_pool(cfg: dict, traffic: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """Batches {'video', 'target' (B,), 'target_subclips' (B, T, 1)}, made
    on the card."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    T, A = traffic["length"], cfg["model"]["num_actions"]
    return [{"video": clips(cfg, B, T, gen, device),
             "target": torch.randint(0, A, (B,), generator=gen, device=device),
             "target_subclips": torch.randint(-1, A, (B, T, 1), generator=gen, device=device)}
            for B in sizes(traffic, seed)]


def serve_pool(cfg: dict, traffic: dict, seed: int, device) -> List[np.ndarray]:
    """Requests of uint8 clips on the host, as a server receives them."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    return [clips(cfg, n, traffic["length"], gen, device).cpu().numpy()
            for n in sizes(traffic, seed)]


def arrivals(traffic: dict, seed: int) -> Optional[Iterator[float]]:
    """Seconds from the window's start at which request i arrives; None
    for a closed loop (each request when the last one returned)."""
    arrival = traffic.get("arrival", {"kind": "closed"})
    if arrival["kind"] == "closed":
        return None
    if arrival["kind"] != "poisson":
        raise ValueError(f"arrival {arrival['kind']!r}")
    rng = np.random.default_rng(sub_seed(seed, 5))
    burst, rate = arrival.get("burst", 1), arrival["rate_per_s"]

    def times():
        t = 0.0
        while True:
            t += rng.exponential(burst / rate)
            for _ in range(burst):
                yield t
    return times()


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: at least 5% of the values lie
    at or above it."""
    ordered = sorted(values)
    return ordered[max(0, -(-95 * len(ordered) // 100) - 1)]
