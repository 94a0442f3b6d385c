"""The profile pass of a traced run (torch.profiler over a few steps or
requests after the window) and what the per-layer readers take from it:
the device's busy time, the device operations by name, the device time of
a custom op or a profiler range, and the idle gaps by what the host was
doing."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

# device activities that are copies or fills, not kernels
NON_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")
# the benchmark's own profiler ranges, which the trace also shows as device spans
RANGES = ("portbench.",)
TOP = 10


@dataclass
class Profile:
    units: int  # steps or requests profiled
    window_s: float  # host clock over the profiled units, synchronised
    busy_s: float  # union of the device activities' intervals
    kernels: List[Tuple[str, float, float]]  # (name, start_us, dur_us) of each kernel
    copies: List[Tuple[float, float]]  # (start_us, end_us) of each copy or fill
    host_ops: List[Tuple[str, float, float]]  # (name, start_us, end_us) of the CPU events
    op_device_s: Dict[str, float] = field(default_factory=dict)  # CPU event name -> device s

    def op_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside CPU events `name`
        (a custom op or a profiler range)."""
        return self.op_device_s.get(name, 0.0)

    def kernel_s(self, patterns) -> float:
        """Device seconds of the kernels whose name holds one of `patterns`."""
        return sum(d for n, _, d in self.kernels
                   if any(p in n.lower() for p in patterns)) / 1e6

    def device_ops(self) -> List[List]:
        totals: Dict[str, float] = {}
        for n, _, d in self.kernels:
            totals[n] = totals.get(n, 0.0) + d / 1e6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in top]

    def idle_gaps(self) -> List[List]:
        """Idle time between device activities, summed by the innermost host
        event running at the gap's middle."""
        spans = sorted([(s, s + d) for _, s, d in self.kernels] + self.copies)
        gaps = []
        end = None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        names = [n for n, _, _ in self.host_ops]
        h0 = np.array([s for _, s, _ in self.host_ops], dtype=np.float64)
        h1 = np.array([e for _, _, e in self.host_ops], dtype=np.float64)
        totals: Dict[str, float] = {}
        for g0, g1 in gaps[:200]:
            mid = (g0 + g1) / 2
            inside = np.flatnonzero((h0 <= mid) & (h1 >= mid))
            name = "host (no profiled op)"
            if inside.size:
                name = names[inside[np.argmin(h1[inside] - h0[inside])]]
            totals[name] = totals.get(name, 0.0) + (g1 - g0) / 1e6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in top]


def _union_s(spans) -> float:
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def profile(run_unit: Callable[[int], None], units: int, ops: Tuple[str, ...]) -> Profile:
    """Profiles `units` calls of run_unit(i) after one unprofiled call;
    `ops` are the CPU event names whose device time the readers ask for."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run_unit(0)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            run_unit(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels, copies, host = [], [], []
    op_s: Dict[str, float] = {}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(RANGES):
                continue
            if any(e.name.startswith(p) for p in NON_KERNEL):
                copies.append((start, end))
            else:
                kernels.append((e.name, start, end - start))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, start, end))
            if e.name in ops and not _nested(e):
                op_s[e.name] = op_s.get(e.name, 0.0) + e.device_time_total / 1e6
    busy = _union_s([(s, s + d) for _, s, d in kernels] + copies)
    return Profile(units, window_s, busy, kernels, copies, host, op_s)


def _nested(event) -> bool:
    """Whether a CPU event sits inside another of its name (a custom op's
    autograd and device dispatches), whose device time already holds it."""
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == event.name:
            return True
        parent = parent.cpu_parent
    return False

