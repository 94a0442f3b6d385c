"""What the readers of the port's spans share (the metrics of source
`program_span`): the program's `avt.` ranges (avt_tpu_torch/utils/trace.py)
in the profile pass, the device time of the activities launched under
each, and the synchronising CUDA runtime calls inside them. A program
without the ranges gives every reader None.

The profile pass (profile.py) keeps each CPU event as (name, host start,
host end), runtime calls included, and each device activity as (name,
device start, duration), on the trace's one clock, but not which call
launched which activity. On one stream the device starts activities in the
order the host queued them: the k-th kernel launch call queued the k-th
kernel, and the k-th copy or fill call the k-th copy or fill. Calls are
matched to activities by that order, each kind on its own; where a kind's
counts differ (`Spans.counts` shows it), each activity takes the next call
that began before it started. An activity belongs to every span open on
the host when its call began, whatever thread made the call (autograd's
device thread launches the backward inside the caller's span); the
innermost of them is its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "avt."
KERNEL_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                          "cuLaunchCooperativeKernel"})
COPY_CALLS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")  # name prefixes
# calls that block the host until the device has done the work queued before
# them; a copy call without `Async` in its name blocks too
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize",
                        "cuEventSynchronize"})


def is_sync(name: str) -> bool:
    return name in SYNC_CALLS or (name.startswith(("cudaMemcpy", "cuMemcpy"))
                                  and "Async" not in name)


@dataclass
class Spans:
    """The `avt.` ranges of a profile pass and the device activities
    launched under them; times in us on the trace's clock."""
    units: int
    names: np.ndarray  # of each range
    start: np.ndarray
    end: np.ndarray
    act_start: np.ndarray  # of each device activity (kernels, then copies and fills)
    act_dur: np.ndarray
    call_start: np.ndarray  # of the call that launched it (nan: none matched)
    counts: Dict[str, Tuple[int, int]]  # kind -> (calls, activities)
    syncs: List[Tuple[float, float]]  # (start, end) of each synchronising call

    def _holds(self) -> np.ndarray:
        """(activity, range): the range was open when the activity's call began."""
        c = self.call_start[:, None]
        return (self.start[None, :] <= c) & (c <= self.end[None, :])

    def has(self, name: str) -> bool:
        return bool((self.names == name).any())

    def device_s(self, name: str) -> float:
        """Device seconds of the activities launched inside a range `name`
        (its child ranges' included)."""
        under = self._holds()[:, self.names == name].any(axis=1)
        return float(self.act_dur[under].sum()) / 1e6

    def innermost(self) -> np.ndarray:
        """The index of each activity's innermost range; -1 for none."""
        holds = self._holds()
        length = np.where(holds, (self.end - self.start)[None, :], np.inf)
        return np.where(holds.any(axis=1), length.argmin(axis=1), -1)

    def outside_s(self) -> float:
        """Device seconds of the activities launched with no range open."""
        return float(self.act_dur[self.innermost() < 0].sum()) / 1e6

    def host_s(self, name: str) -> float:
        """Host seconds inside the ranges `name`."""
        mine = self.names == name
        return float((self.end[mine] - self.start[mine]).sum()) / 1e6

    def syncs_in(self, name: str) -> List[List[Tuple[float, float]]]:
        """The synchronising calls that began inside each range `name`,
        clipped to it."""
        out = []
        for s, e in zip(self.start[self.names == name], self.end[self.names == name]):
            out.append([(max(a, s), min(b, e)) for a, b in self.syncs if s <= a <= e])
        return out

    def unsynced_s(self, name: str) -> float:
        """Host seconds inside the ranges `name` less the union of the
        synchronising calls inside each."""
        mine = self.names == name
        total = float((self.end[mine] - self.start[mine]).sum())
        return (total - sum(_union(calls) for calls in self.syncs_in(name))) / 1e6


def _union(spans) -> float:
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _match(calls: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The start of the call that queued each activity (both ascending): in
    order where the counts agree, else the next call that began before it."""
    if len(calls) == len(starts):
        return calls.astype(np.float64)
    out = np.full(len(starts), np.nan)
    k = 0
    for i, s in enumerate(starts):
        if k < len(calls) and calls[k] <= s:
            out[i] = calls[k]
            k += 1
    return out


def read(prof) -> Optional[Spans]:
    """The profile pass's `avt.` ranges and what was launched under them;
    None without a profile pass or without a range."""
    if prof is None:
        return None
    ranges = [(n, s, e) for n, s, e in prof.host_ops if n.startswith(PREFIX)]
    if not ranges:
        return None
    kernel_calls = sorted(s for n, s, _ in prof.host_ops if n in KERNEL_CALLS)
    copy_calls = sorted(s for n, s, _ in prof.host_ops if n.startswith(COPY_CALLS))
    # a user-scope range's device mirror is no kernel
    kernels = sorted((s, d) for n, s, d in prof.kernels if not n.startswith(PREFIX))
    copies = sorted((s, e - s) for s, e in prof.copies)
    act_start, act_dur, call_start = [], [], []
    for calls, acts in ((kernel_calls, kernels), (copy_calls, copies)):
        starts = np.array([s for s, _ in acts], dtype=np.float64)
        act_start.append(starts)
        act_dur.append(np.array([d for _, d in acts], dtype=np.float64))
        call_start.append(_match(np.array(calls, dtype=np.float64), starts))
    return Spans(
        units=prof.units,
        names=np.array([n for n, _, _ in ranges], dtype=object),
        start=np.array([s for _, s, _ in ranges], dtype=np.float64),
        end=np.array([e for _, _, e in ranges], dtype=np.float64),
        act_start=np.concatenate(act_start), act_dur=np.concatenate(act_dur),
        call_start=np.concatenate(call_start),
        counts={"kernel": (len(kernel_calls), len(kernels)),
                "copy": (len(copy_calls), len(copies))},
        syncs=[(s, e) for n, s, e in prof.host_ops if is_sync(n)])


def _holding(run, name: str) -> Optional[Spans]:
    """The run's spans where its profile pass holds a range `name`."""
    spans = read(run.profile)
    return spans if spans is not None and spans.has(name) else None


def device_ms(run, name: str) -> Optional[float]:
    """Device ms a unit of the activities launched under the ranges `name`."""
    s = _holding(run, name)
    return None if s is None else 1e3 * s.device_s(name) / s.units


def host_ms(run, name: str) -> Optional[float]:
    """Host ms a unit inside the ranges `name`."""
    s = _holding(run, name)
    return None if s is None else 1e3 * s.host_s(name) / s.units


def unsynced_ms(run, name: str) -> Optional[float]:
    """Host ms a unit inside the ranges `name`, less their synchronising calls."""
    s = _holding(run, name)
    return None if s is None else 1e3 * s.unsynced_s(name) / s.units


def syncs_per_unit(run, name: str) -> Optional[float]:
    """Synchronising calls a unit that began inside the ranges `name`."""
    s = _holding(run, name)
    return None if s is None else sum(map(len, s.syncs_in(name))) / s.units
