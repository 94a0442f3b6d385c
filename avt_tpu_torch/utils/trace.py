"""Named ranges at the port's layer boundaries, on the device trace's clock.

`span(name)` is the one place the port opens a profiler range. While a
torch profiler runs it is a range of that name in the profiler's Kineto
trace, beside the kernels and copies it launches and on their clock;
otherwise it is the shared no-op `OFF`, after one check of the profiler's
state. `torch.profiler`'s `export_chrome_trace` writes the trace out;
`spanned(name)` is the decorator form, which checks at each call.

The range is a RecordFunction of function scope, as an operator's is, not
the user-scope range of `torch.profiler.record_function`: Kineto mirrors a
user-scope range onto the device's timeline as an activity of its own,
which a reader of the device's activities would count as a kernel. A
function-scope range has no mirror, and a kernel it launches itself links
to it as to an operator.

Names are stable, `avt.<layer>.<phase>`, never with a step number or a
shape in them; a phase is a child of its step or request. An export runs
with no profiler, so no range enters an exported program.

`count(name, value)` is the counters' one entry, under the same check:
while a profiler runs it adds `value` (a device tensor, added on the device
with no host read, or a Python number, added on the host) into the
accumulator `name`; otherwise it does nothing. `counters()` reads every
accumulator (one sync for all of them) and resets them: a reader calls it
once, after the profiled pass.
"""
from __future__ import annotations

import functools
from typing import Dict, Union

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The span while no profiler runs: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """The profiler range `name` while a torch profiler runs, else `OFF`."""
    if not _profiler_enabled():
        return OFF
    return torch._C._profiler._RecordFunctionFast(name)


def tracing() -> bool:
    """Whether a torch profiler runs: the check of `span` and `count`, for a
    caller that would compute a counter's value only to count it."""
    return _profiler_enabled()


class _Counters:
    """The accumulators of `count`: device tensors (f64) and host numbers."""

    def __init__(self):
        self.device: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, float] = {}

    def add(self, name: str, value: Union[torch.Tensor, int, float]) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().to(torch.float64)
            if name in self.device:
                self.device[name].add_(value)
            else:
                self.device[name] = value.clone()
        else:
            self.host[name] = self.host.get(name, 0.0) + float(value)

    def read(self) -> Dict[str, float]:
        out = dict(self.host)
        if self.device:
            names = list(self.device)
            values = torch.stack([self.device[n].reshape(()) for n in names]).tolist()
            out.update(zip(names, values))
        self.device, self.host = {}, {}
        return out


_COUNTERS = _Counters()


def count(name: str, value: Union[torch.Tensor, int, float]) -> None:
    """Adds `value` into the counter `name` while a torch profiler runs."""
    if _profiler_enabled():
        _COUNTERS.add(name, value)


def counters() -> Dict[str, float]:
    """{name: total} of every counter since the last call, which resets them."""
    return _COUNTERS.read()


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
