"""Metric meters: windowed smoothing and epoch-global averages.

Counterpart of avt_tpu/train/meters.py (`SmoothedValue`, `MetricLogger`,
`host_rss_mb`, `device_hbm_mb`, `make_tb_writer`): the median and mean over
a window, the global mean over the epoch, and `log_every` with iteration
and data times. `device_hbm_mb` reads the caching allocator's count, which
does not wait for the device.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from avt_tpu_torch.parallel.ddp import all_reduce_sum, data_world


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        if not self.deque:
            return 0.0
        # the lower middle element of an even-length window, as torch.median
        # (the reference's meter) picks it
        vals = sorted(self.deque)
        return float(vals[(len(vals) - 1) // 2])

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / (self.count + 1e-6)  # the reference's + 1e-6

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


def host_rss_mb() -> float:
    """Resident-set size of this process in MB."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def device_hbm_mb() -> Optional[float]:
    """Device memory held by tensors in MB (`torch.cuda.memory_allocated`,
    a host-side count: no sync); None when this process has not used CUDA."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_allocated() / (1024.0 * 1024.0)


def make_tb_writer(log_dir: str, rank: int = 0):
    """A tensorboardX writer on rank 0; None elsewhere or without tensorboardX."""
    if rank != 0:
        return None
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except ImportError:
        return None


class MetricLogger:
    def __init__(self, delimiter: str = "  ", logger=None, writer=None, stat_set: str = "train"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger
        self.writer = writer
        self.stat_set = stat_set

    def update(self, n: int = 1, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n=n)

    def write_scalar(self, name: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(name, value, step)

    def dump_to_tb(self, step: int):
        """Each meter's window mean to the writer."""
        if self.writer is None:
            return
        for name, meter in self.meters.items():
            self.writer.add_scalar(f"metric_logger/{self.stat_set}/{name}", meter.avg, step)

    def __getitem__(self, key) -> SmoothedValue:
        return self.meters[key]

    def synchronize_between_processes(self):
        """Each meter's (total, count) becomes its sum over the data
        replicas, so that global_avg is the mean over every replica's
        updates (model peers hold the same ones); nothing to do with one
        replica. Every rank must hold the same meter names."""
        if data_world() == 1:
            return
        keys = sorted(self.meters)
        summed = all_reduce_sum([[self.meters[k].total, self.meters[k].count] for k in keys])
        for i, k in enumerate(keys):
            self.meters[k].total = float(summed[i, 0])
            self.meters[k].count = int(summed[i, 1])

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in sorted(self.meters.items()))

    def log_every(self, iterable: Iterable, print_freq: int = 10, header: str = "",
                  total: Optional[int] = None):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if self.logger and i % print_freq == 0:
                tot = total if total is not None else "?"
                eta = iter_time.global_avg * (total - i) if total else float("nan")
                hbm = device_hbm_mb()
                mem = f"mem {host_rss_mb():.0f}MB" + (
                    f" hbm {hbm:.0f}MB" if hbm is not None else "")
                self.logger.info("%s [%d/%s] eta %.0fs %s iter_t %.3fs data_t %.3fs %s",
                                 header, i, tot, eta, str(self), iter_time.avg,
                                 data_time.avg, mem)
            i += 1
            end = time.time()
        if self.logger:
            self.logger.info("%s done in %.1fs: %s", header, time.time() - start, str(self))
