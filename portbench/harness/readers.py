"""What the metrics/<metric>.py readers share. Each returns None where the
run has nothing for it to read, never 0 for a share."""
from __future__ import annotations

from typing import Optional, Tuple

from portbench.harness.roofline import ITEMSIZE, bound_s
from portbench.work import flash_attention, packed_attention

# the kernels' names, where the profiler links no launch to its custom op
PACKED_FWD = ("short_attn",)
PACKED_BWD = ("bwd_query", "bwd_key", "db_reduce")
FLASH_FWD = ("flash_fwd",)
FLASH_BWD = ("flash_bwd",)
MATMUL = ("gemm", "nvjet", "xmma", "cutlass")


def clips_per_s(run) -> float:
    """Every clip of the window over the window's time."""
    return run.window["clips"] / run.window["seconds"]


def mfu(run) -> Optional[float]:
    """% of the dtype's peak: the model FLOPs of the window's clips over
    the window's time."""
    return 100.0 * run.clip_flops() / run.clip_s() / run.peak_flops


def idle_share(run) -> Optional[float]:
    """% of the window's time a clip in which the device was not busy, its
    busy time a clip taken from the profile pass."""
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / sum(run.unit_clips) / run.clip_s())


def _device_s(run, op: str, patterns: Tuple[str, ...]) -> float:
    """Device seconds of the profiled units' launches of a custom op: by
    the op's CPU events, else by kernel names."""
    prof = run.profile
    return prof.op_s(op) or prof.kernel_s(patterns)


def _bound_s(run, call_of, work, layers: int, causal: Optional[bool]) -> Optional[float]:
    """The least time of a kernel's launches in the profiled units: one
    launch a layer of each unit, at the unit's shapes (`call_of(clips)`)."""
    total = 0.0
    for clips in run.unit_clips:
        call = call_of(run.cell.cfg, run.cell.traffic, run.mode, clips)
        if call is None:
            return None
        *shape, dtype = call
        extra = () if causal is None else (causal,)
        total += layers * bound_s(*work(*shape, ITEMSIZE[dtype], *extra), dtype)
    return total


def packed_roofline(run, backward: bool) -> Optional[float]:
    """% of the packed attention's roofline over its launches in the
    profiled units: the bound of the clips' work over the device time of
    those launches (padding a request's last batch counts as no work)."""
    if run.profile is None or run.model["backbone"] != "avt_b":
        return None
    fam, layers = run.cell.family, run.model["vit_depth"]
    bound = _bound_s(run, fam.packed_call, packed_attention.forward_work, layers, None)
    took = _device_s(run, "avt_tpu_torch::packed_short_attention", PACKED_FWD)
    if backward:
        bound += _bound_s(run, fam.packed_call, packed_attention.backward_work, layers, None)
        took += _device_s(run, "avt_tpu_torch::packed_short_attention_bwd", PACKED_BWD)
    return 100.0 * bound / took if took > 0 else None


def flash_roofline(run, backward: bool) -> Optional[float]:
    """% of the flash attention's roofline over its launches in the
    profiled units (causal: the kept pairs)."""
    if run.profile is None:
        return None
    fam, layers = run.cell.family, run.model["n_layer"]
    bound = _bound_s(run, fam.flash_call, flash_attention.forward_work, layers, True)
    if bound is None:
        return None
    took = _device_s(run, "avt_tpu_torch::flash_attention", FLASH_FWD)
    if backward:
        bound += _bound_s(run, fam.flash_call, flash_attention.backward_work, layers, True)
        took += _device_s(run, "avt_tpu_torch::flash_attention_bwd", FLASH_BWD)
    return 100.0 * bound / took if took > 0 else None


def matmul_ms(run) -> Optional[float]:
    """Device ms a unit of cuBLAS's GEMM kernels (and cuDNN's implicit GEMM
    of the patch embedding)."""
    if run.profile is None:
        return None
    s = run.profile.kernel_s(MATMUL) / run.profile.units
    return 1e3 * s if s > 0 else None


def range_ms(run, name: str) -> Optional[float]:
    """Device ms a unit of the kernels under the profiler range `name`."""
    if run.profile is None:
        return None
    s = run.profile.op_s(name) / run.profile.units
    return 1e3 * s if s > 0 else None


def launches_per_unit(run) -> Optional[float]:
    if run.profile is None:
        return None
    return len(run.profile.kernels) / run.profile.units
