"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface. At first use it
is compiled by `nvcc` for sm_90a into a shared library under
`avt_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source and the shared headers (`csrc/*.cuh`), so an edit rebuilds; the
library is loaded with ctypes. Nothing here runs when the package is
imported. `build` and `load` also take another directory of sources (a copy
of `csrc/`, e.g. a parent commit's), so two versions of a kernel can be
timed side by side.

`KERNELS` names every kernel of the port with the TPU kernel it replaces,
and `launch_counts` counts, per kernel, the launches its wrapper made: a run
can read them to show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> what the chip check reports about it
KERNELS: Dict[str, Dict[str, str]] = {
    "short_attention_fwd": {
        "route": "cuda",
        "source": "avt_tpu_torch/ops/csrc/short_attention_fwd.cu",
        "replaces": "avt_tpu/ops/flash_attention.py:551 (_short_fwd_kernel_paired, "
                    "via _short_attention_fwd_call :814)",
    },
    "short_attention_bwd": {
        "route": "cuda",
        "source": "avt_tpu_torch/ops/csrc/short_attention_bwd.cu",
        "replaces": "avt_tpu/ops/flash_attention.py:599 (_short_bwd_kernel_paired with db_ref, "
                    "via _short_attention_bwd_db_call :884; without db and _short_bwd_kernel "
                    ":486 via _short_attention_bwd_call :848)",
    },
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "avt_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "avt_tpu/ops/flash_attention.py:43 (_flash_kernel, via "
                    "_flash_attention_fwd :227)",
    },
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "avt_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "avt_tpu/ops/flash_attention.py:92 (_dq_kernel) + :133 (_dkv_kernel), "
                    "via _flash_attention_bwd :305",
    },
    "fused_qkv_attention_fwd": {
        "route": "cuda",
        "source": "avt_tpu_torch/ops/csrc/fused_qkv_attention_fwd.cu",
        "replaces": "avt_tpu/ops/flash_attention.py:696 (_fused_qkv_attn_fwd_kernel, "
                    "via _fused_qkv_attn_fwd_call :754)",
    },
    "dense_f32": {
        "route": "cuda",
        "source": "avt_tpu_torch/ops/csrc/dense_f32.cu",
        "replaces": "none: avt_tpu leaves x @ W to XLA (models/layers.py dense); cuBLAS "
                    "runs an f32 product on the FMA units, this kernel on the tensor cores",
    },
}
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_lock = threading.Lock()
_libs: Dict[Tuple[str, Path], ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Named by a hash of the source and of every header in its directory."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, csrc: Path):
    """Starts nvcc for one kernel; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = library_path(name, csrc)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _log_path(library: Path) -> Path:
    """nvcc's output for a library, kept beside it."""
    return library.with_suffix(".nvcc.txt")


def _finish_build(name: str, started) -> None:
    """Waits for nvcc; keeps its output (ptxas's registers and spills)
    beside the library."""
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    _log_path(out).write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str] = tuple(KERNELS), csrc: Path = CSRC) -> Dict[str, str]:
    """Compiles the named kernels from the sources in csrc, one nvcc process
    each, all at once (a library already built is kept); returns nvcc's
    output for each named library."""
    names = list(names)
    with _lock:
        started = [(n, _start_build(n, csrc)) for n in names]
        errors = []
        for n, s in started:
            try:
                _finish_build(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        logs = {}
        for n in names:
            log = _log_path(library_path(n, csrc))
            logs[n] = log.read_text() if log.exists() else ""
        return logs


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The kernel's library, built from the sources in csrc first if needed."""
    lib = _libs.get((name, csrc))
    if lib is not None:
        return lib
    build([name], csrc)
    with _lock:
        if (name, csrc) not in _libs:
            lib = ctypes.CDLL(str(library_path(name, csrc)))
            lib.avt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.avt_cuda_error_string.restype = ctypes.c_char_p
            _libs[(name, csrc)] = lib
        return _libs[(name, csrc)]


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raises if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.avt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
