"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface. At first use it
is compiled by `nvcc` for sm_90a into a shared library under
`avt_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source and the shared headers (`csrc/*.cuh`), so an edit rebuilds; the
library is loaded with ctypes. Nothing here runs when the package is
imported.

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
from typing import Dict, Iterable

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
}
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


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


def library_path(name: str) -> Path:
    """Named by a hash of the source and of every header in csrc/."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Starts nvcc for one kernel; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str] = tuple(KERNELS)) -> None:
    """Compiles the named kernels, one nvcc process each, all at once."""
    names = list(names)
    with _lock:
        started = [(n, _start_build(n)) for n in names]
        errors = []
        for n, s in started:
            try:
                _finish_build(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(library_path(name)))
            lib.avt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.avt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raises if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.avt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
