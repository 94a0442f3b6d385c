"""ctypes binding for the native libav decoder (native/videodecode).

Counterpart of avt_tpu/data/video_decoder.py: `LibavVideoReader` decodes
an exact [start, end]-second range to RGB24 uint8 frames, `get_video_info`
probes fps and duration, `remux` rewrites timestamps or rotation by stream
copy, and `_HandlePool` keeps decoder contexts per path for the loader's
threads. The C++ source is the JAX package's, read as it is. At first use
it is compiled with g++ and linked against libav (the Makefile's flags)
into a shared library under the port's `_build/` directory (listed in
.gitignore), named by a hash of the source and the command, so the port
never writes beside the source and never loads a library built there. A
failed build raises with the compiler's message; only the
`datasets.reader_fns.DefaultReader` rule (config/registry.py) falls back to
`OpenCVVideoReader`, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from avt_tpu_torch.data.readers import Reader

LOG = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "videodecode" / "videodecode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_lib = None
_lib_lock = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(source: Path = SOURCE) -> Path:
    """Named by a hash of the source and of the compile command."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((_compiler(),) + CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libvideodecode-{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compiles the decoder unless its library is built; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, str(source), *LIBS]
    LOG.info("Building the native video decoder: %s", " ".join(cmd))
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler
        os.unlink(tmp)
        raise RuntimeError(f"video decoder build failed: {e}") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"video decoder build failed (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: another process sees all or nothing
    return out


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        lib.vd_fps.restype = ctypes.c_double
        lib.vd_fps.argtypes = [ctypes.c_void_p]
        lib.vd_duration.restype = ctypes.c_double
        lib.vd_duration.argtypes = [ctypes.c_void_p]
        lib.vd_width.restype = ctypes.c_int
        lib.vd_width.argtypes = [ctypes.c_void_p]
        lib.vd_height.restype = ctypes.c_int
        lib.vd_height.argtypes = [ctypes.c_void_p]
        lib.vd_read_range.restype = ctypes.c_int
        lib.vd_read_range.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
        lib.vd_last_error.restype = ctypes.c_char_p
        lib.vd_remux.restype = ctypes.c_int
        lib.vd_remux.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_decoder_error() -> Optional[str]:
    """None when the decoder builds and loads, else why it does not."""
    try:
        _load_lib()
    except Exception as err:  # no compiler or no libav
        return f"{type(err).__name__}: {err}"
    return None


def have_native_decoder() -> bool:
    err = native_decoder_error()
    if err is not None:
        LOG.warning("native decoder unavailable: %s", err)
    return err is None


class _Handle:
    """One open video; closed when collected."""

    def __init__(self, path: str):
        self.lib = _load_lib()
        self.ptr = self.lib.vd_open(str(path).encode())
        # decode state (seek position, codec buffers) is per handle; the
        # lock serializes loader threads that share one
        self.lock = threading.Lock()
        if not self.ptr:
            raise IOError(f"decoder open failed for {path}: "
                          f"{self.lib.vd_last_error().decode()}")

    def __del__(self):
        if getattr(self, "ptr", None):
            self.lib.vd_close(self.ptr)
            self.ptr = None

    @property
    def fps(self) -> float:
        return self.lib.vd_fps(self.ptr)

    @property
    def duration(self) -> float:
        return self.lib.vd_duration(self.ptr)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.lib.vd_height(self.ptr), self.lib.vd_width(self.ptr)

    def read_range(self, start: float, end: float, max_frames: Optional[int] = None):
        h, w = self.shape
        if max_frames is None:
            max_frames = int((end - start) * max(self.fps, 1.0)) + 8
        out = np.empty((max_frames, h, w, 3), dtype=np.uint8)
        pts = np.empty((max_frames,), dtype=np.float64)
        with self.lock:
            n = self.lib.vd_read_range(
                self.ptr, float(start), float(end),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                max_frames,
            )
        if n < 0:
            raise IOError(self.lib.vd_last_error().decode())
        return out[:n], pts[:n]


def get_video_info(path) -> Dict[str, float]:
    """{'fps': ..., 'len': seconds} of a video."""
    h = _Handle(path)
    return {"fps": h.fps, "len": h.duration}


def remux(in_path, out_path, *, pts_scale: float = 1.0, pts_quad: float = 0.0,
          rotation_deg: int = 0) -> None:
    """Stream-copy remux with new timestamps or rotation metadata:
    new_pts_sec = sec * pts_scale + pts_quad * sec^2 (a variable-frame-rate
    source without an encoder)."""
    lib = _load_lib()
    rc = lib.vd_remux(str(in_path).encode(), str(out_path).encode(),
                      float(pts_scale), float(pts_quad), int(rotation_deg))
    if rc != 0:
        raise IOError(lib.vd_last_error().decode())


class _HandlePool:
    """Decoder handles per path, so that loader threads reading clips of one
    video each get their own context (the GIL is released inside the ctypes
    call), recycled to spare the open and probe. Bounded per path and in
    all; over the total, the oldest idle path's handles go first."""

    def __init__(self, max_per_path: int = 8, max_total: int = 64):
        self._free: Dict[str, list] = {}
        self._lock = threading.Lock()
        self._max = max_per_path
        self._max_total = max_total
        self._total = 0

    def acquire(self, path: str) -> _Handle:
        with self._lock:
            free = self._free.get(path)
            if free:
                self._total -= 1
                return free.pop()
        return _Handle(path)

    def release(self, path: str, handle: _Handle) -> None:
        """Returns a healthy handle for reuse (a handle whose read raised is
        dropped by the caller: its context may be mid-stream)."""
        with self._lock:
            free = self._free.setdefault(path, [])
            if len(free) >= self._max:
                return  # over the per-path cap: dropped, closed when collected
            free.append(handle)
            self._total += 1
            while self._total > self._max_total:
                for other, lst in self._free.items():
                    if lst and other != path:
                        lst.pop(0)
                        self._total -= 1
                        break
                else:
                    free.pop(0)  # only this path has handles
                    self._total -= 1


class LibavVideoReader(Reader):
    """Raw-video reader over the native decoder (pooled handles)."""

    def __init__(self, cache_handles: bool = True, max_pool_per_path: int = 8):
        _load_lib()
        self.cache_handles = cache_handles
        self._pool = _HandlePool(max_pool_per_path if cache_handles else 0)

    def get_frame_rate(self, video_path) -> float:
        key = str(video_path)
        try:
            h = self._pool.acquire(key)
        except IOError:
            return 0.0  # the dataset's empty-clip path
        fps = h.fps
        self._pool.release(key, h)
        return fps

    def __call__(self, video_path, start_sec, end_sec, fps, row):
        key = str(video_path)
        try:
            handle = self._pool.acquire(key)
        except IOError:
            return np.zeros((0, 1, 1, 3), dtype=np.uint8), {}
        # a read that raises drops its handle and the error reaches the
        # loader's backfill; only healthy handles go back to the pool
        frames, _ = handle.read_range(start_sec, end_sec)
        out = frames, {"video_fps": handle.fps}
        self._pool.release(key, handle)
        return out
