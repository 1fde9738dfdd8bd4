"""ctypes binding of the native host-preprocessing library (the port's copy
of ``videotgb_tpu/data/native``, same source and same compiler flags).

``host_ops.cpp`` is built with ``g++`` at first use into ``build/`` beside
the package; the library's file name carries a hash of the source, the
flags and the host CPU (``-march=native`` code must not be loaded on another
machine that shares the checkout). Callers check :func:`available` and use
the numpy paths of ``data.transforms`` otherwise. When the build fails, the
compiler's error is logged once as a warning, so a host without ``g++``
still runs and says why it is slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.native")

SRC = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD = SRC.parents[3] / "build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _cpu_signature() -> bytes:
    """The model name and feature flags of this host's CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = (b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def library_path() -> Path:
    sha = hashlib.sha256(SRC.read_bytes())
    sha.update(" ".join(FLAGS).encode())
    sha.update(_cpu_signature())
    return BUILD / f"libvtgb_host-{sha.hexdigest()[:12]}.so"


def _build(target: Path) -> str | None:
    """Compile into ``target``; returns the compiler's error, or None."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return proc.stderr.strip() or f"g++ exited {proc.returncode}"
    os.replace(tmp, target)
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build_error = _build(target)
            if _build_error is not None:
                log.warning("the native host library did not build (%s); "
                            "clip_transform takes its numpy path: %s",
                            target.name, _build_error)
                return None
        lib = ctypes.CDLL(str(target))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.vtgb_resize_normalize.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_int,
        ]
        lib.vtgb_normalize_flow.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.vtgb_flow_to_rgb.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_normalize(
    frames: np.ndarray, size: int, mean, std, num_threads: int = 0
) -> np.ndarray:
    """uint8 (T, H, W, 3) -> float32 (T, size, size, 3) CLIP-normalized."""
    lib = _load()
    assert lib is not None
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, _ = frames.shape
    out = np.empty((t, size, size, 3), np.float32)
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    lib.vtgb_resize_normalize(_u8(frames), t, h, w, _f32(out), size, size,
                              _f32(mean_arr), _f32(std_arr), num_threads)
    return out


def normalize_flow(flow: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """float32 (T, H, W, 2), returns a max-radius-normalized copy."""
    lib = _load()
    assert lib is not None
    out = np.ascontiguousarray(flow, np.float32).copy()
    t, h, w, _ = out.shape
    lib.vtgb_normalize_flow(_f32(out), t, h, w, num_threads)
    return out


def flow_to_rgb(flow: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """float32 (T, H, W, 2) -> uint8 (T, H, W, 3)."""
    lib = _load()
    assert lib is not None
    flow = np.ascontiguousarray(flow, np.float32)
    t, h, w, _ = flow.shape
    out = np.empty((t, h, w, 3), np.uint8)
    lib.vtgb_flow_to_rgb(_f32(flow), t, h, w, _u8(out), num_threads)
    return out
