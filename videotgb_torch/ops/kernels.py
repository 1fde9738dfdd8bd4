"""Build and load the hand-written CUDA kernels of ``videotgb_torch/csrc``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, never
at import, into ``build/`` beside the package; a library's file name carries
a hash of its source, so an edited kernel is rebuilt. :func:`build_all`
starts one ``nvcc`` per source, all at once.

``LAUNCHES`` holds one plain integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC.parent.parent / "build"
SOURCES = {"flash_fwd": "flash_fwd.cu", "corr_lookup": "corr_lookup.cu"}
LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # flash_fwd(q, k, v, bias, out, B, H, Sq, Skv, D, q/k/v/out strides
    # (batch, head, seq) x4, bias strides (batch, head, q, k), scale, dtype,
    # stream) -> cudaError_t
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 16
                 + [ctypes.c_float, _I, _P],
    # corr_lookup(levels*, hl*, wl*, n_levels, coords, out, P, Q, radius,
    # dtype, stream) -> cudaError_t
    "corr_lookup": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel. Returns each kernel's
    ``-Xptxas -v`` report (registers, shared memory, spills), or "" where
    the library was already built."""
    names = list(names or SOURCES)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused or failed launch (the C side returns
    ``cudaGetLastError()`` right after launching)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
