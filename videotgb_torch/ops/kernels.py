"""Build and load the hand-written CUDA kernels of ``videotgb_torch/csrc``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, never
at import, into ``build/`` beside the package; a library's file name carries
a hash of its source and of the shared ``csrc/*.cuh`` headers, so an edited
kernel is rebuilt. :func:`build_all` starts one ``nvcc`` per source, all at
once.

``LAUNCHES`` holds one plain integer per kernel, the CUDA ones of
``SOURCES`` and the Triton ones of ``TRITON_KERNELS``; a wrapper calls
:func:`count` where it launches its kernel and nowhere else.
``MMA_LAUNCHES`` counts, of the launches of kernels A, G and C, those that
ran the tensor-core body
(``csrc/flash_mma.cuh``, ``csrc/flash_bwd_mma.cuh``; the rest ran the
CUDA-core body). ``TILE_LAUNCHES`` counts, of the launches of kernels B and
E, those that ran the tile body (``csrc/corr_lookup_tile.cuh``; the rest of
B's ran its gather body; E has no other).

The serving engine launches from two threads at once, so the counts and
the first-use builds of :func:`library` are guarded by one lock, ``LOCK``:
a read-modify-write of a shared count is not atomic across threads, and
two threads must not build one library at the same time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC.parent.parent / "build"
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "corr_lookup": "corr_lookup.cu",
           "select_frames": "select_frames.cu",
           "corr_lookup_blocked": "corr_lookup_blocked.cu",
           "flash_bshd": "flash_bshd.cu",
           "int8_mm": "int8_mm.cu", "bf16_mm": "bf16_mm.cu"}
# compiled by Triton at first launch (videotgb_torch/tools/lnprobe.py)
TRITON_KERNELS = ("add_ln", "ln")
LAUNCHES: dict[str, int] = {name: 0 for name in (*SOURCES, *TRITON_KERNELS)}
MMA_LAUNCHES: dict[str, int] = {"flash_fwd": 0, "flash_bshd": 0,
                                 "flash_bwd": 0}
TILE_LAUNCHES: dict[str, int] = {"corr_lookup": 0, "corr_lookup_blocked": 0}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
LOCK = threading.RLock()
_BODY_COUNTS = {"mma": MMA_LAUNCHES, "tile": TILE_LAUNCHES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # flash_fwd(q, k, v, bias, out, B, H, Sq, Skv, D, q/k/v/out strides
    # (batch, head, seq) x4, bias strides (batch, head, q, k), scale, dtype,
    # body, stream) -> cudaError_t
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 16
                 + [ctypes.c_float, _I, _I, _P],
    # flash_bwd(q, k, v, bias, dO, dq, dk, dv, ds, stats, B, H, Sq, Skv, D,
    # q/k/v/dO/dq/dk/dv strides (batch, head, seq) x7, bias strides (batch,
    # head, q, k), scale, dtype, body, stream) -> cudaError_t
    "flash_bwd": [_P] * 10 + [_I] * 5 + [_L] * 25
                 + [ctypes.c_float, _I, _I, _P],
    # corr_lookup(levels*, hl*, wl*, n_levels, coords, out, P, Q, radius,
    # body, qb, stage_bytes, dtype, encode_ns*, stream) -> cudaError_t, or
    # 10000 + the CUresult of a failed TMA encode
    "corr_lookup": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                    _P],
    # select_frames(start, end, start strides (row, col), end strides (row,
    # col), video_length, length_dtype, noise, seed*, seed_value, out,
    # out_dtype, B, L, num_frames, nframe, top_k, noise_scale, inclusive_end,
    # rescale, stream) -> cudaError_t
    "select_frames": [_P, _P, _L, _L, _L, _L, _P, _I, _P, _P, ctypes.c_uint32,
                      _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    # corr_lookup_blocked(levels*, hl*, wl*, n_levels, coords, out, P, Q,
    # radius, qb, skip, stage_bytes, dtype, stream) -> as corr_lookup
    "corr_lookup_blocked": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    # flash_bshd(q, k, v, out, B, S, H, D, q/k/v/out strides (batch, seq,
    # head) x4, scale, dtype, body, stream) -> cudaError_t
    "flash_bshd": [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12
                  + [ctypes.c_float, _I, _I, _P],
    # int8_mm(a, b, c, M, N, K, out_kind, tile, encode_ns*, stream) ->
    # cudaError_t, or 10000 + the CUresult of a failed TMA encode
    "int8_mm": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # bf16_mm(a, b, c, M, N, K, tile, encode_ns*, stream) -> as int8_mm
    "bf16_mm": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
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
    sha = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        sha.update(header.read_bytes())
    digest = sha.hexdigest()[:12]
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
    """The loaded library of one kernel, built first if needed (once, when
    several threads ask at the same time)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with LOCK:
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


def count(name: str, body: str | None = None) -> None:
    """Add one launch of kernel ``name``; ``body`` "mma" or "tile" also
    adds it to ``MMA_LAUNCHES`` or ``TILE_LAUNCHES`` (any other body, or
    None, to neither)."""
    with LOCK:
        LAUNCHES[name] += 1
        per_body = _BODY_COUNTS.get(body)
        if per_body is not None:
            per_body[name] += 1


def reset_launches() -> None:
    with LOCK:
        for counts in (LAUNCHES, MMA_LAUNCHES, TILE_LAUNCHES):
            for name in counts:
                counts[name] = 0


# kernels B, E and H's C entries return this + the CUresult of a failed TMA
# encode
ENCODE_ERROR = 10000


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused or failed launch (the C side returns
    ``cudaGetLastError()`` right after launching)."""
    if rc >= ENCODE_ERROR:
        raise RuntimeError(f"{name}: TMA descriptor encode failed: CUresult "
                           f"{rc - ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
