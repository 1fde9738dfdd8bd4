"""The port's kernel plumbing on the CPU: which body kernels A, G and C run
(``ops.attention.flash_body``), how many launches kernel C's tensor-core
body takes (``ops.attention.flash_bwd_passes``), and the ``ctypes``
signatures of every C entry in ``videotgb_torch/csrc`` against the
declarations in the sources.

A pointer or a 64-bit stride that ``ctypes`` passes as a 32-bit int is cut
without an error, so the declarations and ``kernels._SIGNATURES`` are held
against each other here, where no compiler runs.
"""

import ctypes
import re

import pytest
import torch

from videotgb_torch.ops import kernels
from videotgb_torch.ops.attention import (
    BODY_CODES,
    flash_body,
    flash_bwd_passes,
)


def _bhsd_views(b, s, h, d, dtype):
    """The (B, H, S, D) views of separate (B, S, H, D) projections."""
    return [torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)
            for _ in range(3)]


def _fused_views(b, s, h, d, dtype):
    """unbind of a packed (B, S, 3, H, D) projection: k and v start H * D
    elements past q."""
    return list(torch.zeros((b, s, 3, h, d), dtype=dtype).unbind(2))


def _offset(b, s, h, d, dtype, shift):
    """(B, H, S, D) views that start ``shift`` elements into an
    allocation."""
    flat = torch.zeros((3, shift + b * s * h * d), dtype=dtype)
    return [t[shift:].view(b, s, h, d).transpose(1, 2) for t in flat]


BODY_CASES = {
    # bf16 with 16-byte rows: the tensor-core body
    "bf16 D=88 strided projections (ViT-g)":
        (lambda: _bhsd_views(2, 264, 16, 88, torch.bfloat16), "mma"),
    "bf16 D=64 strided projections (T5-xl)":
        (lambda: _bhsd_views(2, 160, 32, 64, torch.bfloat16), "mma"),
    "bf16 D=88 unbind of a packed qkv, as (B, H, S, D) views":
        (lambda: [t.transpose(1, 2) for t in _fused_views(
            2, 70, 12, 88, torch.bfloat16)], "mma"),
    "bf16 D=88 (B, S, H, D) as kernel G takes it":
        (lambda: _fused_views(2, 70, 12, 88, torch.bfloat16), "mma"),
    "bf16 D=16 contiguous (B, H, S, D)":
        (lambda: [torch.zeros((1, 2, 5, 16), dtype=torch.bfloat16)] * 3,
         "mma"),
    "bf16 offset by 8 elements (16 bytes)":
        (lambda: _offset(2, 70, 4, 64, torch.bfloat16, 8), "mma"),
    # everything else: the CUDA-core body
    "f32 D=88 strided projections":
        (lambda: _bhsd_views(2, 264, 16, 88, torch.float32), "fma"),
    "f32 D=64 contiguous":
        (lambda: [torch.zeros((2, 4, 70, 64))] * 3, "fma"),
    "bf16 D=12":
        (lambda: _bhsd_views(2, 70, 4, 12, torch.bfloat16), "fma"),
    "bf16 view offset by 4 elements":
        (lambda: _offset(2, 70, 4, 64, torch.bfloat16, 4), "fma"),
    "bf16 only v offset by 4 elements":
        (lambda: _bhsd_views(2, 70, 4, 64, torch.bfloat16)[:2]
         + _offset(2, 70, 4, 64, torch.bfloat16, 4)[2:], "fma"),
    "bf16 D=8 sliced from rows of 12 (seq stride 12 * H)":
        (lambda: [torch.zeros((2, 70, 3, 12), dtype=torch.bfloat16)[..., :8]
                  .transpose(1, 2)] * 3, "fma"),
    "fp16 D=16 (not bf16)":
        (lambda: [torch.zeros((1, 2, 5, 16), dtype=torch.float16)] * 3,
         "fma"),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_flash_body_rule(case):
    make, want = BODY_CASES[case]
    q, k, v = make()
    assert flash_body(q, k, v) == want
    assert want in BODY_CODES


def _with_grad(make, grad):
    """Kernel C's four tensors: q, k, v from ``make`` and a dO."""
    return lambda: make() + [grad()]


BWD_BODY_CASES = {
    # the T5-xl encoder's backward: (B, H, S, D) views of (B, S, H, D)
    # projections, and the gradient of the output view in the same layout
    "bf16 D=64 strided q, k, v and dO (T5-xl)":
        (_with_grad(lambda: _bhsd_views(8, 160, 32, 64, torch.bfloat16),
                    lambda: _bhsd_views(8, 160, 32, 64, torch.bfloat16)[0]),
         "mma"),
    "bf16 D=64 contiguous dO behind strided q, k, v":
        (_with_grad(lambda: _bhsd_views(2, 160, 4, 64, torch.bfloat16),
                    lambda: torch.zeros((2, 4, 160, 64),
                                        dtype=torch.bfloat16)), "mma"),
    "bf16 D=88 offset by 8 elements, dO too":
        (lambda: _offset(2, 70, 4, 88, torch.bfloat16, 8), "mma"),
    "bf16 only dO offset by 4 elements":
        (_with_grad(lambda: _bhsd_views(2, 70, 4, 64, torch.bfloat16),
                    lambda: _offset(2, 70, 4, 64, torch.bfloat16, 4)[0]),
         "fma"),
    "bf16 only dO with a seq stride of 12 * H":
        (_with_grad(lambda: _bhsd_views(2, 70, 3, 8, torch.bfloat16),
                    lambda: torch.zeros((2, 70, 3, 12), dtype=torch.bfloat16)
                    [..., :8].transpose(1, 2)), "fma"),
    "f32 D=64 q, k, v and dO":
        (_with_grad(lambda: _bhsd_views(8, 160, 32, 64, torch.float32),
                    lambda: _bhsd_views(8, 160, 32, 64, torch.float32)[0]),
         "fma"),
    "bf16 D=12 q, k, v and dO":
        (_with_grad(lambda: _bhsd_views(2, 70, 4, 12, torch.bfloat16),
                    lambda: _bhsd_views(2, 70, 4, 12, torch.bfloat16)[0]),
         "fma"),
}


@pytest.mark.parametrize("case", list(BWD_BODY_CASES))
def test_flash_body_rule_of_the_backward(case):
    make, want = BWD_BODY_CASES[case]
    tensors = make()
    assert len(tensors) in (3, 4)
    if len(tensors) == 3:  # _offset makes three: the fourth alike
        tensors.append(tensors[0])
    assert flash_body(*tensors) == want
    if "only dO" in case:  # q, k and v alone would take the tensor cores
        assert flash_body(*tensors[:3]) == "mma"


# (Sq, Skv, D) -> launches of kernel C's tensor-core body
BWD_PASSES = {
    (160, 160, 64): 1,    # the T5-xl encoder: one block per head
    (1, 160, 64): 1,
    (65, 160, 64): 1,
    (70, 45, 88): 1,
    (192, 160, 64): 1,    # more query rows than the block's ten warps' 160
    (300, 64, 64): 1,
    (368, 64, 64): 1,     # 230,400 bytes of shared memory
    (369, 64, 64): 2,     # 239,616 bytes
    (161, 161, 64): 2,    # past 160 keys
    (32, 600, 64): 2,
    (600, 600, 64): 2,
    (1024, 1024, 64): 2,
    (1200, 1200, 64): 2,
    (1536, 1536, 64): 2,
    (160, 160, 96): 2,    # 235 KB of shared memory, over a block's 227 KB
    (160, 160, 128): 2,
    (64, 64, 128): 1,
}


@pytest.mark.parametrize("shape", list(BWD_PASSES))
def test_flash_bwd_passes_rule(shape):
    assert flash_bwd_passes(*shape) == BWD_PASSES[shape]


def test_flash_bwd_passes_main_shape_fits_one_block():
    # the T5-xl encoder's (160, 160, 64): Q, dO, K, V of 160 rows x 144
    # bytes and bf16 P, dS of 160 rows x 336 bytes, 199,680 bytes in all
    assert 4 * 160 * 144 + 2 * 160 * 336 == 199680 <= 232448
    assert flash_bwd_passes(160, 160, 64) == 1
    assert all(flash_bwd_passes(s, s, 64) == 2 for s in (600, 1024, 1536))


def test_flash_body_reads_the_first_three_strides_of_either_layout():
    # kernel G hands over (B, S, H, D) tensors directly; the rule reads
    # their (batch, seq, head) strides just as A's (batch, head, seq)
    q = torch.zeros((2, 70, 12, 88), dtype=torch.bfloat16)
    assert flash_body(q, q, q) == "mma"
    wide = torch.zeros((2, 70, 12, 92), dtype=torch.bfloat16)[..., :88]
    assert wide.stride(2) % 8 and flash_body(wide, wide, wide) == "fma"


_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _ctype(arg: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in arg:
        return ctypes.c_void_p
    words = arg.split()[:-1]  # drop the parameter's name
    kinds = {("long", "long"): ctypes.c_longlong, ("float",): ctypes.c_float,
             ("int",): ctypes.c_int, ("uint32_t",): ctypes.c_uint32}
    return kinds[tuple(w for w in words if w != "const")]


def _declarations():
    found = {}
    for path in sorted(kernels.CSRC.glob("*.cu")):
        for name, args in _EXTERN.findall(path.read_text()):
            found[name] = (path.name, [_ctype(" ".join(a.split()))
                                       for a in args.split(",")])
    return found


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_ctypes_signature_matches_the_c_declaration(name):
    decls = _declarations()
    assert name in decls, f"no extern \"C\" {name} in csrc/"
    source, types = decls[name]
    assert source == kernels.SOURCES[name]
    assert kernels._SIGNATURES[name] == types, (
        f"{name}: ctypes {kernels._SIGNATURES[name]} vs C {types}")


def test_every_c_entry_has_a_signature():
    assert set(_declarations()) == set(kernels._SIGNATURES) == set(
        kernels.SOURCES)


def test_mma_counters_reset_with_the_launch_counts():
    assert set(kernels.MMA_LAUNCHES) <= set(kernels.LAUNCHES)
    kernels.LAUNCHES["flash_fwd"] += 2
    kernels.MMA_LAUNCHES["flash_fwd"] += 1
    kernels.MMA_LAUNCHES["flash_bwd"] += 1
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.MMA_LAUNCHES.values())


def test_counts_from_eight_threads_lose_no_launch():
    """The serving engine launches from two threads; ``kernels.count`` must
    not lose an update when the interpreter switches between a read and a
    write (a short switch interval makes that switch frequent)."""
    import sys
    import threading

    per_thread, threads = 10_000, 8
    bodies = ("mma", "fma", None, "tile")
    names = ("flash_fwd", "flash_fwd", "select_frames", "corr_lookup")
    kernels.reset_launches()
    start = threading.Barrier(threads)

    def work(i):
        start.wait()
        for _ in range(per_thread):
            kernels.count(names[i % 4], bodies[i % 4])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    n = per_thread * threads // 4
    try:
        assert kernels.LAUNCHES["flash_fwd"] == 2 * n
        assert kernels.MMA_LAUNCHES["flash_fwd"] == n
        assert kernels.LAUNCHES["select_frames"] == n
        assert kernels.LAUNCHES["corr_lookup"] == n
        assert kernels.TILE_LAUNCHES["corr_lookup"] == n
        assert sum(kernels.LAUNCHES.values()) == per_thread * threads
    finally:
        kernels.reset_launches()


def test_library_builds_once_under_concurrent_first_use(monkeypatch,
                                                        tmp_path):
    """Two threads at the first use of one kernel run one build and load
    one library."""
    import threading

    builds = []
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_target",
                        lambda name: tmp_path / f"lib{name}.so")

    def fake_build(names):
        builds.append(list(names))
        for name in names:
            (tmp_path / f"lib{name}.so").write_bytes(b"")

    class FakeLib:
        def __init__(self, path):
            self.select_frames = lambda *a: 0

    monkeypatch.setattr(kernels, "build_all", fake_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    got = []
    pool = [threading.Thread(target=lambda: got.append(
        kernels.library("select_frames"))) for _ in range(4)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in pool)
    assert builds == [["select_frames"]]
    assert len(got) == 4 and all(lib is got[0] for lib in got)
