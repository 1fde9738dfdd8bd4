"""Kernels B and E's tile body (``csrc/corr_lookup_tile.cuh``) on the CPU:
the tiling rule ``lookup_tile`` and its shared-memory arithmetic, the body
rule ``lookup_body``, and the rows a block stages (``lookup_window``)
against a brute-force list of the rows that carry a nonzero bilinear
weight.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import math

import numpy as np
import pytest
import torch

from videotgb_torch.ops.correlation_pallas import (
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMEM_RESERVED,
    SMS,
    level_sizes,
    lookup_body,
    lookup_row_bytes,
    lookup_tile,
    lookup_tile_bytes,
    lookup_window,
)


def _esize(dtype):
    return torch.empty((), dtype=dtype).element_size()


# ------------------------------------------------------------- tiling rule
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pairs", [1, 2, 16, 64, 256])
@pytest.mark.parametrize("hw", [(28, 28), (12, 12), (2, 2), (46, 62)])
def test_lookup_tile_is_a_block_the_body_takes(dtype, pairs, hw):
    h, w = hw
    tile = lookup_tile(pairs, h, w, 4, 4, dtype)
    assert tile is not None
    esize = _esize(dtype)
    assert tile.qb in (32, 64)
    row = lookup_row_bytes(w, tile.qb, esize)
    assert tile.stage_bytes % 128 == 0 and tile.stage_bytes % row == 0
    assert 2 <= tile.stage_bytes // row <= max(h, 2)
    smem = lookup_tile_bytes(tile.qb, 4, 4, esize, tile.stage_bytes)
    assert smem <= SMEM_PER_BLOCK
    # every level's scanline fits a stage twice (a row pair per chunk)
    for _, wl in level_sizes(h, w, 4):
        assert tile.stage_bytes >= 2 * lookup_row_bytes(wl, tile.qb, esize)


def test_lookup_tile_fills_the_card_on_the_serving_path():
    # RAFT's 16 pairs of 28 x 28 queries in bf16: 13 blocks a pair
    tile = lookup_tile(16, 28, 28, 4, 4, torch.bfloat16)
    assert tile.qb == 64
    assert 16 * math.ceil(784 / tile.qb) == 208 >= SMS
    # two blocks share an SM: the outputs (64 x 324 bf16), two stages of 10
    # scanlines of 28 x 64 bf16, two mbarriers a stage, 128 bytes of slack,
    # 104 of the cy reduction (13 warps' min and max)
    assert tile.stage_bytes == 10 * 28 * 64 * 2
    smem = lookup_tile_bytes(64, 4, 4, 2, tile.stage_bytes)
    assert smem == 128 + 41472 + 2 * (35840 + 16) + 104 == 113416
    assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    # the probe's 256 pairs take the same block
    assert lookup_tile(256, 28, 28, 4, 4, torch.bfloat16) == tile


def test_lookup_tile_takes_32_queries_where_64_leave_sms_idle():
    tile = lookup_tile(4, 28, 28, 4, 4, torch.bfloat16)
    assert tile.qb == 32 and 4 * math.ceil(784 / 64) < SMS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qb", [32, 64, 96, 128])
def test_lookup_tile_takes_every_block_of_kernel_e(dtype, qb):
    tile = lookup_tile(256, 28, 28, 4, 4, dtype, qb=qb)
    assert tile is not None and tile.qb == qb
    assert lookup_tile_bytes(qb, 4, 4, _esize(dtype),
                             tile.stage_bytes) <= SMEM_PER_BLOCK


def test_lookup_tile_trades_a_second_block_for_stages_of_8_rows():
    # qb 128 in bf16: two blocks an SM would leave 2 scanlines a stage
    tile = lookup_tile(256, 28, 28, 4, 4, torch.bfloat16, qb=128)
    row = lookup_row_bytes(28, 128, 2)
    assert tile.stage_bytes == 10 * row  # as many as one block an SM holds
    smem = lookup_tile_bytes(128, 4, 4, 2, tile.stage_bytes)
    assert 2 * (smem + SMEM_RESERVED) > SMEM_PER_SM
    assert smem <= SMEM_PER_BLOCK
    assert lookup_tile_bytes(128, 4, 4, 2, 11 * row) > SMEM_PER_BLOCK
    # a map of fewer rows needs no more than its rows
    tile = lookup_tile(64, 6, 28, 4, 4, torch.bfloat16)
    assert tile.qb == 64
    assert tile.stage_bytes == 6 * lookup_row_bytes(28, 64, 2)


@pytest.mark.parametrize("pairs, h, w, qb", [
    (11, 8, 149, 64),   # five 149-wide rows a stage would leave 96 bytes
    (2, 16, 118, 32),   # the same at qb 32
])
def test_lookup_tile_counts_the_whole_block_at_the_edge_of_the_budget(
        pairs, h, w, qb):
    # shapes where the block without its cy reduction would fit one more
    # scanline a stage, and the launch would then ask for more than a
    # block may have
    tile = lookup_tile(pairs, h, w, 4, 4, torch.bfloat16)
    assert tile.qb == qb
    assert lookup_body(_pyr(pairs, h, w, torch.bfloat16),
                       torch.zeros((pairs, h, w, 2)), 4) == "tile"
    row = lookup_row_bytes(w, qb, 2)
    smem = lookup_tile_bytes(qb, 4, 4, 2, tile.stage_bytes)
    assert smem <= SMEM_PER_BLOCK < smem + 2 * row
    assert smem - 104 + 2 * row <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qb", [None, 32, 64, 96, 128])
def test_lookup_tile_never_exceeds_a_blocks_shared_memory(dtype, qb):
    # every width TMA's box takes, at every radius, maps of 2 to 64 rows
    esize = _esize(dtype)
    for w in range(1, 257, 3):
        for h in (2, 5, 9, 14, 28, 64):
            for radius in range(5):
                tile = lookup_tile(4, h, w, 4, radius, dtype, qb=qb)
                if tile is None:
                    continue
                smem = lookup_tile_bytes(tile.qb, 4, radius, esize,
                                         tile.stage_bytes)
                assert smem <= SMEM_PER_BLOCK, (w, h, radius, tile)
                assert tile.stage_bytes >= 2 * lookup_row_bytes(
                    w, tile.qb, esize)


@pytest.mark.parametrize("args, kw", [
    ((16, 28, 28, 4, 5, torch.bfloat16), {}),             # r > 4
    ((16, 28, 300, 4, 4, torch.bfloat16), {}),            # wl > 256
    ((70000, 2, 2, 4, 4, torch.bfloat16), {}),            # pairs > grid y
    ((16, 28, 28, 4, 4, torch.bfloat16), {"qb": 48}),     # not 32k
    ((16, 28, 28, 4, 4, torch.bfloat16), {"qb": 160}),    # over 128
    ((16, 28, 256, 4, 4, torch.float32), {"qb": 128}),    # 2 rows: 256 KB
])
def test_lookup_tile_refuses_what_the_body_does_not_take(args, kw):
    assert lookup_tile(*args, **kw) is None


# --------------------------------------------------------------- body rule
def _pyr(p, h, w, dtype, shift=0):
    """A (p, hl*wl, h*w) pyramid of 4 levels; ``shift`` elements into its
    allocations."""
    return [torch.zeros(shift + p * hl * wl * h * w, dtype=dtype)[shift:]
            .view(p, hl * wl, h * w) for hl, wl in level_sizes(h, w, 4)]


BODY_CASES = {
    "bf16 28x28 (the RAFT path)": ((16, 28, 28, torch.bfloat16, 0), 4, "tile"),
    "f32 28x28": ((2, 28, 28, torch.float32, 0), 4, "tile"),
    "bf16 12x12": ((3, 12, 12, torch.bfloat16, 0), 4, "tile"),
    "f32 2x2 (16 bytes of queries)": ((1, 2, 2, torch.float32, 0), 4, "tile"),
    "bf16 radius 0": ((2, 12, 12, torch.bfloat16, 0), 0, "tile"),
    "bf16 5x5 (50 bytes of queries)": ((1, 5, 5, torch.bfloat16, 0), 4,
                                       "gather"),
    "f32 5x5": ((1, 5, 5, torch.float32, 0), 4, "gather"),
    "bf16 12x10 (240 bytes: whole 16)": ((2, 12, 10, torch.bfloat16, 0), 4,
                                         "tile"),
    "bf16 levels 4 elements off 16 bytes": ((2, 12, 12, torch.bfloat16, 4),
                                            4, "gather"),
    "bf16 levels 8 elements (16 bytes) in": ((2, 12, 12, torch.bfloat16, 8),
                                             4, "tile"),
    "bf16 radius 5": ((2, 12, 12, torch.bfloat16, 0), 5, "gather"),
    "fp16 (not a kernel dtype)": ((2, 12, 12, torch.float16, 0), 4,
                                  "gather"),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_lookup_body_rule(case):
    (p, h, w, dtype, shift), radius, want = BODY_CASES[case]
    pyr = _pyr(p, h, w, dtype, shift)
    coords = torch.zeros((p, h, w, 2))
    assert lookup_body(pyr, coords, radius) == want


# ---------------------------------------------------------- window mirror
def _coord_sets(p, h, w, rng):
    """(p, h, w, 2) f32 pixel coordinates: random over the map, RAFT's
    (the grid plus N(0, 2)), off the map, and near-integer (integers, and
    integers one f32 ulp either side, after halving to each level)."""
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([gx, gy], -1)[None].astype(np.float32)
    ints = rng.integers(-10, max(h, w) + 10, (p, h, w, 2)).astype(np.float32)
    # multiples of 8 stay integers down to level 3
    near = (rng.integers(-2, max(h, w) // 8 + 2, (p, h, w, 2)) * 8).astype(
        np.float32)
    near = np.where(rng.random(near.shape) < 0.5,
                    np.nextafter(near, np.float32(-1e9)),
                    np.nextafter(near, np.float32(1e9))).astype(np.float32)
    return {
        "random": (rng.random((p, h, w, 2)) * (max(h, w) - 1)),
        "raft": grid + 2.0 * rng.standard_normal((p, h, w, 2)),
        "off map": rng.random((p, h, w, 2)) * (max(h, w) + 16) - 8,
        "integers": ints,
        "near integers": near,
        "far off": rng.random((p, h, w, 2)) * 100 + 40,
    }


def _rows_with_weight(cy, level, radius, hl):
    """The rows of a level (hl rows) that carry a nonzero bilinear weight
    for any of the queries at y = cy, as the plain version weighs them (in
    f32: py = cy / 2^l + offset, weight max(0, 1 - |y - py|))."""
    cy = torch.as_tensor(cy, dtype=torch.float32)
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    py = cy[:, None] * (1.0 / 2 ** level) + offs
    ys = torch.arange(hl, dtype=torch.float32)
    wy = torch.clamp(1.0 - torch.abs(ys - py[..., None]), min=0.0)
    return set(torch.nonzero(wy.reshape(-1, hl).amax(0) > 0)
               .flatten().tolist())


def _kernel_rows(cy, level, radius, hl):
    """The rows the tile body reads for the queries at cy: floor(cy / 2^l)
    - r .. + r + 1, on the map."""
    rows = set()
    for y in np.asarray(cy, np.float32):
        f = math.floor(float(y) * 2.0 ** -level)
        rows |= set(range(max(f - radius, 0), min(f + radius + 1, hl - 1) + 1))
    return rows


@pytest.mark.parametrize("coords_name", ["random", "raft", "off map",
                                         "integers", "near integers",
                                         "far off"])
@pytest.mark.parametrize("hw, qb", [((28, 28), 64), ((12, 12), 32),
                                    ((9, 5), 32), ((4, 4), 32)])
def test_lookup_window_holds_every_row_with_weight(coords_name, hw, qb):
    h, w = hw
    rng = np.random.default_rng(7)
    coords = _coord_sets(3, h, w, rng)[coords_name].astype(np.float32)
    cy = coords[..., 1].reshape(3, h * w)
    sizes = level_sizes(h, w, 4)  # down to 1 x 1 on the small maps
    for radius in (4, 1, 0):
        for pair in range(3):
            for q0 in range(0, h * w, qb):
                ys = cy[pair, q0:q0 + qb]
                for level, (hl, _) in enumerate(sizes):
                    lo, hi = lookup_window(float(ys.min()), float(ys.max()),
                                           level, radius, hl)
                    window = set(range(lo, hi + 1))
                    assert _rows_with_weight(ys, level, radius, hl) <= window
                    assert _kernel_rows(ys, level, radius, hl) <= window


def test_lookup_window_is_clipped_and_may_be_empty():
    assert lookup_window(-50.0, -30.0, 0, 4, 28) == (0, -1)
    assert lookup_window(100.0, 120.0, 0, 4, 28) == (28, 27)
    assert lookup_window(0.0, 27.0, 0, 4, 28) == (0, 27)
    assert lookup_window(13.5, 13.5, 0, 4, 28) == (9, 18)
    assert lookup_window(13.5, 13.5, 1, 4, 14) == (2, 11)
    # a query 5 rows above the map reaches row 0: the partner row of its
    # last y offset
    assert lookup_window(-5.0, -5.0, 0, 4, 28) == (0, 0)
