"""videotgb_torch's CUDA kernels against their plain versions, on a card.

Every test here is marked ``gpu`` and skips (inside a fixture) without a
CUDA device. The file imports only torch, numpy and the port, so it also
runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from videotgb_torch.models import videotgb as V
from videotgb_torch.models.common import init_params
from videotgb_torch.models.raft import RAFT, RAFTConfig
from videotgb_torch.models.vit import ViTConfig, ViTModel
from videotgb_torch.ops import kernels
from videotgb_torch.ops.attention import (
    NEG_INF,
    dot_product_attention,
    flash_attention,
    flash_backward_cuda,
    flash_backward_reference,
    flash_bwd_passes,
    make_padding_bias,
)
from videotgb_torch.ops.correlation_pallas import (
    build_corr_pyramid_t,
    corr_lookup_cuda,
    lookup_body,
    lookup_corr_pyramid_t,
    lookup_corr_pyramid_t_plain,
    lookup_launch_args,
    lookup_tile,
)
from videotgb_torch.ops.decode import DecodeConfig
from videotgb_torch.ops.quant import (
    TILES,
    bf16_mm,
    bf16_mm_reference,
    bf16_ulp,
    int8_mm,
    int8_mm_reference,
)
from videotgb_torch.ops.select_pallas import (
    MAX_FRAMES,
    draw_seed,
    select_frames_cuda,
    select_frames_pallas,
    select_frames_pallas_reference,
)
from videotgb_torch.tools.attnlayoutprobe import (
    flash_bshd,
    flash_bshd_reference,
)
from videotgb_torch.tools.lnprobe import (
    add_ln,
    add_ln_reference,
    ln,
    ln_reference,
)
from videotgb_torch.tools.lookupprobe import blocked_lookup
from videotgb_torch.training.recipes import (
    E2ERecipe,
    IVRecipe,
    IVTRecipe,
    SFRecipe,
    pseudo_label_generate,
)
from videotgb_torch.training.trainer import Trainer, TrainerConfig

BIAS_LAYOUTS = ["none", "shared", "per_batch", "padding", "per_row", "learned"]
# bf16: output rounding (2^-8) and another f32 summation order; f32: the order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


def _bias(layout, gen, b, h, sq, skv, dev):
    if layout == "none":
        return None
    if layout == "padding":
        mask = (torch.rand((b, skv), generator=gen, device=dev) > 0.5).float()
        mask[:, 0] = 1
        return make_padding_bias(mask)
    shape = {"shared": (1, 1, sq, skv), "per_batch": (b, 1, sq, skv),
             "per_row": (b, h, sq, skv), "learned": (1, h, sq, skv),
             "per_query": (b, 1, sq, 1)}[layout]
    return torch.randn(shape, generator=gen, device=dev)


def _close_to_largest(got, want, tol, name=""):
    """|got - want| <= tol * max|want|: bf16 gradients carry one rounding
    of ds (to bf16) and of the output, each up to 2^-8 of an entry, summed
    over a row in another order; f32 gradients differ by summation order."""
    want = want.float()
    bound = tol * float(want.abs().max())
    err = float((got.float() - want).abs().max())
    assert err <= bound, f"{name}: max |err| {err:.3e} > {bound:.3e}"


def _launch_a(q, k, v, bias, body):
    """One launch of kernel A; checks that it counted once and ran
    ``body``."""
    kernels.reset_launches()
    out = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == 1
    assert kernels.MMA_LAUNCHES["flash_fwd"] == int(body == "mma"), body
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("layout", BIAS_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, layout, dtype):
    gen = torch.Generator(device=cuda).manual_seed(21)
    b, h, sq, skv, d = 2, 3, 70, 45, 88  # ragged, D not a power of two
    q = torch.randn((b, h, sq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, h, skv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    bias = _bias(layout, gen, b, h, sq, skv, cuda)
    body = "mma" if dtype == torch.bfloat16 else "fma"
    got = _launch_a(q, k, v, bias, body)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, dot_product_attention(q, k, v, bias), TOL[dtype])


# (Sq, Skv): each of 1, 15, 70, 264 and 300 on both sides, ragged against
# the tensor-core body's 64-row and 64-key tiles
SEQ_PAIRS = [(1, 1), (15, 300), (70, 264), (264, 70), (300, 15)]
MMA_DIMS = [16, 64, 72, 88, 96, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("seqs", SEQ_PAIRS)
@pytest.mark.parametrize("d", MMA_DIMS)
@pytest.mark.parametrize("layout", BIAS_LAYOUTS)
def test_flash_kernel_mma_body_matches_plain(cuda, layout, d, seqs):
    gen = torch.Generator(device=cuda).manual_seed(24)
    (b, h), (sq, skv) = (2, 3), seqs
    q = _strided(b, h, sq, d, torch.bfloat16, gen, cuda)
    k, v = (_strided(b, h, skv, d, torch.bfloat16, gen, cuda)
            for _ in range(2))
    bias = _bias(layout, gen, b, h, sq, skv, cuda)
    got = _launch_a(q, k, v, bias, "mma")
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, dot_product_attention(q, k, v, bias), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", BIAS_LAYOUTS)
def test_flash_kernel_unaligned_bf16_takes_the_fma_body(cuda, layout):
    gen = torch.Generator(device=cuda).manual_seed(25)
    b, h, s, d = 2, 3, 70, 64
    flat = torch.randn((3, 4 + b * s * h * d), generator=gen,
                       device=cuda).to(torch.bfloat16)
    # 4 elements (8 bytes) into the allocation: rows not 16-byte aligned
    q, k, v = (t[4:].view(b, s, h, d).transpose(1, 2) for t in flat)
    bias = _bias(layout, gen, b, h, s, s, cuda)
    got = _launch_a(q, k, v, bias, "fma")
    _close(got, dot_product_attention(q, k, v, bias), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_masked_row_is_uniform(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v = (torch.randn((1, 2, 40, 64), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    bias = torch.zeros((1, 1, 40, 40), device=cuda)
    bias[..., 7, :] = NEG_INF
    body = "mma" if dtype == torch.bfloat16 else "fma"
    got = _launch_a(q, k, v, bias, body)
    assert torch.isfinite(got).all()
    _close(got[:, :, 7], v.float().mean(dim=2), TOL[dtype])


@pytest.mark.gpu
def test_flash_c_entries_refuse_the_mma_body_without_16_byte_rows(cuda):
    """The C entries check the rule themselves: f32, or a bf16 row 8 bytes
    off, with body 1 (tensor cores) is cudaErrorInvalidValue (1)."""
    lib_a = kernels.library("flash_fwd")
    lib_g = kernels.library("flash_bshd")
    stream = torch.cuda.current_stream().cuda_stream
    b, s, h, d = 1, 16, 2, 64
    for dtype, shift in ((torch.float32, 0), (torch.bfloat16, 4)):
        buf = torch.zeros(shift + b * s * h * d, dtype=dtype, device=cuda)
        x = buf[shift:].view(b, s, h, d)
        out = torch.empty((b, s, h, d), dtype=dtype, device=cuda)
        code = 0 if dtype == torch.float32 else 1
        strides = [t.stride(i) for t in (x, x, x, out) for i in (0, 2, 1)]
        rc = lib_a.flash_fwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), None,
                             out.data_ptr(), b, h, s, s, d, *strides,
                             0, 0, 0, 0, 0.125, code, 1, stream)
        assert rc == 1, (dtype, rc)
        strides = [t.stride(i) for t in (x, x, x, out) for i in range(3)]
        rc = lib_g.flash_bshd(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                              out.data_ptr(), b, s, h, d, *strides, 0.125,
                              code, 1, stream)
        assert rc == 1, (dtype, rc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(22)
    f1, f2 = (torch.randn((3, 12, 12, 32), generator=gen, device=cuda).to(dtype)
              for _ in range(2))
    pyr = build_corr_pyramid_t(f1, f2, 4)
    coords = torch.rand((3, 12, 12, 2), generator=gen, device=cuda) * 24 - 6
    before = kernels.LAUNCHES["corr_lookup"]
    got = lookup_corr_pyramid_t(pyr, coords, 4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_lookup"] == before + 1
    assert got.dtype == dtype
    _close(got, lookup_corr_pyramid_t_plain(pyr, coords, 4), TOL[dtype])


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    q = torch.randn((1, 1, 8, 160), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    pyr = build_corr_pyramid_t(*(torch.randn((1, 4, 4, 8), device=cuda)
                                 for _ in range(2)), 2)
    with pytest.raises(ValueError, match="level"):
        lookup_corr_pyramid_t(pyr[:1] + [pyr[0]], torch.zeros((1, 4, 4, 2),
                                                               device=cuda), 1)


def _lookup_inputs(gen, dev, pairs, h, w, dtype, coords="raft", c=32):
    """A pyramid of two random (pairs, h, w, c) feature maps and (pairs, h,
    w, 2) coordinates: RAFT's (the grid plus N(0, 2)), or off the map."""
    f1, f2 = (torch.randn((pairs, h, w, c), generator=gen, device=dev)
              .to(dtype) for _ in range(2))
    if coords == "raft":
        gy, gx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        xy = torch.stack([gx, gy], -1)[None].float() + 2.0 * torch.randn(
            (pairs, h, w, 2), generator=gen, device=dev)
    else:
        xy = torch.rand((pairs, h, w, 2), generator=gen,
                        device=dev) * (max(h, w) + 16) - 8
    return build_corr_pyramid_t(f1, f2, 4), xy


def _check_tile(pyr, coords, radius, dtype):
    assert lookup_body(pyr, coords, radius) == "tile"
    kernels.reset_launches()
    got = corr_lookup_cuda(pyr, coords, radius)
    torch.cuda.synchronize()
    assert kernels.TILE_LAUNCHES["corr_lookup"] == 1
    assert got.dtype == dtype
    _close(got, lookup_corr_pyramid_t_plain(pyr, coords, radius), TOL[dtype])


def _tile_entry(pyr, xy, radius, qb, stage_bytes):
    """Kernel B's C entry on the tile body with a block of the caller's:
    its return code and output."""
    out, args, _keep = lookup_launch_args("test", pyr, xy, radius)
    rc = kernels.library("corr_lookup").corr_lookup(
        *args, 1, qb, stage_bytes, int(out.dtype == torch.bfloat16), None,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return rc, out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [0, 1, 2, 3, 4])
def test_lookup_tile_body_matches_plain_at_the_serving_shape(cuda, dtype,
                                                             radius):
    # RAFT's 16 pairs of 28 x 28 queries
    gen = torch.Generator(device=cuda).manual_seed(41)
    pyr, coords = _lookup_inputs(gen, cuda, 16, 28, 28, dtype, c=64)
    _check_tile(pyr, coords, radius, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("coords", ["raft", "off map"])
def test_lookup_tile_body_matches_plain_at_256_pairs(cuda, coords):
    gen = torch.Generator(device=cuda).manual_seed(42)
    pyr, xy = _lookup_inputs(gen, cuda, 256, 28, 28, torch.bfloat16, coords)
    _check_tile(pyr, xy, 4, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(12, 12), (8, 8), (4, 4), (12, 20)])
@pytest.mark.parametrize("coords", ["raft", "off map"])
@pytest.mark.parametrize("qb", [32, 64, 128])
def test_lookup_tile_body_ragged_blocks_and_1x1_levels(cuda, dtype, hw,
                                                       coords, qb):
    # Q not a multiple of qb (144, 64 (8 x 8) with qb 128, 16, 240); levels
    # down to 1 x 1 (8 x 8 and 4 x 4); every qb through kernel E's entry
    # (B's C entry with its rows skipped), the rule's through B's
    h, w = hw
    gen = torch.Generator(device=cuda).manual_seed(43)
    pyr, xy = _lookup_inputs(gen, cuda, 3, h, w, dtype, coords)
    want = lookup_corr_pyramid_t_plain(pyr, xy, 4)
    kernels.reset_launches()
    got = blocked_lookup(pyr, xy, 4, qb=qb, skip=True)
    torch.cuda.synchronize()
    assert kernels.TILE_LAUNCHES["corr_lookup_blocked"] == 1
    _close(got, want, TOL[dtype])
    if lookup_tile(3, h, w, 4, 4, dtype).qb == qb:
        _check_tile(pyr, xy, 4, dtype)


@pytest.mark.gpu
def test_lookup_tile_body_with_two_scanlines_a_stage(cuda):
    # chunks of two rows: every row pair of a window in a chunk of its own
    gen = torch.Generator(device=cuda).manual_seed(44)
    pyr, xy = _lookup_inputs(gen, cuda, 4, 28, 28, torch.bfloat16)
    for qb in (32, 64, 128):
        rc, got = _tile_entry(pyr, xy, 4, qb, 2 * 28 * qb * 2)
        assert rc == 0
        _close(got, lookup_corr_pyramid_t_plain(pyr, xy, 4),
               TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("pairs, h, w", [(11, 8, 149), (2, 16, 118)])
def test_lookup_tile_body_at_the_edge_of_the_shared_memory_budget(cuda, pairs,
                                                                  h, w):
    # blocks within 104 bytes of a block's shared memory (the cy reduction
    # counted in the dynamic share)
    gen = torch.Generator(device=cuda).manual_seed(49)
    pyr, xy = _lookup_inputs(gen, cuda, pairs, h, w, torch.bfloat16)
    _check_tile(pyr, xy, 4, torch.bfloat16)


@pytest.mark.gpu
def test_lookup_gather_body_on_an_unaligned_query_count(cuda):
    # 5 x 5 bf16: 50 bytes of queries a position, which TMA cannot copy
    gen = torch.Generator(device=cuda).manual_seed(45)
    pyr, xy = _lookup_inputs(gen, cuda, 3, 5, 5, torch.bfloat16, "off map")
    assert lookup_body(pyr, xy, 4) == "gather"
    kernels.reset_launches()
    got = lookup_corr_pyramid_t(pyr, xy, 4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_lookup"] == 1
    assert kernels.TILE_LAUNCHES["corr_lookup"] == 0
    _close(got, lookup_corr_pyramid_t_plain(pyr, xy, 4), TOL[torch.bfloat16])
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        corr_lookup_cuda(pyr, xy, 4, body="tile")


@pytest.mark.gpu
def test_raft_refine_runs_every_lookup_on_the_tile_body(cuda):
    # the serving path's RAFT: bf16 convolutions, 224 x 224 frames, 20 GRU
    # iterations, a query-minor bf16 pyramid of 28 x 28
    cfg = RAFTConfig(dtype=torch.bfloat16)
    raft = init_params(RAFT(cfg, device=cuda), seed=3)
    gen = torch.Generator(device=cuda).manual_seed(46)
    img = torch.randint(0, 256, (4, 224, 224, 3), generator=gen,
                        device=cuda).float()
    kernels.reset_launches()
    with torch.no_grad():
        flow = raft(img[:2], img[2:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_lookup"] == cfg.iters == 20
    assert kernels.TILE_LAUNCHES["corr_lookup"] == cfg.iters
    assert torch.isfinite(flow).all()


@pytest.mark.gpu
def test_lookup_c_entries_refuse_what_the_tile_body_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(47)
    stream = torch.cuda.current_stream().cuda_stream
    lib_b = kernels.library("corr_lookup")
    lib_e = kernels.library("corr_lookup_blocked")

    def rc_b(pyr, xy, radius, body, ring, dtype=1):
        _, args, _keep = lookup_launch_args("test", pyr, xy, radius)
        return lib_b.corr_lookup(*args, body, *ring, dtype, None, stream)

    def rc_e(pyr, xy, radius, ring, dtype=1):
        _, args, _keep = lookup_launch_args("test", pyr, xy, radius)
        return lib_e.corr_lookup_blocked(*args, ring[0], 1, ring[1], dtype,
                                         stream)

    pyr, xy = _lookup_inputs(gen, cuda, 2, 12, 12, torch.bfloat16)
    ring = tuple(lookup_tile(2, 12, 12, 4, 4, torch.bfloat16, qb=64))
    assert rc_b(pyr, xy, 4, 1, ring) == 0
    assert rc_e(pyr, xy, 4, ring) == 0
    torch.cuda.synchronize()
    row = 12 * 64 * 2
    bad_rings = [(48, ring[1]), (160, ring[1]), (64, row),
                 (64, ring[1] + 64), (64, 150 * row)]
    # qb, a stage under 2 rows, an unaligned stage, a block over the budget
    for bad in bad_rings:
        assert rc_b(pyr, xy, 4, 1, bad) == 1, bad
        assert rc_e(pyr, xy, 4, bad) == 1, bad
    assert rc_b(pyr, xy, 4, 2, ring) == 1              # no such body
    assert rc_b(pyr, xy, 5, 1, ring) == 1              # r > 4
    assert rc_e(pyr, xy, 5, ring) == 1
    assert rc_b(pyr, xy, 4, 1, ring, dtype=2) == 1     # no such dtype
    pyr5, xy5 = _lookup_inputs(gen, cuda, 2, 5, 5, torch.bfloat16)
    assert rc_b(pyr5, xy5, 4, 1, ring) == 1            # 50-byte rows
    assert rc_e(pyr5, xy5, 4, ring) == 1
    assert rc_b(pyr5, xy5, 4, 0, ring) == 0            # the gather body
    off = [torch.empty(lvl.numel() + 4, dtype=lvl.dtype, device=cuda)[4:]
           .view(lvl.shape).copy_(lvl) for lvl in pyr]
    assert rc_b(off, xy, 4, 1, ring) == 1              # levels off 16 bytes
    assert rc_e(off, xy, 4, ring) == 1
    torch.cuda.synchronize()


def _tiny_f32(backbone="blip2"):
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    cfg = V.VideoTGBConfig.tiny(backbone)

    def rep(sub):
        return dataclasses.replace(sub, **f32)

    bc, ic = cfg.blip2, cfg.instructblip
    return dataclasses.replace(
        cfg, tgb=rep(cfg.tgb),
        blip2=None if bc is None else dataclasses.replace(
            bc, vit=rep(bc.vit), qformer=rep(bc.qformer), t5=rep(bc.t5)),
        instructblip=None if ic is None else dataclasses.replace(
            ic, vit=rep(ic.vit), qformer=rep(ic.qformer), llm=rep(ic.llm)))


@pytest.mark.gpu
def test_tiny_pipeline_on_the_card_matches_the_cpu(cuda):
    cfg = _tiny_f32()
    cpu = V.VideoTGB(cfg, device="cpu", seed=4)
    gpu = V.VideoTGB(cfg, device=cuda, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    flow = torch.randint(0, 256, (2, 4, 32, 32, 3), generator=g,
                         dtype=torch.uint8)
    frames = torch.randint(0, 256, (2, cfg.nframe, 56, 56, 3), generator=g,
                           dtype=torch.uint8)
    batch = {"flow_mask": torch.ones(2, 5), "video_length": torch.tensor([3, 3]),
             "sampler_question_ids": torch.randint(4, 300, (2, 5), generator=g),
             "sampler_question_mask": torch.ones(2, 5),
             "question_ids": torch.randint(4, 300, (2, 6), generator=g),
             "question_mask": torch.ones(2, 6)}
    noise = torch.randn((cfg.top_k, 2, 2, 3), generator=g)
    kernels.reset_launches()
    cand = V.select_phase_blip2(gpu, flow, batch, noise=noise)
    assert kernels.LAUNCHES["corr_lookup"] == cfg.raft.iters
    assert kernels.LAUNCHES["select_frames"] == 1  # kernel D, not ops.select
    assert cand.dtype == torch.int64
    assert torch.equal(cand.cpu(), V.select_phase_blip2(cpu, flow, batch,
                                                        noise=noise))
    dcfg = DecodeConfig(max_new_tokens=4)
    got = V.answer_phase_blip2(gpu, frames, batch, dcfg).cpu()
    want = V.answer_phase_blip2(cpu, frames, batch, dcfg)
    assert float((got == want).float().mean()) >= 0.75  # near-tie argmax


def _prefill_bias(lengths, s, slots, dev):
    """The Vicuna cache forward's (B, 1, S, slots) bias: k_pos <= q_pos and
    the prompt's right padding and the unwritten decode slots masked."""
    keys = torch.arange(slots, device=dev)
    causal = torch.where(keys[None] <= torch.arange(s, device=dev)[:, None],
                         0.0, NEG_INF)
    valid = (keys[None] < lengths[:, None]).float()
    return causal[None, None] + make_padding_bias(valid)


@pytest.mark.gpu
def test_flash_kernel_mma_body_at_the_vicuna_prefill_shape(cuda):
    """Kernel A as the Vicuna-7B prefill launches it: (4, 32, 96, 224, 128),
    q a strided view, k/v the contiguous cache buffers, a per-batch (4, 1,
    96, 224) bias broadcast over the heads (stride 0)."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    b, h, sq, skv, d = 4, 32, 96, 224, 128
    q = _strided(b, h, sq, d, torch.bfloat16, gen, cuda)
    k, v = (torch.randn((b, h, skv, d), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([96, 80, 64, 33], device=cuda)
    bias = _prefill_bias(lengths, sq, skv, cuda)
    got = _launch_a(q, k, v, bias, "mma")
    _close(got, dot_product_attention(q, k, v, bias), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("s_kv", [32, 264])
def test_flash_kernel_mma_body_at_the_qformer_shapes(cuda, s_kv):
    """Kernel A below the flash rule, as ``tools/qformerattnprobe.py``'s
    variant c launches it: 32 queries of 12 heads x 64 over the 32 queries
    (with the Q-Former's (F, 1, 1, 32) padding bias) or 264 ViT-g tokens,
    the (B, H, S, D) transposes of (B, S, 768) projections; one partly
    filled 64-row query tile per head."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    frames, h, sq, d = 16, 12, 32, 64

    def proj(s):
        x = torch.randn((frames, s, h * d), generator=gen, device=cuda)
        return x.to(torch.bfloat16).reshape(frames, s, h, d).transpose(1, 2)

    q, k, v = proj(sq), proj(s_kv), proj(s_kv)
    bias = (make_padding_bias(torch.ones((frames, s_kv), device=cuda))
            if s_kv == sq else None)
    got = _launch_a(q, k, v, bias, "mma")
    _close(got, dot_product_attention(q, k, v, bias), TOL[torch.bfloat16])


@pytest.mark.gpu
def test_native_clip_transform_on_the_cards_machine(cuda):
    """The C++ host library builds on the card's machine, and
    ``clip_transform``'s native path agrees with its numpy path within
    2e-2 (bilinear weights against cv2's fixed-point ones)."""
    from videotgb_torch.data import native, transforms

    assert native.available()
    frames = np.random.default_rng(0).integers(0, 256, (4, 120, 160, 3),
                                               np.uint8)
    got = transforms.clip_transform(frames, 224)
    want = transforms.clip_transform(frames, 224, use_native=False)
    assert got.shape == (4, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.gpu
def test_vicuna_phases_launch_counts_at_small_width(cuda):
    """The Vicuna path at ``small`` width in bf16: the select phase in
    "multi_modal" / "ratio" launches B per refine and D once; the answer
    phase A once per ViT layer, and once per LLaMA layer on the prefill
    exactly when 96 * (96 + max_new_tokens) > 128^2 (max_new_tokens >=
    75); the decode steps none."""
    cfg = V.bf16_param_config(V.VideoTGBConfig.small("instructblip"))
    model = V.VideoTGB(cfg, device=cuda, seed=5)
    g = torch.Generator(device=cuda).manual_seed(5)
    b, text_len = 2, 64
    flow = torch.randint(0, 256, (b, 5, cfg.tgb.flow_size, cfg.tgb.flow_size,
                                  3), generator=g, device=cuda,
                         dtype=torch.uint8)
    frames = torch.randint(0, 256, (b, cfg.nframe, 224, 224, 3), generator=g,
                           device=cuda, dtype=torch.uint8)
    ids = torch.randint(100, 5000, (b, text_len), generator=g, device=cuda)
    mask = torch.ones((b, text_len), device=cuda)
    mask[1, 40:] = 0
    batch = {"flow_mask": torch.ones((b, 6), device=cuda),
             "video_length": torch.full((b,), 4, device=cuda),
             "sampler_question_ids": ids, "sampler_question_mask": mask,
             "question_ids": ids, "question_mask": mask,
             "qformer_input_ids": ids, "qformer_attention_mask": mask}
    kernels.reset_launches()
    cand = V.select_phase_blip2(model, flow, batch, generator=g,
                                mode="multi_modal", rescale="ratio")
    assert dict(kernels.LAUNCHES, corr_lookup=0, select_frames=0) == \
        dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels.LAUNCHES["corr_lookup"] == cfg.raft.iters
    assert kernels.LAUNCHES["select_frames"] == 1
    assert cand.shape == (b, cfg.nframe) and int(cand.max()) < cfg.num_frames
    llm = cfg.instructblip.llm
    for max_new, prefill in ((74, 0), (75, llm.num_layers)):
        kernels.reset_launches()
        tokens = V.answer_phase_instructblip(
            model, frames, batch, DecodeConfig(
                max_new_tokens=max_new, eos_token_id=llm.eos_token_id,
                pad_token_id=llm.pad_token_id))
        assert tokens.shape == (b, max_new)
        assert 0 <= int(tokens.min()) and int(tokens.max()) < llm.vocab_size
        want = {**dict.fromkeys(kernels.LAUNCHES, 0),
                "flash_fwd": cfg.instructblip.vit.num_layers + prefill}
        assert dict(kernels.LAUNCHES) == want, max_new
        assert kernels.MMA_LAUNCHES["flash_fwd"] == want["flash_fwd"]


@pytest.mark.gpu
def test_tiny_e2e_tgb_selection_on_the_card_launches_kernel_d(cuda):
    """The E2E recipe's "tgb" selection on the card is one launch of kernel
    D: with handed noise the same frames as the CPU route and the same loss
    (1e-4 relative: summation order); with a CUDA generator the seed is
    drawn there and the frames are in range."""
    cfg = _tiny_f32()
    cpu = V.VideoTGB(cfg, device="cpu", seed=6)
    gpu = V.VideoTGB(cfg, device=cuda, seed=6)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    b, l, img, fs = 2, 6, cfg.blip2.vit.image_size, cfg.tgb.flow_size
    batch = {"frames": torch.randn((b, cfg.num_frames, img, img, 3),
                                   generator=g),
             "flow": torch.randn((b, l, fs, fs, 2), generator=g),
             "flow_mask": torch.ones((b, l + 2)),
             "video_length": torch.tensor([l, l - 2]),
             "sampler_question_ids": torch.randint(4, 300, (b, 5),
                                                   generator=g),
             "sampler_question_mask": torch.ones((b, 5)),
             "question_ids": torch.randint(4, 300, (b, 6), generator=g),
             "question_mask": torch.ones((b, 6)),
             "answer_ids": torch.randint(2, 300, (b, 4), generator=g)}
    noise = torch.randn((cfg.top_k, 2, b, l), generator=g)  # (B, L) logits
    recipe = E2ERecipe(selection="tgb")
    with torch.no_grad():
        want, want_aux = recipe.loss_fn(cpu, batch, deterministic=True,
                                        noise=noise)
        on_card = {k: v.to(cuda) for k, v in batch.items()}
        kernels.reset_launches()
        got, aux = recipe.loss_fn(gpu, on_card, deterministic=True,
                                  noise=noise)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["select_frames"] == 1
        assert torch.equal(aux["cand"].cpu(), want_aux["cand"])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
        gen = torch.Generator(device=cuda).manual_seed(3)
        _, drawn = recipe.loss_fn(gpu, on_card, gen, deterministic=True)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_frames"] == 2
    cand = drawn["cand"]
    assert cand.dtype == torch.int64 and tuple(cand.shape) == (b, cfg.nframe)
    assert int(cand.min()) >= 0 and int(cand.max()) < cfg.num_frames


def _train_batch(cfg, b, l, gen):
    """A tiny training batch for every recipe and backbone: frames, flow
    and its RGB frames, the T5 and the packed Vicuna text, the Q-Former
    instruction, per-frame scores."""
    img, fs = cfg.vit.image_size, cfg.tgb.flow_size
    ids = torch.randint(4, 300, (b, 6), generator=gen)
    labels = ids.clone()
    labels[:, :3] = -100
    scores = torch.zeros((b, cfg.num_frames))
    scores[0, 1:3] = 0.5
    scores[1:, 2:] = 0.25
    return {"frames": torch.randn((b, cfg.num_frames, img, img, 3),
                                  generator=gen),
            "flow": torch.randn((b, l, fs, fs, 2), generator=gen),
            "flow_frames": torch.randint(0, 256, (b, l + 1, fs, fs, 3),
                                         generator=gen).float(),
            "flow_mask": torch.ones((b, l + 2)),
            "video_length": torch.tensor([l, l - 2]),
            "sampler_question_ids": torch.randint(4, 300, (b, 5),
                                                  generator=gen),
            "sampler_question_mask": torch.ones((b, 5)),
            "qformer_input_ids": torch.randint(4, 300, (b, 5), generator=gen),
            "qformer_attention_mask": torch.ones((b, 5)),
            "question_ids": ids, "question_mask": torch.ones((b, 6)),
            "answer_ids": torch.randint(2, 300, (b, 4), generator=gen),
            "instruction_ids": ids, "instruction_mask": torch.ones((b, 6)),
            "labels": labels, "scores": scores}


def _step_on_both(cfg, recipe, seed):
    """One recipe step's loss and gradients on the card and on the CPU from
    the same weights, batch and handed selection noise (dropout off);
    returns (card loss, aux, grads, launches; CPU loss, aux, grads)."""
    cpu = V.VideoTGB(cfg, device="cpu", seed=seed)
    gpu = V.VideoTGB(cfg, device=torch.device("cuda"), seed=seed)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(seed)
    b, l = 2, 6
    batch = _train_batch(cfg, b, l, g)
    noise = torch.randn((cfg.top_k, 2, b, l), generator=g)
    out = []
    for model in (gpu, cpu):
        for n, p in model.named_parameters():
            p.requires_grad_(recipe.filter_fn(n))
        dev = model.device
        kernels.reset_launches()
        loss, aux = recipe.loss_fn(
            model, {k: v.to(dev) for k, v in batch.items()},
            deterministic=True, noise=noise.to(dev))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        out.append((loss.detach().cpu(), aux, grads, dict(kernels.LAUNCHES)))
    return out


def _check_step(card, host):
    """The same frames, the loss within 1e-4 (summation order), and each
    trainable gradient within 1e-3 of its largest entry: f32 sums in
    another order, compounded through the backward, and RAFT's
    convolutions in TF32 on the card. A tensor whose CPU gradient is zero
    up to f32 rounding (its largest entry below 1e-6 of the model's largest
    gradient: the attention key biases, biases into a LayerNorm) is held to
    staying there, within 1e-6 of the model's largest gradient."""
    (loss, aux, grads, _), (want, want_aux, want_grads, _) = card, host
    assert torch.equal(aux["cand"].cpu(), want_aux["cand"])
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    assert grads.keys() == want_grads.keys() and grads
    top = max(float(g.abs().max()) for g in want_grads.values())
    for n, g in grads.items():
        w = want_grads[n]
        if float(w.abs().max()) < 1e-6 * top:
            assert float((g - w).abs().max()) <= 1e-6 * top, n
        else:
            _close_to_largest(g, w, 1e-3, n)


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,online", [
    ("blip2", False), ("instructblip_t5", True), ("instructblip", False)])
def test_tiny_sf_step_on_the_card_matches_the_cpu(cuda, backbone, online):
    """The SF recipe's step on the card: the same span targets, frames,
    loss (1e-4 relative: summation order) and trainable gradients as on
    the CPU; kernel D once, and with ``online_flow`` kernel B once per RAFT
    refine. Then the pseudo-label pass: tokens of the card and the CPU
    agree on at least 3 of 4 (argmax near-ties in f32)."""
    cfg = _tiny_f32(backbone)
    card, host = _step_on_both(cfg, SFRecipe(online_flow=online), 7)
    _check_step(card, host)
    for k in ("start_targets", "end_targets"):
        assert torch.equal(card[1][k].cpu(), host[1][k])
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "select_frames": 1,
            "corr_lookup": cfg.raft.iters if online else 0}
    assert card[3] == want
    models = [V.VideoTGB(cfg, device=d, seed=8) for d in (cuda, "cpu")]
    models[0].load_state_dict(models[1].state_dict())
    g = torch.Generator().manual_seed(8)
    batch = _train_batch(cfg, 2, 6, g)
    toks = [pseudo_label_generate(
        m, *(batch[k].to(m.device) for k in (
            "frames", "question_ids", "question_mask")), max_new_tokens=4,
        qformer_input_ids=batch["qformer_input_ids"].to(m.device),
        qformer_attention_mask=batch["qformer_attention_mask"].to(m.device)
    ).cpu() for m in models]
    assert toks[0].shape == (2 * cfg.num_frames, 4)
    assert float((toks[0] == toks[1]).float().mean()) >= 0.75


@pytest.mark.gpu
def test_tiny_vicuna_e2e_step_on_the_card_matches_the_cpu(cuda):
    """The E2E recipe on InstructBLIP-Vicuna ("multi_modal", "tgb"
    selection): the LLaMA frozen, the same frames, loss and gradients of
    the TGB and the Q-Former on the card as on the CPU; kernel D once."""
    cfg = _tiny_f32("instructblip")
    card, host = _step_on_both(cfg, E2ERecipe(mode="multi_modal"), 9)
    _check_step(card, host)
    assert not any(n.startswith("model.language_model") for n in card[2])
    assert card[3] == {**dict.fromkeys(kernels.LAUNCHES, 0),
                       "select_frames": 1}


BWD_LAYOUTS = BIAS_LAYOUTS + ["per_query"]


def _strided(b, h, s, d, dtype, gen, dev):
    # the (B, H, S, D) views of (B, S, H, D) projections the models pass
    return torch.randn((b, s, h, d), generator=gen, device=dev).to(
        dtype).transpose(1, 2)


def _launch_c(q, k, v, bias, g, scale, body, need_ds=False):
    """One launch of kernel C; checks that it counted once and ran
    ``body``."""
    kernels.reset_launches()
    got = flash_backward_cuda(q, k, v, bias, g, scale,
                              bias_needs_grad=need_ds)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd"] == 1
    assert kernels.MMA_LAUNCHES["flash_bwd"] == int(body == "mma"), body
    return got


def _check_dbias(got, want, q, k, v, bias, g, scale, tol):
    """dbias sums ds over the bias's broadcast dims, and that sum may cancel
    to nothing (a per-query bias shifts a whole softmax row: its gradient
    is 0), so its error is bounded by the sum of the |ds| it adds up."""
    b, h, sq, _ = q.shape
    full = bias.expand(b, h, sq, k.shape[2]).contiguous()
    ds = flash_backward_reference(q, k, v, full, g, scale)[3].abs()
    for axis in range(4):
        if bias.shape[axis] == 1:
            ds = ds.sum(dim=axis, keepdim=True)
    assert got.shape == bias.shape
    err = float((got - want).abs().max())
    assert err <= tol * float(ds.max()), f"dbias: {err:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("layout", BWD_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda, layout, dtype):
    gen = torch.Generator(device=cuda).manual_seed(31)
    b, h, sq, skv, d = 2, 3, 70, 45, 88  # ragged, D not a power of two
    q = _strided(b, h, sq, d, dtype, gen, cuda)
    k, v = (_strided(b, h, skv, d, dtype, gen, cuda) for _ in range(2))
    g = _strided(b, h, sq, d, dtype, gen, cuda)
    bias = _bias(layout, gen, b, h, sq, skv, cuda)
    got = _launch_c(q, k, v, bias, g, d ** -0.5, "mma" if dtype ==
                    torch.bfloat16 else "fma", need_ds=True)
    want = flash_backward_reference(q, k, v, bias, g, d ** -0.5)
    for name, a, e in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        _close_to_largest(a, e, TOL[dtype], name)
    if bias is None:
        assert got[3] is None and want[3] is None
        return
    _check_dbias(got[3], want[3], q, k, v, bias, g, d ** -0.5, TOL[dtype])


@pytest.mark.gpu
def test_flash_bwd_kernel_masked_row(cuda):
    gen = torch.Generator(device=cuda).manual_seed(32)
    q, k, v, g = (torch.randn((1, 2, 40, 64), generator=gen, device=cuda)
                  for _ in range(4))
    bias = torch.zeros((1, 1, 40, 40), device=cuda)
    bias[..., 7, :] = NEG_INF
    got = flash_backward_cuda(q, k, v, bias, g, 0.125, bias_needs_grad=False)
    want = flash_backward_reference(q, k, v, bias, g, 0.125,
                                    bias_needs_grad=False)
    assert got[3] is None
    for a, e in zip(got[:3], want[:3]):
        assert torch.isfinite(a).all()
        _close_to_largest(a, e, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_needs_grad", [True, False])
def test_flash_attention_gradients_through_the_kernels(cuda, bias_needs_grad,
                                                       dtype):
    """autograd through the flash Function (kernel A's forward, on the
    CUDA-core body in f32 and the tensor-core body in bf16, and kernel C)
    against autograd of the plain attention, with a bias that requires its
    gradient (kernel C writes ds) and with a constant one."""
    gen = torch.Generator(device=cuda).manual_seed(33)
    b, h, s, d = 2, 4, 150, 64
    leaves = [_strided(b, h, s, d, dtype, gen, cuda).requires_grad_()
              for _ in range(3)]
    bias = torch.randn((1, h, s, s), generator=gen,
                       device=cuda).requires_grad_(bias_needs_grad)
    wrt = leaves + ([bias] if bias_needs_grad else [])
    g = torch.randn((b, h, s, d), generator=gen, device=cuda).to(dtype)
    kernels.reset_launches()
    out = flash_attention(*leaves, bias)
    got = torch.autograd.grad(out, wrt, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == 1
    assert kernels.MMA_LAUNCHES["flash_fwd"] == int(dtype == torch.bfloat16)
    assert kernels.LAUNCHES["flash_bwd"] == 1
    want_out = dot_product_attention(*leaves, bias)
    _close(out.detach(), want_out.detach(), TOL[dtype])
    want = torch.autograd.grad(want_out, wrt, g)
    assert len(got) == len(want)
    for a, e in zip(got, want):
        _close_to_largest(a, e, TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_long_sequence_backward_launches_the_kernel(cuda):
    """Past the JAX kernel's 1024 limit the tiled kernel still runs."""
    gen = torch.Generator(device=cuda).manual_seed(34)
    leaves = [torch.randn((1, 2, 1100, 16), generator=gen,
                          device=cuda).requires_grad_() for _ in range(3)]
    g = torch.randn((1, 2, 1100, 16), generator=gen, device=cuda)
    kernels.reset_launches()
    got = torch.autograd.grad(flash_attention(*leaves), leaves, g)
    assert kernels.LAUNCHES["flash_bwd"] == 1
    want = torch.autograd.grad(dot_product_attention(*leaves), leaves, g)
    for a, e in zip(got, want):
        _close_to_largest(a, e, 1e-4)


def _t5_bias(gen, dev, b=8, h=32, s=160):
    """The T5-xl encoder's bias as the model hands it to kernel C: relative
    positions (1, H, S, S) + padding (B, 1, 1, S), one (B, H, S, S) f32."""
    lens = torch.randint(120, s + 1, (b,), generator=gen, device=dev)
    keys = torch.arange(s, device=dev)
    pad = torch.where(keys[None] < lens[:, None], 0.0, NEG_INF)
    return (torch.randn((1, h, s, s), generator=gen, device=dev)
            + pad.float()[:, None, None])


def _c_inputs(gen, dev, b, h, sq, skv, d):
    q, g = (_strided(b, h, sq, d, torch.bfloat16, gen, dev)
            for _ in range(2))
    k, v = (_strided(b, h, skv, d, torch.bfloat16, gen, dev)
            for _ in range(2))
    return q, k, v, g


def _check_c(got, want, names=("dq", "dk", "dv")):
    for name, a, e in zip(names, got, want):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        assert torch.isfinite(a).all(), name
        _close_to_largest(a, e, TOL[torch.bfloat16], name)


@pytest.mark.gpu
def test_flash_bwd_mma_body_main_shape_with_the_t5_bias(cuda):
    """The E2E path's shape, (8, 32, 160, 64) bf16 views with the T5
    encoder's (8, 32, 160, 160) bias, no ds: one launch of the tensor-core
    body."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, k, v, g = _c_inputs(gen, cuda, 8, 32, 160, 160, 64)
    bias = _t5_bias(gen, cuda)
    assert flash_bwd_passes(160, 160, 64) == 1
    got = _launch_c(q, k, v, bias, g, 0.125, "mma")
    assert got[3] is None
    _check_c(got, flash_backward_reference(q, k, v, bias, g, 0.125,
                                           bias_needs_grad=False))


@pytest.mark.gpu
def test_flash_bwd_mma_body_learned_bias_with_ds(cuda):
    gen = torch.Generator(device=cuda).manual_seed(42)
    q, k, v, g = _c_inputs(gen, cuda, 8, 32, 160, 160, 64)
    bias = torch.randn((1, 32, 160, 160), generator=gen, device=cuda)
    got = _launch_c(q, k, v, bias, g, 0.125, "mma", need_ds=True)
    want = flash_backward_reference(q, k, v, bias, g, 0.125)
    _check_c(got, want)
    _check_dbias(got[3], want[3], q, k, v, bias, g, 0.125,
                 TOL[torch.bfloat16])


# (Sq, Skv): the main shape, Sq != Skv on the two-pass path, one query, a
# query count one past a 16-row tile, and one pass with more query rows than
# the block's ten warps take at once (two and three row groups a warp; 368 x
# 64 is the largest Sq that fits one block at D = 64)
C_SEQS = [(160, 160), (32, 600), (1, 160), (65, 160), (192, 160), (300, 64),
          (368, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("seqs", C_SEQS)
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_flash_bwd_mma_body_matches_plain(cuda, d, seqs):
    """Every padded head dim on both launch paths (one pass where
    ``flash_bwd_passes`` says 1, else two), with a (B, H, Sq, Skv) bias,
    which the one-pass block stages in shared memory, and its ds."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    sq, skv = seqs
    q, k, v, g = _c_inputs(gen, cuda, 2, 3, sq, skv, d)
    bias = torch.randn((2, 3, sq, skv), generator=gen, device=cuda)
    got = _launch_c(q, k, v, bias, g, d ** -0.5, "mma", need_ds=True)
    want = flash_backward_reference(q, k, v, bias, g, d ** -0.5)
    _check_c(got, want)
    _check_dbias(got[3], want[3], q, k, v, bias, g, d ** -0.5,
                 TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [40, 300])
def test_flash_bwd_mma_body_masked_row(cuda, seq):
    """A row whose keys all carry NEG_INF averages them uniformly, on the
    one-pass (40) and the two-pass (300) launches."""
    gen = torch.Generator(device=cuda).manual_seed(44)
    q, k, v, g = _c_inputs(gen, cuda, 1, 2, seq, seq, 64)
    bias = torch.zeros((1, 1, seq, seq), device=cuda)
    bias[..., 7, :] = NEG_INF
    got = _launch_c(q, k, v, bias, g, 0.125, "mma")
    _check_c(got, flash_backward_reference(q, k, v, bias, g, 0.125,
                                           bias_needs_grad=False))


@pytest.mark.gpu
def test_flash_attention_bf16_long_sequence_through_autograd(cuda):
    """S = 1200 bf16 through the autograd.Function: kernel A forward, then
    kernel C's two-pass tensor-core launch, against autograd of the plain
    attention."""
    gen = torch.Generator(device=cuda).manual_seed(45)
    leaves = [_strided(1, 8, 1200, 64, torch.bfloat16, gen,
                       cuda).requires_grad_() for _ in range(3)]
    lens = torch.tensor([1000], device=cuda)
    bias = make_padding_bias(
        (torch.arange(1200, device=cuda)[None] < lens[:, None]).float())
    g = _strided(1, 8, 1200, 64, torch.bfloat16, gen, cuda)
    assert flash_bwd_passes(1200, 1200, 64) == 2
    kernels.reset_launches()
    got = torch.autograd.grad(flash_attention(*leaves, bias), leaves, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd"] == 1
    assert kernels.MMA_LAUNCHES["flash_bwd"] == 1
    want = torch.autograd.grad(dot_product_attention(*leaves, bias), leaves,
                               g)
    _check_c(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("need_ds", [False, True])
def test_flash_bwd_mma_body_is_deterministic(cuda, need_ds):
    """Two launches on the same inputs give the same bits (no atomics), at
    the main shape with the T5 bias and with a learned bias's ds."""
    gen = torch.Generator(device=cuda).manual_seed(46)
    q, k, v, g = _c_inputs(gen, cuda, 8, 32, 160, 160, 64)
    bias = (torch.randn((1, 32, 160, 160), generator=gen, device=cuda)
            if need_ds else _t5_bias(gen, cuda))
    first = _launch_c(q, k, v, bias, g, 0.125, "mma", need_ds=need_ds)
    second = _launch_c(q, k, v, bias, g, 0.125, "mma", need_ds=need_ds)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
def test_flash_bwd_unaligned_bf16_takes_the_fma_body(cuda):
    gen = torch.Generator(device=cuda).manual_seed(47)
    b, h, s, d = 2, 4, 160, 64
    flat = torch.randn((4, 4 + b * s * h * d), generator=gen,
                       device=cuda).to(torch.bfloat16)
    # 4 elements (8 bytes) into the allocation: rows not 16-byte aligned
    q, k, v, g = (t[4:].view(b, s, h, d).transpose(1, 2) for t in flat)
    bias = _t5_bias(gen, cuda, b, h, s)
    got = _launch_c(q, k, v, bias, g, 0.125, "fma")
    _check_c(got, flash_backward_reference(q, k, v, bias, g, 0.125,
                                           bias_needs_grad=False))


@pytest.mark.gpu
def test_flash_bwd_c_entry_refuses_what_its_bodies_do_not_take(cuda):
    """cudaErrorInvalidValue (1) for the tensor-core body on f32 or on a
    bf16 row 8 bytes off, and for any launch without the stats scratch."""
    lib = kernels.library("flash_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    b, h, d = 1, 2, 64

    def call(dtype, shift, s, body, with_stats):
        buf = torch.zeros(shift + b * s * h * d, dtype=dtype, device=cuda)
        x = buf[shift:].view(b, s, h, d).transpose(1, 2)
        outs = [torch.empty((b, s, h, d), dtype=dtype,
                            device=cuda).transpose(1, 2) for _ in range(3)]
        stats = torch.empty(3 * b * h * s, device=cuda)
        strides = [t.stride(i) for t in (x, x, x, x, *outs) for i in range(3)]
        rc = lib.flash_bwd(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), None, x.data_ptr(),
            *(o.data_ptr() for o in outs), None,
            stats.data_ptr() if with_stats else None, b, h, s, s, d,
            *strides, 0, 0, 0, 0, 0.125, 0 if dtype == torch.float32 else 1,
            body, stream)
        torch.cuda.synchronize()
        return rc

    assert call(torch.float32, 0, 16, 1, True) == 1
    assert call(torch.bfloat16, 4, 16, 1, True) == 1
    assert call(torch.bfloat16, 0, 16, 0, False) == 1
    assert call(torch.bfloat16, 0, 200, 1, False) == 1
    assert call(torch.bfloat16, 0, 160, 1, False) == 1
    assert call(torch.bfloat16, 0, 160, 1, True) == 0
    assert call(torch.bfloat16, 0, 200, 1, True) == 0
    assert call(torch.bfloat16, 4, 16, 0, True) == 0


@pytest.mark.gpu
def test_tiny_e2e_train_steps_on_the_card_match_the_cpu(cuda):
    """Three E2E (uniform selection) train steps of the tiny f32 model on
    the card and on the CPU from the same weights: the same losses and
    gradient norms (1e-4 relative: summation order), kernel C launched by
    every T5 encoder layer (a 128-token question makes the encoder's
    sequence 144, past the flash rule's 128), frozen parameters
    unchanged."""
    cfg = _tiny_f32()
    cpu = V.VideoTGB(cfg, device="cpu", seed=5)
    gpu = V.VideoTGB(cfg, device=cuda, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(5)
    img = cfg.blip2.vit.image_size
    batch = {"frames": torch.randn((2, cfg.num_frames, img, img, 3),
                                   generator=g),
             "question_ids": torch.randint(4, 300, (2, 128), generator=g),
             "question_mask": torch.ones((2, 128)),
             "answer_ids": torch.randint(2, 300, (2, 8), generator=g)}
    batch["question_mask"][1, 100:] = 0
    recipe = E2ERecipe(selection="uniform")
    runs = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not recipe.filter_fn(n)}
        trainer = Trainer(TrainerConfig(max_steps=6, lr=1e-3),
                          recipe.loss_fn, recipe.filter_fn)
        state = trainer.init_state(model)
        kernels.reset_launches()
        metrics = []
        for _ in range(3):
            state, m = trainer.train_step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = metrics
        if name == "gpu":
            torch.cuda.synchronize()
            layers = cfg.blip2.t5.num_encoder_layers
            assert kernels.LAUNCHES["flash_bwd"] == 3 * layers
            # f32 parameters and compute: the CUDA-core body
            assert kernels.MMA_LAUNCHES["flash_bwd"] == 0
        assert all(torch.equal(p, frozen[n])
                   for n, p in model.named_parameters() if n in frozen)
    np.testing.assert_allclose(runs["gpu"], runs["cpu"], rtol=1e-4)


# ------------------------------------------------------ kernels D, E, F and G
SELECT_CASES = {
    # (B, L, F, nframe, inclusive_end, rescale): the TG recipe's shape, then
    # F = 128 at both rules and both ends, then the long-video F = 1024 and
    # the kernel's wider mask (32 words a lane) past it up to MAX_FRAMES
    "tg": (32, 66, 32, 4, False, "minus1"),
    "f128_minus1": (1024, 256, 128, 8, False, "minus1"),
    "f128_ratio": (1024, 256, 128, 8, False, "ratio"),
    "f128_minus1_inclusive": (1024, 256, 128, 8, True, "minus1"),
    "f128_ratio_inclusive": (1024, 256, 128, 8, True, "ratio"),
    "f1024_minus1": (1024, 256, 1024, 8, False, "minus1"),
    "f1024_ratio_inclusive": (1024, 256, 1024, 8, True, "ratio"),
    "f4096_nframe64": (64, 300, 4096, 64, True, "minus1"),
    "f32768_nframe1024": (16, 300, MAX_FRAMES, 1024, False, "ratio"),
}


def _select_args(gen, dev, b, l):
    """Random logits in the TGB head's (B, L, 2) layout, handed over as its
    strided [..., 0] and [..., 1] views, with edge rows planted."""
    sl, el = torch.randn((b, l, 2), generator=gen, device=dev).unbind(-1)
    vl = torch.randint(1, l + 1, (b,), generator=gen, device=dev)
    vl[:4] = torch.tensor([1, 2, 1, 2], device=dev)  # the shortest lengths
    sl[4], el[4] = -10.0, -10.0
    sl[4, 0], el[4, 0] = 10.0, 10.0  # degenerate (0, 0) peaks
    sl[5, 3] = float("nan")  # argmax puts NaN above every number
    sl[6], el[6] = 0.0, 0.0  # all tied: the first index
    return sl, el, vl


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_kernel_matches_plain_without_noise(cuda, case):
    b, l, f, nf, inclusive, rescale = SELECT_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(31)
    sl, el, vl = _select_args(gen, cuda, b, l)
    kw = dict(num_frames=f, nframe=nf, inclusive_end=inclusive,
              rescale=rescale, noise_scale=0.0)
    before = kernels.LAUNCHES["select_frames"]
    got = select_frames_pallas(sl, el, vl, 0, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["select_frames"] == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, nf)
    assert torch.equal(got, select_frames_pallas_reference(sl, el, vl, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_kernel_matches_plain_with_handed_noise(cuda, case):
    """The same noise in both: the same bits, as int64 (the route of
    ``VideoTGB.select_frames``, the seed read from the device) and int32
    (a seed by value)."""
    b, l, f, nf, inclusive, rescale = SELECT_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(36)
    sl, el, vl = _select_args(gen, cuda, b, l)
    noise = torch.randn((2, 2, b, l), generator=gen, device=cuda)
    kw = dict(num_frames=f, nframe=nf, top_k=2, inclusive_end=inclusive,
              rescale=rescale)
    want = select_frames_pallas_reference(sl, el, vl, noise_scale=0.5,
                                          noise=noise, **kw)
    seed = draw_seed(gen, cuda)
    got = select_frames_cuda(sl, el, vl, seed, noise_scale=0.5, noise=noise,
                             out_dtype=torch.int64, **kw)
    assert got.dtype == torch.int64 and torch.equal(got, want.long())
    assert torch.equal(select_frames_cuda(sl, el, vl, 1, noise_scale=0.5,
                                          noise=noise, **kw), want)


@pytest.mark.gpu
def test_select_kernel_noise_follows_the_seed_and_the_gumbel_law(cuda):
    b, l, f, nf = 16384, 66, 32, 4
    zeros = torch.zeros((b, l), device=cuda)
    vl = torch.full((b,), 64, device=cuda)
    a, a2, c = (select_frames_pallas(zeros, zeros, vl, s, num_frames=f,
                                     nframe=nf) for s in (7, 7, 8))
    assert torch.equal(a, a2) and not torch.equal(a, c)
    gen = torch.Generator(device=cuda).manual_seed(9)
    plain = select_frames_pallas_reference(zeros, zeros, vl, f, nf,
                                           generator=gen)
    hist = [torch.bincount(x.flatten().long(), minlength=f).float() / x.numel()
            for x in (a, plain)]
    # each frequency is ~1/32 over 65,536 draws: sd ~7e-4 per frequency
    assert float((hist[0] - hist[1]).abs().max()) <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("qb", [128, 64])
def test_blocked_lookup_kernel_matches_plain(cuda, dtype, skip, qb):
    gen = torch.Generator(device=cuda).manual_seed(32)
    f1, f2 = (torch.randn((3, 12, 12, 32), generator=gen,
                          device=cuda).to(dtype) for _ in range(2))
    pyr = build_corr_pyramid_t(f1, f2, 4)
    coords = torch.rand((3, 12, 12, 2), generator=gen, device=cuda) * 24 - 6
    before = kernels.LAUNCHES["corr_lookup_blocked"]
    got = blocked_lookup(pyr, coords, qb=qb, skip=skip)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_lookup_blocked"] == before + 1
    assert got.dtype == dtype
    _close(got, lookup_corr_pyramid_t_plain(pyr, coords, 4), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("qb", [32, 64, 96, 128])
def test_blocked_lookup_runs_the_tile_body_at_every_qb(cuda, dtype, skip,
                                                       qb):
    # the probe's 28 x 28 maps: 7 blocks a pair at qb 128, ragged at 96
    gen = torch.Generator(device=cuda).manual_seed(48)
    pyr, xy = _lookup_inputs(gen, cuda, 4, 28, 28, dtype, c=64)
    kernels.reset_launches()
    got = blocked_lookup(pyr, xy, qb=qb, skip=skip)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["corr_lookup_blocked"] == 1
    assert kernels.TILE_LAUNCHES["corr_lookup_blocked"] == 1
    _close(got, lookup_corr_pyramid_t_plain(pyr, xy, 4), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_ln_and_ln_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(33)
    res, delta = (torch.randn((3, 10, 1408), generator=gen,
                              device=cuda).to(dtype) for _ in range(2))
    g = 1.0 + 0.1 * torch.randn((1408,), generator=gen, device=cuda)
    b = 0.1 * torch.randn((1408,), generator=gen, device=cuda)
    before = dict(kernels.LAUNCHES)
    summed, normed = add_ln(res, delta, g, b)
    alone = ln(res, g, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["add_ln"] == before["add_ln"] + 1
    assert kernels.LAUNCHES["ln"] == before["ln"] + 1
    want_sum, want_norm = add_ln_reference(res, delta, g, b)
    assert summed.dtype == dtype and torch.equal(summed, want_sum)
    _close(normed, want_norm, TOL[dtype])
    _close(alone, ln_reference(res, g, b), TOL[dtype])


def _check_bshd(gen, dev, dtype, b, s, h, d):
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)  # strided (B, S, H, D) views
    kernels.reset_launches()
    got = flash_bshd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bshd"] == 1
    assert kernels.LAUNCHES["flash_fwd"] == 0
    assert kernels.MMA_LAUNCHES["flash_bshd"] == int(dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, flash_bshd_reference(q, k, v, d ** -0.5), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [88, 64, 128])
def test_flash_bshd_kernel_matches_plain(cuda, dtype, d):
    gen = torch.Generator(device=cuda).manual_seed(34)
    _check_bshd(gen, cuda, dtype, 2, 70, 12, d)  # a ragged sequence


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 15, 70, 264, 300])
@pytest.mark.parametrize("d", MMA_DIMS)
def test_flash_bshd_kernel_mma_body_matches_plain(cuda, d, s):
    gen = torch.Generator(device=cuda).manual_seed(35)
    _check_bshd(gen, cuda, torch.bfloat16, 2, s, 5, d)


@pytest.mark.gpu
def test_selection_and_probe_wrappers_raise_on_bad_inputs(cuda):
    sl = torch.zeros((2, 8), device=cuda)
    vl = torch.full((2,), 8, device=cuda)
    with pytest.raises(ValueError, match=str(MAX_FRAMES)):
        select_frames_pallas(sl, sl, vl, 0, num_frames=MAX_FRAMES + 1)
    pyr = build_corr_pyramid_t(*(torch.randn((1, 4, 4, 8), device=cuda)
                                 for _ in range(2)), 2)
    with pytest.raises(ValueError, match="qb"):
        blocked_lookup(pyr, torch.zeros((1, 4, 4, 2), device=cuda), qb=100)
    pyr5 = build_corr_pyramid_t(*(torch.randn((1, 5, 5, 8), device=cuda)
                                  for _ in range(2)), 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        blocked_lookup(pyr5, torch.zeros((1, 5, 5, 2), device=cuda))
    q = torch.randn((1, 8, 2, 160), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_bshd(q, q, q, 1.0)


# ------------------------------------------------------------------ kernel H
# M, K, N: ragged M and N; K = 64 (half a 128-byte stage); K off a multiple
# of 128; K = 8192; K = 2320 = 128 * 6 stages * 3 + 16, past three turns of
# the deepest ring; the W8A8 ViT-g's q/k/v/o product
INT8_SHAPES = [(48, 64, 40), (1001, 1424, 999), (300, 2064, 257),
               (136, 8192, 72), (257, 2320, 520), (4224, 1408, 1408)]
# every tiling by index, and None: gemm_tile's pick
TILE_CHOICES = [*range(len(TILES)), None]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.bfloat16])
@pytest.mark.parametrize("tile", TILE_CHOICES)
def test_int8_mm_kernel_equals_plain(cuda, tile, out_dtype):
    """Bit for bit at ragged M and N, K past whole stages and past several
    turns of the ring, each block tiling, both epilogues."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    for m, k, n in INT8_SHAPES:
        x = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                          dtype=torch.int8)
        w_t = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                            dtype=torch.int8)
        before = kernels.LAUNCHES["int8_mm"]
        got = int8_mm(x, w_t, out_dtype, tile=tile)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["int8_mm"] == before + 1
        assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
        assert torch.equal(got, int8_mm_reference(x, w_t, out_dtype)), (
            m, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILE_CHOICES)
def test_int8_mm_kernel_saturated_and_double_rounded(cuda, tile):
    gen = torch.Generator(device=cuda).manual_seed(42)
    m, k, n = 136, 8192, 72
    sign = torch.randint(0, 2, (m + n, k), generator=gen, device=cuda) * 2 - 1
    x, w_t = (sign * 127).to(torch.int8).split([m, n])
    for out_dtype in (torch.int32, torch.bfloat16):
        assert torch.equal(int8_mm(x, w_t, out_dtype, tile=tile),
                           int8_mm_reference(x, w_t, out_dtype))
    full = torch.full((16, k), 127, dtype=torch.int8, device=cuda)
    assert int(int8_mm(full, full, tile=tile).max()) == 127 * 127 * k
    # 2088 * 127^2 + 127 * 64 + 5 * 5 = 2^25 + 2^17 + 1: bf16 via f32 is 2^25
    x = torch.zeros((1, 2096), dtype=torch.int8, device=cuda)
    w_t = torch.zeros_like(x)
    x[0, :2090] = 127
    w_t[0, :2088] = 127
    w_t[0, 2088] = 64
    x[0, 2089] = w_t[0, 2089] = 5
    assert int8_mm(x, w_t, tile=tile).item() == 2 ** 25 + 2 ** 17 + 1
    assert int8_mm(x, w_t, torch.bfloat16, tile=tile).item() == 2 ** 25


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILE_CHOICES)
def test_bf16_mm_kernel_within_one_ulp(cuda, tile):
    """One bf16 ulp for a rounding flipped by the f32 summation order, plus
    that order's own difference (<= K * 2^-24 * max|x| * max|w|)."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    for m, k, n in INT8_SHAPES:
        x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
        w_t = torch.randn((n, k), generator=gen, device=cuda).to(
            torch.bfloat16)
        before = kernels.LAUNCHES["bf16_mm"]
        got = bf16_mm(x, w_t, tile=tile)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bf16_mm"] == before + 1
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
        want = bf16_mm_reference(x, w_t).float()
        order = k * 2.0 ** -24 * float(x.float().abs().max()
                                       * w_t.float().abs().max())
        err = (got.float() - want).abs()
        assert bool((err <= bf16_ulp(want) + order).all()), (
            m, k, n, float(err.max()))


@pytest.mark.gpu
def test_int8_vit_on_the_kernel_equals_its_plain_route(cuda):
    """The int32 product is exact, so kernel H and its plain version give a
    bit-identical tower; 6 launches per layer."""
    cfg = dataclasses.replace(ViTConfig.tiny(), quant="int8")
    vit = init_params(ViTModel(cfg, device=cuda), seed=7)
    pix = torch.randn((2, 56, 56, 3), generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda)
    kernels.reset_launches()
    with torch.no_grad():
        got = vit(pix)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["int8_mm"] == 6 * cfg.num_layers
        for m in vit.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = False
        want = vit(pix)
    assert kernels.LAUNCHES["int8_mm"] == 6 * cfg.num_layers
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_h_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros((32, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_mm(x, x)
    x = torch.zeros((32, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        int8_mm(x, x, tile=len(TILES))
    with pytest.raises(ValueError, match="out_dtype"):
        int8_mm(x, x, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        bf16_mm(x, x)


@pytest.mark.gpu
def test_tiny_engine_on_the_card_equals_direct_calls(cuda, monkeypatch):
    """The tiny engine on the card, its workers on two threads and two
    streams: every batch equals single-threaded direct ``select_phase_blip2``
    + gather + ``answer_phase_blip2`` calls on the same padded batch with
    its step's generator, and the engine's launches are exactly its batches
    times a direct batch's."""
    from videotgb_torch import serve
    from videotgb_torch.device import step_generator

    eng = serve.ServingEngine("random:tiny", preset="tiny", batch_size=2,
                              flow_frames=3, max_new_tokens=4,
                              max_delay_ms=50.0)
    steps, padded_of = [], []
    host_batch = eng.host_batch
    monkeypatch.setattr(eng, "host_batch", lambda padded: (
        padded_of.append(list(padded)) or host_batch(padded)))
    monkeypatch.setattr(serve, "step_generator", lambda s, k, d: (
        steps.append(k) or step_generator(s, k, d)))
    rng = np.random.default_rng(0)
    img, fs = eng.cfg.blip2.vit.image_size, eng.cfg.tgb.flow_size
    frames_of = {}
    kernels.reset_launches()
    try:
        futs = []
        for i in range(7):
            frames = rng.integers(0, 255, (eng.cfg.num_frames, img, img, 3),
                                  np.uint8)
            flow = rng.integers(0, 255, (4, fs, fs, 3), np.uint8)
            fut = eng.submit(frames, flow, f"question {i}?")
            frames_of[fut] = frames
            futs.append(fut)
            if i < 2:
                fut.result(timeout=300)
        replies = {f: f.result(timeout=300) for f in futs}
    finally:
        eng.close()
    assert not eng._worker.is_alive() and not eng._answer_worker.is_alive()
    engine_launches = dict(kernels.LAUNCHES)
    batches = eng.stats()["batches"]
    assert batches == len(steps) == len(padded_of)

    kernels.reset_launches()
    for step, padded in zip(steps, padded_of):
        gen = step_generator(eng.seed, step, eng.device)
        flow_u8, bd = eng.host_batch(padded)
        cand = V.select_phase_blip2(eng.model, flow_u8, bd, generator=gen)
        idx = cand.cpu().numpy()
        sel = torch.from_numpy(np.stack([frames_of[r.future][idx[i]]
                                         for i, r in enumerate(padded)]))
        tokens = V.answer_phase_blip2(eng.model, sel.to(cuda), bd,
                                      eng.decode_config, generator=gen)
        answers = eng.tok.batch_decode(tokens.cpu().numpy())
        for i, r in enumerate(padded):
            if i and r is padded[i - 1]:
                continue  # a pad row
            assert replies[r.future].selected_frames == idx[i].tolist()
            assert replies[r.future].answer == answers[i]
    direct = dict(kernels.LAUNCHES)
    assert direct["select_frames"] == batches  # kernel D in every batch
    assert engine_launches == direct


@pytest.mark.gpu
def test_tiny_e2e_cli_on_the_card_with_tgb_selection(cuda, tmp_path,
                                                     monkeypatch):
    """``train.main`` then ``evaluate.main`` on the card for the tiny E2E
    recipe with the "tgb" selection: one launch of kernel D per step and
    two per eval batch (the eval loss's selection and ``generate_blip2``'s);
    every tiny attention (ViT-g 17 tokens, the T5 encoder's 2 x 4 visual +
    16 question tokens) is under the 128^2 rule, so 0 A and 0 C. Then the
    library round trip: the fitted state saved, one step, a fresh model
    from another seed restored, the same step on the same batch bit for bit
    (loss, gradient norm, trainable parameters, Adam moments)."""
    from videotgb_torch import evaluate as EV
    from videotgb_torch import train as T
    from videotgb_torch.config import compose
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.training import checkpoint as CK

    steps, fits = [], []
    real_step, real_fit = Trainer.train_step, Trainer.fit

    def counted_step(self, state, batch):
        before = dict(kernels.LAUNCHES)
        out = real_step(self, state, batch)
        torch.cuda.synchronize()
        steps.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        return out

    def kept_fit(self, state, *args, **kwargs):
        state = real_fit(self, state, *args, **kwargs)
        fits.append((self, state))
        return state

    monkeypatch.setattr(Trainer, "train_step", counted_step)
    monkeypatch.setattr(Trainer, "fit", kept_fit)
    out = str(tmp_path / "out")
    args = ["experiment=smoke_e2e_synthetic", "model.selection=tgb",
            f"paths.output_dir={out}", "extras.print_config=false"]
    kernels.reset_launches()
    final = T.main(args)
    got = dict(kernels.LAUNCHES)
    zero = dict.fromkeys(got, 0)
    assert steps == [{**zero, "select_frames": 1}] * 2
    # 2 steps + 2 evals (at step 2 and the final one) of one batch each
    assert got == {**zero, "select_frames": 2 + 2 * 2}
    assert np.isfinite(final["val/loss"]) and "val/score" in final

    trainer, state = fits[-1]
    cfg = compose(T.CONFIG_DIR, "train", args)
    recipe = T.build_recipe(cfg.model)
    _, val_loader, _ = T.build_data(cfg, T.build_model(cfg.model, "cpu")[1])
    batch = device_batch(next(iter(val_loader)), cuda)
    mgr = CK.CheckpointManager(CK.CheckpointConfig(str(tmp_path / "lib")))
    mgr.save(state.step, CK.train_state_items(state))
    _, m_a = trainer.train_step(state, batch)
    names = trainer.trainable
    params = dict(state.model.named_parameters())
    want = {n: params[n].detach().clone() for n in names}
    moments = {(n, k): state.optimizer.state[params[n]][k].clone()
               for n in names for k in ("exp_avg", "exp_avg_sq", "step")}
    model, _ = T.build_model(cfg.model, device=cuda, seed=cfg.seed + 1)
    tb = Trainer(trainer.config, recipe.loss_fn, recipe.filter_fn)
    sb = tb.init_state(model)
    sb.step = CK.restore_into(mgr.restore(), model, sb.optimizer)
    assert sb.step == state.step == 2
    _, m_b = tb.train_step(sb, batch)
    assert torch.equal(m_a["loss"], m_b["loss"])
    assert torch.equal(m_a["grad_norm"], m_b["grad_norm"])
    params = dict(model.named_parameters())
    for n in names:
        assert torch.equal(params[n], want[n]), n
    for (n, k), v in moments.items():
        assert torch.equal(sb.optimizer.state[params[n]][k], v), (n, k)

    metrics = EV.main(args + [f"ckpt_path={out}/checkpoints"])
    assert {"test/loss", "test/score"} <= set(metrics)


def _random_lora_b(model, gen):
    """Nonzero B factors (built, they are 0 and A takes no gradient)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_with_lora_on_the_card_matches_the_cpu(cuda, dtype):
    """Self-attention with q and v adapters at 160 tokens (over the 128^2
    rule: kernels A and C once each on the card): the output and the
    adapters' gradients on the card against the CPU's plain route."""
    from videotgb_torch.models.common import MultiHeadAttention

    mods = [MultiHeadAttention(64, 4, 16, lora_rank=8, dtype=dtype, device=d)
            for d in ("cpu", cuda)]
    gen = torch.Generator().manual_seed(3)
    init_params(mods[0], 3)
    _random_lora_b(mods[0], gen)
    mods[1].load_state_dict(mods[0].state_dict())
    x = torch.randn((2, 160, 64), generator=gen)
    g = torch.randn((2, 160, 64), generator=gen)
    outs = []
    for m in mods:
        dev = next(m.parameters()).device
        for n, p in m.named_parameters():
            p.requires_grad_("_lora." in n)
        kernels.reset_launches()
        out, _ = m(x.to(dev))
        out.backward(g.to(dev, out.dtype))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["flash_fwd"] == 1
            assert kernels.LAUNCHES["flash_bwd"] == 1
        outs.append((out.detach().cpu(), {n: p.grad.cpu() for n, p in
                                           m.named_parameters()
                                           if p.grad is not None}))
    (got, got_grads), (want, want_grads) = outs[1], outs[0]
    assert sorted(got_grads) == sorted(want_grads) and len(want_grads) == 4
    tol = TOL[dtype] if dtype == torch.bfloat16 else 1e-4
    _close_to_largest(got, want, tol, "out")
    for n, w in want_grads.items():
        _close_to_largest(got_grads[n], w, tol, n)


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,lora,recipe", [
    ("blip2", 8, IVTRecipe()), ("instructblip_t5", 0, IVRecipe()),
    ("instructblip", 8, IVTRecipe())])
def test_tiny_stage3_step_on_the_card_matches_the_cpu(cuda, backbone, lora,
                                                      recipe):
    """The IV / IVT loss and the trainable gradients (the Q-Former, its
    projection and query tokens, the adapters) of a batch with a text-only
    row, on the card and on the CPU from the same weights; no kernel at the
    tiny shapes."""
    cfg = _tiny_f32(backbone)
    if lora:
        cfg = V.with_lora(cfg, lora)
    gen = torch.Generator().manual_seed(11)
    cpu = V.VideoTGB(cfg, device="cpu", seed=11)
    _random_lora_b(cpu, gen)
    gpu = V.VideoTGB(cfg, device=cuda, seed=11)
    gpu.load_state_dict(cpu.state_dict())
    batch = _train_batch(cfg, 2, 6, gen)
    batch["frames"] = batch["frames"][:, :cfg.nframe].clone()
    batch["frames"][1] = 0.0
    batch["widths"] = torch.tensor([cfg.nframe, 0])
    out = []
    for model in (gpu, cpu):
        for n, p in model.named_parameters():
            p.requires_grad_(recipe.filter_fn(n))
        dev = model.device
        kernels.reset_launches()
        loss, _ = recipe.loss_fn(model, {k: v.to(dev)
                                         for k, v in batch.items()})
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        out.append((loss.detach().cpu(), grads, dict(kernels.LAUNCHES)))
    (loss, grads, launches), (want, want_grads, _) = out
    assert launches == dict.fromkeys(launches, 0)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    assert grads.keys() == want_grads.keys()
    assert any("_lora." in n for n in grads) == bool(lora)
    top = max(float(g.abs().max()) for g in want_grads.values())
    for n, g in grads.items():
        w = want_grads[n]
        if float(w.abs().max()) < 1e-6 * top:
            assert float((g - w).abs().max()) <= 1e-6 * top, n
        else:
            _close_to_largest(g, w, 1e-3, n)


@pytest.mark.gpu
def test_beams_on_the_card_equal_the_cpu(cuda):
    """``beam_search`` on the card gives the CPU's tokens for a synthetic
    step function (f64 dynamics carried in the caches, as in
    ``tests/test_torch_beam.py``; a repetition penalty)."""
    from videotgb_torch.ops.decode import beam_search

    rng = np.random.default_rng(0)
    v, d, k = 16, 6, 3
    arrays = (rng.standard_normal((v, d)),
              0.9 * np.linalg.qr(rng.standard_normal((d, d)))[0],
              rng.standard_normal((d, v)) / np.sqrt(d), np.eye(v)[1])

    def run(dev):
        emb, mix, out, eos = (torch.as_tensor(a, dtype=torch.float64,
                                              device=dev) for a in arrays)

        def step(tokens, caches, t):
            h = caches["h"] @ mix + emb[tokens[:, 0]]
            return (2.0 * (h @ out) + eos * (t - 2.0)).float(), {"h": h}

        cfg = DecodeConfig(max_new_tokens=8, eos_token_id=1, pad_token_id=0,
                           num_beams=k, length_penalty=0.5,
                           repetition_penalty=1.2)
        caches = {"h": torch.zeros((2 * k, d), dtype=torch.float64,
                                   device=dev)}
        return beam_search(step, caches, torch.tensor([3, 7], device=dev),
                           cfg)

    got = run(cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), run("cpu"))


@pytest.mark.gpu
def test_tiny_chat_on_the_card_answers(cuda, tmp_path):
    """The demo's ``Chat`` without a device builds on the card and answers
    greedy, with beams and with an nframe override: RAFT's lookups on
    kernel B and the selection on kernel D in every answer."""
    import cv2

    from videotgb_torch.demo.app import Chat

    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (64, 64))
    rng = np.random.default_rng(0)
    for _ in range(16):
        writer.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
    writer.release()
    chat = Chat("random:tiny", flow_frames=3, max_new_tokens=4)
    assert chat.device.type == "cuda"
    for kw in (dict(do_sample=False), dict(num_beams=2), dict(nframe=2)):
        kernels.reset_launches()
        answer, cand, thumbs, flows = chat.generate(path, "what?", **kw)
        assert isinstance(answer, str)
        assert len(cand) == len(thumbs) == kw.get("nframe", chat.cfg.nframe)
        assert len(flows) == 3 and flows[0].dtype == np.uint8
        assert kernels.LAUNCHES["corr_lookup"] == chat.cfg.raft.iters
        assert kernels.LAUNCHES["select_frames"] == 1


@pytest.mark.gpu
def test_converted_checkpoint_restores_on_the_card(cuda, tmp_path):
    """``convert_checkpoint`` from a raft-sintel.pth (DataParallel names)
    and a sampler.pth written with ``torch.save``; ``load_model`` without a
    device restores them on the card, and the select phase runs."""
    from types import SimpleNamespace

    from videotgb_torch.evalsuite.inference import load_model
    import _torch_reference_names as RN
    from videotgb_torch.tools import convert_checkpoint as CC

    src = V.VideoTGB(V.VideoTGBConfig.tiny(), device="cpu",
                     seed=5).state_dict()
    raft = {f"module.{k}": t for k, t in RN.raft_to_reference(src).items()}
    torch.save(raft, tmp_path / "raft-sintel.pth")
    torch.save(RN.tgb_to_reference(src), tmp_path / "sampler.pth")
    out = CC.main(["--preset", "tiny", "--output", str(tmp_path / "ckpt"),
                   "--raft_path", str(tmp_path / "raft-sintel.pth"),
                   "--sampler_path", str(tmp_path / "sampler.pth")])
    model, cfg = load_model(SimpleNamespace(model_path=out, preset="tiny",
                                            bf16_params=0))
    assert model.device.type == "cuda"
    got = model.state_dict()
    moved = [k for k in src
             if k.startswith(("of_extractor.", "temporal_encoder."))]
    assert moved and all(torch.equal(got[k].cpu(), src[k]) for k in moved)
    fs = cfg.tgb.flow_size
    flow = torch.randint(0, 256, (1, 4, fs, fs, 3), dtype=torch.uint8,
                         device=cuda)
    batch = {"flow_mask": torch.ones((1, 5), device=cuda),
             "video_length": torch.full((1,), 3, device=cuda),
             "sampler_question_ids": torch.randint(4, 60, (1, 5),
                                                   device=cuda),
             "sampler_question_mask": torch.ones((1, 5), device=cuda)}
    cand = V.select_phase_blip2(model, flow, batch,
                                generator=torch.Generator(cuda))
    assert tuple(cand.shape) == (1, cfg.nframe)


# ----------------------------------------------- CUDA-graph programs (tiny)
def _tiny_requests(cuda, backbone, b=2, seed=3):
    """A tiny model on the card and b requests: frames and flow frames
    uint8, the batch dict (with the Q-Former's text where it reads one)."""
    model = V.VideoTGB(V.VideoTGBConfig.tiny(backbone), device=cuda, seed=0)
    cfg = model.config
    gen = torch.Generator(device=cuda).manual_seed(seed)
    img, fs = cfg.vit.image_size, cfg.tgb.flow_size
    frames = torch.randint(0, 256, (b, cfg.num_frames, img, img, 3),
                           generator=gen, device=cuda, dtype=torch.uint8)
    flow = torch.randint(0, 256, (b, 4, fs, fs, 3), generator=gen,
                         device=cuda, dtype=torch.uint8)
    ids = torch.randint(4, 60, (b, 6), generator=gen, device=cuda)
    mask = torch.ones((b, 6), device=cuda)
    mask[0, 4:] = 0
    batch = {"flow_mask": torch.ones((b, 5), device=cuda),
             "video_length": torch.full((b,), 3, device=cuda),
             "sampler_question_ids": ids, "sampler_question_mask": mask,
             "question_ids": ids.flip(1), "question_mask": mask.flip(1),
             "qformer_input_ids": ids, "qformer_attention_mask": mask}
    return model, frames, flow, batch


def _three_calls_and_eager(wrapper, call):
    """Three graphed calls (eager, capture + replay, replay) and one of the
    eager function, each on fresh arguments from ``call()``; the launches
    of the third call and of the eager one."""
    outs = []
    for _ in range(3):
        args, kwargs = call()
        kernels.reset_launches()
        outs.append(wrapper(*args, **kwargs))
    replayed = dict(kernels.LAUNCHES)
    args, kwargs = call()
    kernels.reset_launches()
    ref = wrapper.eager(*args, **kwargs)
    return outs, ref, replayed, dict(kernels.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("backbone", ["blip2", "instructblip"])
@pytest.mark.parametrize("sample", [False, True])
def test_graphed_phases_equal_their_eager_functions(cuda, backbone, sample):
    """``select_phase_blip2`` and the backbone's answer phase as CUDA-graph
    programs: indices and tokens of every call equal the eager function's
    on the same generator seed, greedy and sampled, and a replay launches
    what the eager call launches."""
    model, frames, flow, batch = _tiny_requests(cuda, backbone)
    cfg = model.config
    lm = cfg.blip2.t5 if backbone == "blip2" else cfg.instructblip.llm
    dcfg = DecodeConfig(max_new_tokens=11, eos_token_id=lm.eos_token_id,
                        pad_token_id=lm.pad_token_id, do_sample=sample,
                        temperature=0.8)
    kw = ({} if backbone == "blip2" else
          {"mode": "multi_modal", "rescale": "ratio"})
    outs, cand, replayed, eager = _three_calls_and_eager(
        V.select_phase_blip2, lambda: ((model, flow, batch), dict(
            kw, generator=torch.Generator(device=cuda).manual_seed(5))))
    assert all(torch.equal(o, cand) for o in outs)
    assert replayed == eager and replayed["select_frames"] == 1
    sel = frames[torch.arange(2, device=cuda)[:, None], cand]
    answer = (V.answer_phase_blip2 if backbone == "blip2"
              else V.answer_phase_instructblip)
    outs, tokens, replayed, eager = _three_calls_and_eager(
        answer, lambda: ((model, sel, batch, dcfg), {
            "generator": torch.Generator(device=cuda).manual_seed(6)}))
    assert tokens.shape == (2, 11)
    assert all(torch.equal(o, tokens) for o in outs)
    assert replayed == eager
    (program,) = answer.programs()[-1:]
    assert sum(loop is not None for _, loop in program.steps) == 1


@pytest.mark.gpu
def test_graphed_generate_and_flow_equal_eager(cuda):
    """``generate_blip2`` (the QA CLI's call) and the CLI's graphed flow
    calls against their eager functions; a decode of one token has no
    chunk and one of 20 tokens several."""
    from videotgb_torch.evalsuite.inference import flow_of, flow_of_timeline

    model, frames, flow, batch = _tiny_requests(cuda, "blip2")
    outs, ref, _, _ = _three_calls_and_eager(
        flow_of, lambda: ((model, flow.float()), {}))
    assert all(torch.equal(o, ref) for o in outs)
    valid = torch.ones((2, 4), device=cuda)
    valid[1, 3:] = 0
    outs, ref_t, _, _ = _three_calls_and_eager(
        flow_of_timeline, lambda: ((model, flow.float(), valid), {}))
    assert all(torch.equal(o, ref_t) for o in outs)
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=cuda)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=cuda)
    full = dict(batch, frames=(frames.float() / 255.0 - mean) / std,
                flow=ref[:, :3])
    for n in (1, 20):
        dcfg = DecodeConfig(max_new_tokens=n, eos_token_id=1, pad_token_id=0)
        outs, ref_g, replayed, eager = _three_calls_and_eager(
            V.generate_blip2, lambda dcfg=dcfg: ((model, full, dcfg), {
                "generator": torch.Generator(device=cuda).manual_seed(4)}))
        for tokens, cand in outs:
            assert torch.equal(tokens, ref_g[0])
            assert torch.equal(cand, ref_g[1])
        assert replayed == eager


@pytest.mark.gpu
def test_a_second_signature_captures_a_second_program(cuda):
    model, _, flow, batch = _tiny_requests(cuda, "blip2")
    _, _, flow3, batch3 = _tiny_requests(cuda, "blip2", b=3, seed=4)
    before = len(V.select_phase_blip2.programs())
    for _ in range(2):
        V.select_phase_blip2(model, flow, batch,
                             generator=torch.Generator(device=cuda))
    assert len(V.select_phase_blip2.programs()) == before + 1
    for _ in range(3):
        V.select_phase_blip2(model, flow3, batch3,
                             generator=torch.Generator(device=cuda))
    assert len(V.select_phase_blip2.programs()) == before + 2
    del model
    import gc
    gc.collect()  # the model's programs go with it
    assert len(V.select_phase_blip2.programs()) == before


@pytest.mark.gpu
def test_a_capture_that_synchronises_raises(cuda):
    """A host read inside the function: the first (eager) call runs, every
    later call raises instead of running eagerly, and the process goes on
    drawing random numbers (the failed capture's generators are reset)."""
    from videotgb_torch.utils.graphs import graphed

    @graphed
    def reads_the_host(x):
        return x * float(x.sum())

    x = torch.ones(4, device=cuda)
    assert torch.equal(reads_the_host(x), x * 4)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            reads_the_host(x)
    assert torch.randn(3, device=cuda).shape == (3,)
    assert reads_the_host.programs() == []


@pytest.mark.gpu
def test_graphed_train_steps_equal_eager_and_a_window(cuda):
    """The tiny E2E step (uniform selection) three times: graphed calls,
    eager calls (``_step.eager``) and one ``train_step_multi`` window of K
    = 3 on three twins give the same losses, gradient norms and trainable
    parameters, bit for bit."""
    from videotgb_torch import train as T

    recipe = T.build_recipe({"recipe": "e2e", "tgb_mode": "multi_modal",
                             "selection": "uniform"})
    runs = []
    for route in ("graphed", "eager", "window"):
        model, cfg = T.build_model({"preset": "tiny"}, device=cuda, seed=0)
        trainer = Trainer(TrainerConfig(max_steps=6, lr=1e-3),
                          recipe.loss_fn, recipe.filter_fn)
        state = trainer.init_state(model)
        gen = torch.Generator(device=cuda).manual_seed(2)
        img = cfg.vit.image_size
        batches = [{"frames": torch.randn((2, cfg.num_frames, img, img, 3),
                                          generator=gen, device=cuda),
                    "question_ids": torch.randint(4, 60, (2, 6),
                                                  generator=gen, device=cuda),
                    "question_mask": torch.ones((2, 6), device=cuda),
                    "answer_ids": torch.randint(4, 60, (2, 5), generator=gen,
                                                device=cuda)}
                   for _ in range(3)]
        if route == "eager":
            trainer._step = trainer._step.eager
        if route == "window":
            state, stacked = trainer.train_step_multi(state, {
                k: torch.stack([bt[k] for bt in batches])
                for k in batches[0]})
            metrics = [{k: stacked[k][i] for k in ("loss", "grad_norm")}
                       for i in range(3)]
        else:
            metrics = []
            for bt in batches:
                state, m = trainer.train_step(state, bt)
                metrics.append(m)
        runs.append((metrics, {n: p.detach().clone() for n, p in
                               model.named_parameters()
                               if n in set(trainer.trainable)}))
    for metrics, params in runs[1:]:
        for a, b in zip(runs[0][0], metrics):
            assert torch.equal(a["loss"], b["loss"])
            assert torch.equal(a["grad_norm"], b["grad_norm"])
        for n, p in params.items():
            assert torch.equal(p, runs[0][1][n]), n


@pytest.mark.gpu
def test_graphed_decode_entry_points_equal_eager(cuda):
    """``t5_generate_from_encoder`` (greedy and sampled),
    ``llama_generate_from_embeds`` (with a stop sequence) and
    ``generate_instructblip`` called directly, as the SF pseudo pass and
    the QA CLI call them: every graphed call equals the eager function."""
    model, _, _, batch = _tiny_requests(cuda, "blip2")
    gen = torch.Generator(device=cuda).manual_seed(7)
    enc = torch.randn((2, 9, model.config.blip2.t5.d_model), generator=gen,
                      device=cuda)
    mask = torch.ones((2, 9), device=cuda)
    mask[1, 6:] = 0
    for sample in (False, True):
        dcfg = DecodeConfig(max_new_tokens=13, do_sample=sample)
        outs, ref, _, _ = _three_calls_and_eager(
            V.t5_generate_from_encoder, lambda dcfg=dcfg: (
                (model, enc, mask, dcfg),
                {"generator": torch.Generator(device=cuda).manual_seed(8)}))
        assert all(torch.equal(o, ref) for o in outs)

    vmodel, frames, _, vbatch = _tiny_requests(cuda, "instructblip")
    llm = vmodel.config.instructblip.llm
    d = llm.hidden_size
    embeds = torch.randn((2, 7, d), generator=gen, device=cuda)
    emask = torch.ones((2, 7), device=cuda)
    emask[0, 5:] = 0
    dcfg = DecodeConfig(max_new_tokens=10, eos_token_id=llm.eos_token_id,
                        pad_token_id=llm.pad_token_id)
    outs, ref, _, _ = _three_calls_and_eager(
        V.llama_generate_from_embeds, lambda: (
            (vmodel, embeds, emask, dcfg), {"stop_sequences": ((5, 6),)}))
    assert all(torch.equal(o, ref) for o in outs)
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=cuda)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=cuda)
    fs = vmodel.config.tgb.flow_size
    full = dict(vbatch, frames=(frames.float() / 255.0 - mean) / std,
                flow=torch.randn((2, 3, fs, fs, 2), generator=gen,
                                 device=cuda))
    outs, ref, replayed, eager = _three_calls_and_eager(
        V.generate_instructblip, lambda: ((vmodel, full, dcfg), {
            "generator": torch.Generator(device=cuda).manual_seed(9)}))
    for tokens, cand in outs:
        assert torch.equal(tokens, ref[0]) and torch.equal(cand, ref[1])
    assert replayed == eager


# -------------------------------------------------- data-parallel training
class _RankOf:
    """The coordinate interface of a (dp, fsdp) DeviceMesh: rank ``r`` of
    ``n`` on the dp dim."""

    def __init__(self, r, n):
        self.r, self.n = r, n

    def get_coordinate(self):
        return [self.r, 0]

    def size(self, dim=None):
        return 1 if dim == 1 else self.n


@pytest.mark.gpu
def test_select_kernel_row_offset_draws_the_global_rows(cuda):
    """Kernel D on rows [o, o + 4) of a global batch of 8 with
    ``row_offset=o`` selects what one launch on all 8 rows selects for
    them; so does ``VideoTGB.select_frames`` under a 2-rank split (the
    seed drawn from the same generator state on each rank)."""
    from videotgb_torch.parallel.sharding import batch_split

    gen = torch.Generator(device=cuda).manual_seed(19)
    sl, el = torch.randn((8, 66, 2), generator=gen, device=cuda).unbind(-1)
    vl = torch.full((8,), 64, device=cuda)
    kw = dict(num_frames=32, nframe=4, top_k=2, noise_scale=1.0,
              inclusive_end=False, rescale="ratio", out_dtype=torch.int64)
    whole = select_frames_cuda(sl, el, vl, 1234, **kw)
    for o in (0, 4):
        part = select_frames_cuda(sl[o:o + 4], el[o:o + 4], vl[o:o + 4],
                                  1234, row_offset=o, **kw)
        assert torch.equal(part, whole[o:o + 4]), o
    shifted = select_frames_cuda(sl[4:], el[4:], vl[4:], 1234, **kw)
    assert not torch.equal(shifted, whole[4:])  # the offset is what moves
    model = V.VideoTGB(V.VideoTGBConfig.tiny(), device=cuda, seed=0)
    want = model.select_frames(sl, el, vl, torch.Generator(
        device=cuda).manual_seed(5), inclusive_end=False, rescale="ratio")
    for r in range(2):
        with batch_split(_RankOf(r, 2)):
            got = model.select_frames(
                sl[4 * r:4 * r + 4], el[4 * r:4 * r + 4], vl[4 * r:4 * r + 4],
                torch.Generator(device=cuda).manual_seed(5),
                inclusive_end=False, rescale="ratio")
        assert torch.equal(got, want[4 * r:4 * r + 4]), r


@pytest.mark.gpu
def test_dp_step_on_a_one_rank_nccl_group_equals_the_unwrapped_step(cuda):
    """The dp route on a 1-rank NCCL group (its all-reduces of the counts,
    the gradients and the metrics captured in the step's CUDA graph:
    call 1 eager, call 2 captured, call 3 replayed) against the trainer
    without a mesh: the same losses, gradient norms and trainable
    parameters, bit for bit."""
    import torch.distributed as dist

    from videotgb_torch import train as T
    from videotgb_torch.parallel.distributed import free_port
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=cuda if cuda.index is not None
                            else torch.device("cuda", 0))
    try:
        recipe = T.build_recipe({"recipe": "e2e", "tgb_mode": "multi_modal",
                                 "selection": "uniform"})
        runs = []
        for mesh in (None, create_mesh(MeshConfig(dp=1),
                                       device_type="cuda")):
            model, cfg = T.build_model({"preset": "tiny"}, device=cuda,
                                       seed=0)
            trainer = Trainer(TrainerConfig(max_steps=6, lr=1e-3),
                              recipe.loss_fn, recipe.filter_fn, mesh=mesh)
            state = trainer.init_state(model)
            assert (trainer.route, trainer.step_route) == (
                ("single" if mesh is None else "dp"), "graph")
            gen = torch.Generator(device=cuda).manual_seed(2)
            img = cfg.vit.image_size
            batch = {"frames": torch.randn((2, cfg.num_frames, img, img, 3),
                                           generator=gen, device=cuda),
                     "question_ids": torch.randint(4, 60, (2, 6),
                                                   generator=gen, device=cuda),
                     "question_mask": torch.ones((2, 6), device=cuda),
                     "answer_ids": torch.randint(4, 60, (2, 5), generator=gen,
                                                 device=cuda)}
            metrics = []
            for _ in range(3):
                state, m = trainer.train_step(state, batch)
                metrics.append(m)
            runs.append((metrics, {n: p.detach().clone() for n, p in
                                   model.named_parameters()
                                   if n in set(trainer.trainable)}))
        (m0, p0), (m1, p1) = runs
        for a, b in zip(m0, m1):
            assert torch.equal(a["loss"], b["loss"])
            assert torch.equal(a["grad_norm"], b["grad_norm"])
        for n, p in p0.items():
            assert torch.equal(p, p1[n]), n
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_a_one_rank_nccl_engine_at_tp1_keeps_the_graphed_route(cuda):
    """``ServingEngine(mesh="tp=1")`` on a 1-rank NCCL group slices nothing
    and keeps the graphed route (its phases captured before it serves),
    and answers as the engine without a mesh: the same frames and answers,
    request by request."""
    import torch.distributed as dist

    from videotgb_torch.parallel.distributed import free_port
    from videotgb_torch.serve import ServingEngine

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        runs = []
        for mesh in ("", "tp=1"):
            eng = ServingEngine("random:tiny", preset="tiny", batch_size=2,
                                flow_frames=3, max_new_tokens=4, mesh=mesh,
                                device=cuda)
            try:
                assert eng.route == "graph"
                assert (eng.mesh is None) == (mesh == "")
                rng = np.random.default_rng(3)
                image, fs = eng.cfg.vit.image_size, eng.cfg.tgb.flow_size
                replies = []
                for i in range(3):
                    frames = rng.integers(0, 255, (eng.cfg.num_frames, image,
                                                   image, 3), np.uint8)
                    flow = rng.integers(0, 255, (eng.flow_frames + 1, fs, fs,
                                                 3), np.uint8)
                    r = eng.submit(frames, flow, f"q{i}?").result(timeout=300)
                    replies.append((r.answer, r.selected_frames))
                runs.append(replies)
            finally:
                eng.close()
        assert runs[0] == runs[1]
    finally:
        dist.destroy_process_group()


# --------------------------------------------------- scan_layers and remat
@pytest.mark.gpu
def test_a_remat_scan_layers_t5_xl_stack_equals_the_plain_stack(cuda):
    """A T5-xl-shaped encoder (d_model 2048, 32 heads of 64, d_ff 5120; 2
    layers) with ``scan_layers`` and ``remat`` at pp = 1 runs its blocks in
    turn and recomputes each forward in the backward: the output and the
    input's gradient equal the plain stack's, with 2 kernel-A launches a
    forward (2 more in the recomputation) and 2 kernel-C launches a
    backward, all on the tensor-core bodies."""
    from videotgb_torch.models.t5 import T5Config, T5Model

    cfg = dataclasses.replace(T5Config.flan_t5_xl(), num_encoder_layers=2,
                              num_decoder_layers=1)
    plain = T5Model(cfg, device=cuda)
    init_params(plain, 0)
    flagged = T5Model(dataclasses.replace(cfg, scan_layers=True, remat=True),
                      device=cuda)
    flagged.load_state_dict(plain.state_dict())
    gen = torch.Generator(device=cuda).manual_seed(47)
    x = torch.randn((2, 160, 2048), generator=gen, device=cuda)
    mask = torch.ones((2, 160), device=cuda)
    mask[1, 130:] = 0
    w = torch.randn((2048,), generator=gen, device=cuda)
    runs = {}
    for name, model in (("plain", plain), ("remat", flagged)):
        xi = x.clone().requires_grad_()
        kernels.reset_launches()
        out = model.encode(xi, mask)
        forward = dict(kernels.LAUNCHES)
        (out.float() @ w).sum().backward()
        runs[name] = (out.detach().float(), xi.grad, forward,
                      dict(kernels.LAUNCHES), dict(kernels.MMA_LAUNCHES))
    for name, fwd_a, all_a in (("plain", 2, 2), ("remat", 2, 4)):
        _, _, forward, launches, mma = runs[name]
        assert forward["flash_fwd"] == fwd_a and forward["flash_bwd"] == 0
        assert launches["flash_fwd"] == all_a, (name, launches)
        assert launches["flash_bwd"] == 2, (name, launches)
        assert mma["flash_fwd"] == all_a and mma["flash_bwd"] == 2, name
    assert torch.equal(runs["remat"][0], runs["plain"][0])
    assert torch.equal(runs["remat"][1], runs["plain"][1])
