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
from videotgb_torch.ops import kernels
from videotgb_torch.ops.attention import (
    NEG_INF,
    dot_product_attention,
    flash_attention,
    make_padding_bias,
)
from videotgb_torch.ops.correlation_pallas import (
    build_corr_pyramid_t,
    lookup_corr_pyramid_t,
    lookup_corr_pyramid_t_plain,
)
from videotgb_torch.ops.decode import DecodeConfig

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
             "per_row": (b, h, sq, skv), "learned": (1, h, sq, skv)}[layout]
    return torch.randn(shape, generator=gen, device=dev)


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
    before = kernels.LAUNCHES["flash_fwd"]
    got = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, dot_product_attention(q, k, v, bias), TOL[dtype])


@pytest.mark.gpu
def test_flash_kernel_masked_row_is_uniform(cuda):
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v = (torch.randn((1, 2, 40, 64), generator=gen, device=cuda)
               for _ in range(3))
    bias = torch.zeros((1, 1, 40, 40), device=cuda)
    bias[..., 7, :] = NEG_INF
    got = flash_attention(q, k, v, bias)
    assert torch.isfinite(got).all()
    _close(got[:, :, 7], v.mean(dim=2), 1e-4)


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


@pytest.mark.gpu
def test_tiny_pipeline_on_the_card_matches_the_cpu(cuda):
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    cfg = V.VideoTGBConfig.tiny()
    bc = cfg.blip2
    cfg = dataclasses.replace(
        cfg, tgb=dataclasses.replace(cfg.tgb, **f32),
        blip2=dataclasses.replace(
            bc, vit=dataclasses.replace(bc.vit, **f32),
            qformer=dataclasses.replace(bc.qformer, **f32),
            t5=dataclasses.replace(bc.t5, **f32)))
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
    assert torch.equal(cand.cpu(), V.select_phase_blip2(cpu, flow, batch,
                                                        noise=noise))
    dcfg = DecodeConfig(max_new_tokens=4)
    got = V.answer_phase_blip2(gpu, frames, batch, dcfg).cpu()
    want = V.answer_phase_blip2(cpu, frames, batch, dcfg)
    assert float((got == want).float().mean()) >= 0.75  # near-tie argmax
