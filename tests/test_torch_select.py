"""videotgb_torch.ops.select_pallas (kernel D's plain version and its CPU
dispatch) against the JAX package's fused selection.

At ``noise_scale=0`` the JAX Pallas kernel runs in interpret mode, as
``tests/test_select_pallas.py`` runs it, and the port must give the same
frame indices exactly. With noise the two draw from different generators,
so the port's plain version gets a numpy-made noise tensor and is held
exactly against the JAX span selection on the argmax of logits + the same
noise. Inputs are made with numpy from a seed. Kernel D itself runs only on
the card (``tests/test_torch_gpu.py``); here its launch arguments are
checked (the logits' views passed where they lie, the dtype codes) and
``VideoTGB.select_frames`` on the CPU is held to the plain route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotgb_torch.models import videotgb as TV
from videotgb_torch.ops import kernels
from videotgb_torch.ops import select_pallas as S
from videotgb_torch.ops.select import select_frames
from videotgb_tpu.ops.select import select_frames_from_spans
from videotgb_tpu.ops.select_pallas import select_frames_pallas

# name: (B, L, F, nframe, lengths, inclusive_end, rescale); the first four
# are the cases of tests/test_select_pallas.py
CASES = {
    "deterministic": (8, 64, 32, 4, "random", False, "minus1"),
    "inclusive_end": (4, 16, 8, 2, "full", True, "minus1"),
    "degenerate_and_short": (2, 8, 8, 4, "1_5", True, "minus1"),
    "ratio": (8, 64, 32, 4, "random", False, "ratio"),
    "frames128_nframe8": (6, 256, 128, 8, "random", False, "minus1"),
}


def _inputs(name, seed=0):
    b, l, f, nf, lengths, inclusive, rescale = CASES[name]
    rng = np.random.default_rng(seed)
    if name == "degenerate_and_short":  # peaks at (0, 0): the full span
        sl = np.full((b, l), -10.0, np.float32)
        sl[:, 0] = 10.0
        el = sl.copy()
    else:
        sl = rng.standard_normal((b, l)).astype(np.float32)
        el = rng.standard_normal((b, l)).astype(np.float32)
    vl = {"random": rng.integers(2, l, (b,)), "full": np.full((b,), l),
          "1_5": np.array([1, 5])}[lengths].astype(np.int32)
    return sl, el, vl, dict(num_frames=f, nframe=nf, inclusive_end=inclusive,
                            rescale=rescale)


def _jax(sl, el, vl, kw):
    return np.asarray(select_frames_pallas(
        jnp.asarray(sl), jnp.asarray(el), jnp.asarray(vl), seed=0,
        noise_scale=0.0, interpret=True, **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_the_pallas_kernel_without_noise(name):
    sl, el, vl, kw = _inputs(name)
    want = _jax(sl, el, vl, kw)
    args = (torch.from_numpy(sl), torch.from_numpy(el), torch.from_numpy(vl))
    got = S.select_frames_pallas_reference(*args, noise_scale=0.0, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the public function on CPU tensors takes the plain version
    np.testing.assert_array_equal(
        S.select_frames_pallas(*args, seed=3, noise_scale=0.0, **kw).numpy(),
        want)


def test_plain_version_matches_the_pallas_kernel_on_a_nan_logit():
    sl, el, vl, kw = _inputs("deterministic")
    sl[1, 5] = np.nan  # argmax puts NaN above every number, in both
    el[2, 0] = np.nan
    got = S.select_frames_pallas_reference(
        torch.from_numpy(sl), torch.from_numpy(el), torch.from_numpy(vl),
        noise_scale=0.0, **kw)
    np.testing.assert_array_equal(got.numpy(), _jax(sl, el, vl, kw))


@pytest.mark.parametrize("noise_scale", [1.0, 0.5])
@pytest.mark.parametrize("rescale", ["minus1", "ratio"])
def test_plain_version_with_noise_matches_jax_span_selection(noise_scale,
                                                             rescale):
    b, l, f, nf, top_k = 8, 66, 32, 4, 2
    rng = np.random.default_rng(1)
    sl = rng.standard_normal((b, l)).astype(np.float32)
    el = rng.standard_normal((b, l)).astype(np.float32)
    vl = rng.integers(2, l, (b,)).astype(np.int32)
    noise = rng.gumbel(size=(top_k, 2, b, l)).astype(np.float32)
    scaled = noise_scale * noise
    starts = jnp.argmax(jnp.asarray(sl)[None] + scaled[:, 0], axis=-1).T
    ends = jnp.argmax(jnp.asarray(el)[None] + scaled[:, 1], axis=-1).T
    want = select_frames_from_spans(starts, ends, jnp.asarray(vl), f, nf,
                                    inclusive_end=False, rescale=rescale)
    got = S.select_frames_pallas_reference(
        torch.from_numpy(sl), torch.from_numpy(el), torch.from_numpy(vl),
        num_frames=f, nframe=nf, top_k=top_k, noise_scale=noise_scale,
        rescale=rescale, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_dispatch_draws_its_noise_from_the_seed():
    rng = np.random.default_rng(2)
    sl, el = (torch.from_numpy(rng.standard_normal((16, 66)).astype(
        np.float32)) for _ in range(2))
    vl = torch.full((16,), 64, dtype=torch.int32)
    a, b, c = (S.select_frames_pallas(sl, el, vl, seed) for seed in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 32


def test_select_frames_pallas_raises_on_what_the_kernel_does_not_take():
    sl = torch.zeros((2, 8))
    vl = torch.full((2,), 8)
    with pytest.raises(ValueError, match="rescale"):
        S.select_frames_pallas(sl, sl, vl, 0, rescale="nearest")
    with pytest.raises(ValueError, match=str(S.MAX_FRAMES)):
        S.select_frames_pallas(sl, sl, vl, 0, num_frames=S.MAX_FRAMES + 1)


# F: the serving path's 32, a short 4, the TPU kernel's old 128 and a long
# 512 past it (the card's kernel keeps one mask word a lane up to 1024)
@pytest.mark.parametrize("inclusive_end", [False, True])
@pytest.mark.parametrize("rescale", ["minus1", "ratio"])
@pytest.mark.parametrize("num_frames", [4, 32, 128, 512])
def test_plain_version_on_strided_views_matches_jax(num_frames, rescale,
                                                    inclusive_end):
    """The TGB head's (B, L, 2) logits handed over as their strided views,
    as the path hands them: without noise against the Pallas kernel in
    interpret mode, with handed noise against the JAX span selection on the
    argmax of logits + the same noise."""
    b, l, nf, top_k = 4, 40, 8, 2
    rng = np.random.default_rng(num_frames)
    logits = rng.standard_normal((b, l, 2)).astype(np.float32)
    vl = rng.integers(2, l + 3, (b,)).astype(np.int32)
    noise = rng.gumbel(size=(top_k, 2, b, l)).astype(np.float32)
    kw = dict(num_frames=num_frames, nframe=nf, inclusive_end=inclusive_end,
              rescale=rescale)
    sl, el = torch.from_numpy(logits).unbind(-1)
    assert sl.stride() == (2 * l, 2)
    args = (sl, el, torch.from_numpy(vl))
    got = S.select_frames_pallas_reference(*args, noise_scale=0.0, **kw)
    want = _jax(logits[..., 0], logits[..., 1], vl, kw)
    np.testing.assert_array_equal(got.numpy(), want)
    starts = jnp.argmax(jnp.asarray(logits[..., 0])[None] + noise[:, 0],
                        axis=-1).T
    ends = jnp.argmax(jnp.asarray(logits[..., 1])[None] + noise[:, 1],
                      axis=-1).T
    want = select_frames_from_spans(starts, ends, jnp.asarray(vl),
                                    num_frames, nf,
                                    inclusive_end=inclusive_end,
                                    rescale=rescale)
    got = S.select_frames_pallas_reference(
        *args, top_k=top_k, noise=torch.from_numpy(noise), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_frame_limit_is_the_kernels_register_mask():
    # 32 lanes x 32 words x 32 frames; the plain version takes the limit
    assert S.MAX_FRAMES == 32 * 32 * 32
    sl = torch.zeros((2, 8))
    vl = torch.tensor([8, 3])
    got = S.select_frames_pallas_reference(sl, sl, vl, S.MAX_FRAMES, 4,
                                           noise_scale=0.0)
    assert int(got.max()) < S.MAX_FRAMES
    for f in (0, S.MAX_FRAMES + 1):
        with pytest.raises(ValueError, match=str(S.MAX_FRAMES)):
            S.select_frames_pallas_reference(sl, sl, vl, f, 4)
        with pytest.raises(ValueError, match=str(S.MAX_FRAMES)):
            S.select_launch_args(sl, sl, vl, 0, f, 4, 2, 1.0, False,
                                 "minus1")
    with pytest.raises(ValueError, match=str(S.MAX_NFRAME)):
        S.select_launch_args(sl, sl, vl, 0, 32, S.MAX_NFRAME + 1, 2, 1.0,
                             False, "minus1")


def test_launch_args_read_the_logits_where_they_lie():
    """Kernel D's arguments on CPU tensors: the strided views' own pointers
    and strides (no copy), the lengths' and the indices' dtypes as codes,
    the seed by value or through a tensor's pointer, the noise's copy."""
    head = torch.zeros((3, 7, 2))
    sl, el = head.unbind(-1)
    vl = torch.tensor([7, 2, 5])
    out, args, keep = S.select_launch_args(sl, el, vl, 9, 32, 4, 2, 1.0,
                                           True, "ratio",
                                           out_dtype=torch.int64)
    assert len(args) + 1 == len(kernels._SIGNATURES["select_frames"])
    assert args[:6] == (sl.data_ptr(), el.data_ptr(), 14, 2, 14, 2)
    assert args[6] == vl.data_ptr() and args[7] == 1  # int64, not cast
    assert args[8:11] == (None, None, 9)  # Philox, seed by value
    assert args[11] == out.data_ptr() and args[12] == 1
    assert out.dtype == torch.int64 and tuple(out.shape) == (3, 4)
    assert args[13:] == (3, 7, 32, 4, 2, 1.0, 1, 1)
    assert keep[0] is sl and keep[1] is el
    seed = torch.tensor([5], dtype=torch.int32)
    noise = torch.zeros((2, 2, 3, 7), dtype=torch.float64)
    for lengths, code in ((vl.int(), 0), (vl.float(), 0),
                          (vl.to(torch.uint8), 0)):
        out, args, keep = S.select_launch_args(sl, el, lengths, seed, 32, 4,
                                               2, 1.0, False, "minus1",
                                               noise=noise)
        assert args[7] == code and keep[2].dtype == torch.int32
        assert args[9] == seed.data_ptr() and args[10] == 0
        assert keep[3].dtype == torch.float32 and args[8] == \
            keep[3].data_ptr()
        assert args[12] == 0 and out.dtype == torch.int32
    with pytest.raises(ValueError, match="noise"):
        S.select_launch_args(sl, el, vl, 0, 32, 4, 2, 1.0, False, "minus1",
                             noise=torch.zeros((2, 2, 3, 6)))
    with pytest.raises(ValueError, match="seed"):
        S.select_launch_args(sl, el, vl, seed.long(), 32, 4, 2, 1.0, False,
                             "minus1")
    with pytest.raises(ValueError, match="video_length"):
        S.select_launch_args(sl, el, vl[:2], 0, 32, 4, 2, 1.0, False,
                             "minus1")


def test_videotgb_select_frames_on_the_cpu_launches_nothing():
    """On CPU logits ``VideoTGB.select_frames`` is the plain route of
    ``ops.select``, as before kernel D took the card's route: the same
    int64 indices for the same noise, and no kernel launch counted."""
    cfg = TV.VideoTGBConfig.tiny()
    model = TV.VideoTGB(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(3)
    sl, el = torch.from_numpy(rng.standard_normal((3, 9, 2)).astype(
        np.float32)).unbind(-1)
    vl = torch.tensor([9, 4, 1])
    noise = torch.from_numpy(rng.gumbel(size=(cfg.top_k, 2, 3, 9)).astype(
        np.float32))
    before = dict(kernels.LAUNCHES)
    for inclusive_end, rescale in ((False, "minus1"), (False, "ratio"),
                                   (True, "minus1")):
        got = model.select_frames(sl, el, vl, inclusive_end=inclusive_end,
                                  rescale=rescale, noise=noise)
        want = select_frames(sl, el, vl, cfg.num_frames, cfg.nframe,
                             top_k=cfg.top_k, inclusive_end=inclusive_end,
                             rescale=rescale, noise=noise)
        assert got.dtype == torch.int64 and torch.equal(got, want)
    drawn = model.select_frames(sl, el, vl, torch.Generator().manual_seed(1))
    assert tuple(drawn.shape) == (3, cfg.nframe)
    assert kernels.LAUNCHES == before
