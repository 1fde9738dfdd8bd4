"""videotgb_torch.ops.select_pallas (kernel D's plain version and its CPU
dispatch) against the JAX package's fused selection.

At ``noise_scale=0`` the JAX Pallas kernel runs in interpret mode, as
``tests/test_select_pallas.py`` runs it, and the port must give the same
frame indices exactly. With noise the two draw from different generators,
so the port's plain version gets a numpy-made noise tensor and is held
exactly against the JAX span selection on the argmax of logits + the same
noise. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotgb_torch.ops import select_pallas as S
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
    with pytest.raises(ValueError, match="128"):
        S.select_frames_pallas(sl, sl, vl, 0, num_frames=129)
