"""videotgb_torch ops against videotgb_tpu ops on the CPU.

The two kernels' plain versions are held against the Pallas kernels run in
interpret mode (flash-attention forward, RAFT correlation lookup); the rest
of the ops against their JAX counterparts. Inputs come from numpy seeds.
The CUDA kernels themselves are held against the plain versions on a card
by ``tests/test_torch_gpu.py``.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
import videotgb_tpu.ops.attention as JA
from videotgb_tpu.ops import correlation as JC
from videotgb_tpu.ops import correlation_pallas as JCP
from videotgb_tpu.ops import decode as JD
from videotgb_tpu.ops import rope as JR
from videotgb_tpu.ops import select as JS
from videotgb_torch.ops import attention as TA
from videotgb_torch.ops import correlation as TC
from videotgb_torch.ops import correlation_pallas as TCP
from videotgb_torch.ops import decode as TD
from videotgb_torch.ops import rope as TR
from videotgb_torch.ops import select as TS

TOL = dict(atol=2e-4, rtol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _pallas_interpret():
    real = JA.pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    return mock.patch.object(JA.pl, "pallas_call", call)


# ------------------------------------------------------------- attention
BIAS_LAYOUTS = ["none", "shared", "per_batch", "padding", "per_row", "learned"]


def _bias(layout, rng, b, h, sq, skv):
    if layout == "none":
        return None
    if layout == "padding":
        mask = rng.integers(0, 2, (b, skv)).astype(np.float32)
        mask[:, 0] = 1
        return np.asarray(JA.make_padding_bias(jnp.asarray(mask)))
    shape = {"shared": (1, 1, sq, skv), "per_batch": (b, 1, sq, skv),
             "per_row": (b, h, sq, skv), "learned": (1, h, sq, skv)}[layout]
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d", [16, 24])
@pytest.mark.parametrize("layout", BIAS_LAYOUTS)
def test_flash_plain_matches_pallas_interpret(layout, d):
    rng = np.random.default_rng(BIAS_LAYOUTS.index(layout) * 10 + d)
    b, h, sq, skv = 2, 3, 19, 37  # ragged: neither is a block multiple
    q, k = (rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, skv))
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    bias = _bias(layout, rng, b, h, sq, skv)
    scale = d ** -0.5
    with _pallas_interpret():
        want = jax.jit(JA._flash_forward, static_argnums=(4, 5, 6))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), scale, 8, 16)
    got = TA.flash_attention(_t(q), _t(k), _t(v),
                             None if bias is None else _t(bias), scale)
    _close(got, want)
    plain = JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), scale)
    _close(TA.dot_product_attention(_t(q), _t(k), _t(v),
                                    None if bias is None else _t(bias), scale),
           plain)


def test_flash_plain_fully_masked_row_is_uniform():
    """A row whose keys all carry NEG_INF averages v uniformly (the plain
    softmax's answer), with no NaN; the JAX reference agrees."""
    rng = np.random.default_rng(3)
    b, h, s, d = 1, 2, 12, 8
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((b, 1, s, s), np.float32)
    bias[:, :, 5, :] = TA.NEG_INF
    got = TA.flash_attention(_t(q), _t(k), _t(v), _t(bias)).numpy()
    assert np.isfinite(got).all()
    _close(got[:, :, 5], np.broadcast_to(v.mean(axis=2), got[:, :, 5].shape))
    want = JA.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(bias))
    _close(got, want)


def test_flash_plain_keeps_bf16_casts():
    """bf16 operands: f32 scores and softmax, probabilities rounded to bf16
    before PV, bf16 out - the JAX function's casts, to bf16 rounding."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
               for _ in range(3))
    got = TA.dot_product_attention(*(_t(x).bfloat16() for x in (q, k, v)))
    want = JA.dot_product_attention(*(jnp.asarray(x, jnp.bfloat16)
                                      for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)


BWD_LAYOUTS = ["none", "scalar", "per_batch", "per_row", "learned",
               "per_query"]


def _bwd_bias(kind, rng, b, h, sq, skv):
    """The bias layouts of tests/test_ops.py's backward-kernel test."""
    if kind == "none":
        return None
    if kind == "scalar":
        return np.asarray(JA.make_causal_bias(sq, skv))  # (1, 1, sq, skv)
    if kind == "per_batch":
        mask = rng.integers(0, 2, (b, skv)).astype(np.float32)
        mask[:, 0] = 1
        return np.asarray(JA.make_padding_bias(jnp.asarray(mask)))
    shape = {"per_row": (b, h, sq, skv), "learned": (1, h, sq, skv),
             "per_query": (b, 1, sq, 1)}[kind]
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bias_needs_grad", [True, False])
@pytest.mark.parametrize("kind", BWD_LAYOUTS)
def test_flash_backward_plain_matches_pallas_interpret(kind, bias_needs_grad):
    """Kernel C's plain version against the Pallas backward kernel run in
    interpret mode, and against autograd of the plain forward: dq/dk/dv,
    and the bias cotangent reduced to the bias's own shape (None where the
    bias is declared a mask). f32, tolerance 2e-4."""
    rng = np.random.default_rng(BWD_LAYOUTS.index(kind) + 40)
    b, h, sq, skv, d = 2, 4, 24, 40, 16
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, skv, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    bias = _bwd_bias(kind, rng, b, h, sq, skv)
    scale = d ** -0.5
    want = JA._flash_backward_pallas(
        *(jnp.asarray(x) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), jnp.asarray(g), scale,
        interpret=True, bias_needs_grad=bias_needs_grad)
    got = TA.flash_backward_reference(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias), _t(g), scale,
        bias_needs_grad=bias_needs_grad)
    for name, a, e in zip(("dq", "dk", "dv", "dbias"), got, want):
        if e is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == e.shape, name
        _close(a, e, err_msg=name, **TOL)

    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    if bias is not None:
        leaves.append(_t(bias).requires_grad_())
    out = TA.dot_product_attention(*leaves[:3], leaves[3] if bias is not None
                                   else None, scale)
    grads = torch.autograd.grad(out, leaves, _t(g))
    for name, a, e in zip(("dq", "dk", "dv", "dbias"), got, grads):
        if a is not None:
            _close(a, e.numpy(), err_msg=name, **TOL)


def test_flash_backward_plain_fully_masked_row():
    """A row whose keys all carry NEG_INF: finite gradients, the plain
    softmax's (uniform average) gradients."""
    rng = np.random.default_rng(47)
    b, h, s, d = 1, 2, 12, 8
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for _ in range(4))
    bias = torch.zeros((b, 1, s, s))
    bias[:, :, 5, :] = TA.NEG_INF
    got = TA.flash_backward_reference(q, k, v, bias, g, d ** -0.5,
                                      bias_needs_grad=False)
    assert all(torch.isfinite(x).all() for x in got[:3])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = TA.dot_product_attention(*leaves, bias, d ** -0.5)
    for a, e in zip(got, torch.autograd.grad(out, leaves, g)):
        _close(a, e)


@pytest.mark.parametrize("s_q,s_kv", [(5, 5), (1, 7), (3, 9)])
def test_bias_builders_match_jax(s_q, s_kv):
    mask = np.array([[1, 1, 0, 1, 0, 1, 1, 0, 1][:s_kv]], np.float32)
    _close(TA.make_padding_bias(_t(mask)),
           JA.make_padding_bias(jnp.asarray(mask)))
    _close(TA.make_causal_bias(s_q, s_kv), JA.make_causal_bias(s_q, s_kv))


# ------------------------------------------------------------ correlation
LOOKUP_CASES = {
    # (h, w, levels, radius, coord range): off-image coords included
    "8x8_r2": (8, 8, 3, 2, (-2.0, 9.0)),
    "4x4_clamp_1x1": (4, 4, 4, 2, (-1.0, 5.0)),
    "6x5_r4": (6, 5, 4, 4, (-6.0, 10.0)),
}


@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
def test_lookup_plain_matches_pallas_interpret(case):
    h, w, levels, radius, (lo, hi) = LOOKUP_CASES[case]
    rng = np.random.default_rng(sorted(LOOKUP_CASES).index(case))
    b, c = 2, 16
    f1, f2 = (rng.standard_normal((b, h, w, c)).astype(np.float32)
              for _ in range(2))
    coords = rng.uniform(lo, hi, (b, h, w, 2)).astype(np.float32)

    def jit(fn):  # one compile beats op-by-op dispatch of the references
        return jax.jit(fn, static_argnums=2)

    pyr_t_j = jit(JCP.build_corr_pyramid_t)(jnp.asarray(f1), jnp.asarray(f2),
                                            levels)
    pyr_t = TCP.build_corr_pyramid_t(_t(f1), _t(f2), levels)
    assert [tuple(p.shape) for p in pyr_t] == [p.shape for p in pyr_t_j]
    for got, want in zip(pyr_t, pyr_t_j):
        _close(got, want, atol=1e-5, rtol=1e-5)
    pyr_j = jit(JC.build_corr_pyramid)(jnp.asarray(f1), jnp.asarray(f2),
                                       levels)
    pyr = TC.build_corr_pyramid(_t(f1), _t(f2), levels)
    for got, want in zip(pyr, pyr_j):
        _close(got, want, atol=1e-5, rtol=1e-5)

    got = TCP.lookup_corr_pyramid_t(pyr_t, _t(coords), radius)
    interp = jit(JCP.lookup_corr_pyramid_interpret)(
        pyr_t_j, jnp.asarray(coords), radius)
    assert tuple(got.shape) == (b, h, w, levels * (2 * radius + 1) ** 2)
    _close(got, interp, atol=1e-4, rtol=1e-4)
    dense_j = jit(JC.lookup_corr_pyramid_dense)(pyr_j, jnp.asarray(coords),
                                                radius)
    _close(TC.lookup_corr_pyramid_dense(pyr, _t(coords), radius), dense_j,
           atol=1e-4, rtol=1e-4)
    # the 2-tap bilinear form the CUDA kernel uses is the same function
    _close(got, jit(JC.lookup_corr_pyramid)(pyr_j, jnp.asarray(coords),
                                            radius), atol=1e-4, rtol=1e-4)


def test_level_sizes_follow_the_build():
    assert TCP.level_sizes(28, 28, 4) == [(28, 28), (14, 14), (7, 7), (3, 3)]
    assert TCP.level_sizes(4, 4, 4) == [(4, 4), (2, 2), (1, 1), (1, 1)]


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    coords = rng.uniform(-1.5, 8.0, (2, 4, 5, 2)).astype(np.float32)
    _close(TC.bilinear_sample(_t(img), _t(coords)),
           JC.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))


def test_lookup_gradient_goes_through_the_plain_version():
    """On the CPU the lookup is the plain function, differentiable by
    autograd; the CUDA path's autograd.Function recomputes the same one."""
    rng = np.random.default_rng(8)
    f1, f2 = (torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(
        np.float32)) for _ in range(2))
    pyr = [p.requires_grad_() for p in TCP.build_corr_pyramid_t(f1, f2, 2)]
    coords = torch.from_numpy(rng.uniform(0, 3, (1, 4, 4, 2)).astype(np.float32))
    TCP.lookup_corr_pyramid_t(pyr, coords, 1).sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in pyr)


# ------------------------------------------------------------- selection
@pytest.mark.parametrize("inclusive_end", [True, False])
@pytest.mark.parametrize("rescale", ["minus1", "ratio"])
def test_select_frames_from_spans_exact(rescale, inclusive_end):
    rng = np.random.default_rng(11)
    b, k, num_frames, nframe = 64, 2, 32, 4
    length = rng.integers(1, 66, (b,)).astype(np.int32)
    starts = rng.integers(0, 70, (b, k)).astype(np.int32)
    ends = rng.integers(0, 70, (b, k)).astype(np.int32)
    starts[:4] = 0
    ends[:4] = 0  # the degenerate (0, 0) pair
    want = JS.select_frames_from_spans(
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(length),
        num_frames, nframe, inclusive_end=inclusive_end, rescale=rescale)
    got = TS.select_frames_from_spans(
        _t(starts), _t(ends), _t(length), num_frames, nframe,
        inclusive_end=inclusive_end, rescale=rescale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(8):
        assert got[i].tolist() == JS.select_frames_reference_np(
            starts[i], ends[i], int(length[i]), num_frames, nframe,
            inclusive_end=inclusive_end, rescale=rescale)


def test_gumbel_span_sample_equal_under_shared_noise():
    rng = np.random.default_rng(12)
    start = rng.standard_normal((3, 9)).astype(np.float32)
    end = rng.standard_normal((3, 9)).astype(np.float32)
    key = jax.random.key(5)
    js, je = JS.gumbel_span_sample(jnp.asarray(start), jnp.asarray(end), key, 2)
    noise = np.asarray(jax.random.gumbel(key, (2, 2, 3, 9), jnp.float32))
    ts, te = TS.gumbel_span_sample(_t(start), _t(end), top_k=2,
                                   noise=_t(noise))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_gumbel_span_sample_generator_reaches_every_index():
    logits = torch.zeros((512, 16))
    gen = torch.Generator().manual_seed(0)
    s, _ = TS.gumbel_span_sample(logits, logits, gen, top_k=1)
    assert torch.bincount(s.flatten().long(), minlength=16).min() > 0


# ------------------------------------------------------------------ rope
@pytest.mark.parametrize("seq,dim", [(6, 16), (5, 64)])
def test_roformer_rope_matches_jax(seq, dim):
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, 3, seq, dim)).astype(np.float32)
    table_j = JR.roformer_sincos_table(seq, dim)
    table = TR.roformer_sincos_table(seq, dim)
    _close(table, table_j, atol=1e-5, rtol=1e-5)
    _close(TR.roformer_rope(_t(x), table),
           JR.roformer_rope(jnp.asarray(x), table_j))


# ---------------------------------------------------------------- decode
def _decode_pair(cfg_kwargs, stop_sequences=()):
    rng = np.random.default_rng(13)
    b, v, steps = 3, 11, 6
    table = rng.standard_normal((steps, b, v)).astype(np.float32)

    def j_step(tokens, caches, index):
        return jnp.asarray(table)[index] + 0.3 * tokens, caches

    def t_step(tokens, caches, index):
        return torch.from_numpy(table[index]) + 0.3 * tokens, caches

    start = np.array([2, 3, 4], np.int32)
    want = JD.decode(j_step, None, jnp.asarray(start),
                     JD.DecodeConfig(**cfg_kwargs),
                     stop_sequences=stop_sequences)
    got = TD.decode(t_step, None, _t(start), TD.DecodeConfig(**cfg_kwargs),
                    stop_sequences=stop_sequences)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("penalty", [1.0, 1.5])
def test_greedy_decode_matches_jax(penalty):
    got, want = _decode_pair(dict(max_new_tokens=6, eos_token_id=5,
                                  repetition_penalty=penalty))
    np.testing.assert_array_equal(got, want)


def test_decode_stop_sequences_match_jax():
    got, want = _decode_pair(dict(max_new_tokens=6, eos_token_id=99),
                             stop_sequences=((7, 3), (10,)))
    np.testing.assert_array_equal(got, want)


def test_top_p_and_repetition_penalty_match_jax():
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((4, 20)).astype(np.float32)
    gen = rng.integers(0, 20, (4, 5))
    _close(TD.top_p_filter(_t(logits), 0.7),
           JD._top_p_filter(jnp.asarray(logits), 0.7))
    _close(TD.apply_repetition_penalty(_t(logits), _t(gen), 1.3),
           JD.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(gen),
                                       1.3))


def test_sampling_decode_is_seeded():
    def step(tokens, caches, index):
        return torch.zeros((2, 9)), caches

    cfg = TD.DecodeConfig(max_new_tokens=5, eos_token_id=99, do_sample=True,
                          top_p=0.9)
    runs = [TD.decode(step, None, torch.zeros(2, dtype=torch.long), cfg,
                      generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
