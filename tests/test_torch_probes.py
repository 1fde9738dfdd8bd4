"""The port's probe tools (kernels E, F and G) against the JAX package.

* E: ``videotgb_torch.tools.lookupprobe.blocked_lookup`` (its plain version
  on CPU tensors) against the JAX probe's ``blocked_lookup`` run in
  interpret mode, with and without row skipping. ``tools/lookupprobe.py``
  is not a package, so it is loaded by file path.
* F: ``add_ln_reference`` and ``ln_reference`` against the JAX package's
  ``LayerNorm(eps=1e-6)`` of res + delta, with the probe's gamma 1.1 and
  beta 0.01 (the JAX probe's own variant (a); its Pallas bodies are
  closures inside its ``main``).
* G: ``flash_bshd_reference`` against the JAX ``flash_attention`` (plain
  path) on the (B, H, S, D) transposes, transposed back.

f32, inputs made with numpy from a seed, tolerance 2e-4 (the f32 tolerance
of ``tests/test_parity.py``). The tools' layer stacks and the lookup
probe's ``main`` also run here at tiny sizes on the CPU."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.tools import attnlayoutprobe, lnprobe, lookupprobe
from videotgb_tpu.models.common import LayerNorm
from videotgb_tpu.ops.attention import flash_attention
from videotgb_tpu.ops.correlation_pallas import build_corr_pyramid_t

TOL = dict(atol=2e-4, rtol=2e-4)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_lookupprobe():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_lookupprobe", REPO / "tools" / "lookupprobe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("skip", [False, True])
def test_blocked_lookup_matches_the_jax_probe_kernel(skip):
    pairs, hw = 2, 12
    rng = np.random.default_rng(0)
    f1, f2 = (rng.standard_normal((pairs, hw, hw, 32)).astype(np.float32)
              for _ in range(2))
    pyr = build_corr_pyramid_t(jnp.asarray(f1), jnp.asarray(f2))
    gy, gx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    coords = (np.stack([gx, gy], -1)[None]
              + rng.normal(0, 2.0, (pairs, hw, hw, 2))).astype(np.float32)
    coords[1] = rng.uniform(-3, hw + 2, (hw, hw, 2))  # wild, partly off
    want = _jax_lookupprobe().blocked_lookup(
        tuple(pyr), jnp.asarray(coords), skip=skip, interpret=True)
    got = lookupprobe.blocked_lookup(
        [torch.from_numpy(np.array(lvl)) for lvl in pyr],
        torch.from_numpy(coords), skip=skip)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lookup_probe_main_runs_on_the_cpu():
    res = lookupprobe.main(["--pairs", "2", "--hw", "8", "--iters", "1",
                            "--loop", "2", "--device", "cpu"])
    assert set(res) == {(c, v) for c in ("raft", "wild")
                        for v in ("base", "qblock", "qskip")}
    assert all(r["max_abs_err"] == 0.0 for r in res.values())


def _ln_inputs():
    rng = np.random.default_rng(1)
    res, delta = (rng.standard_normal((2, 5, 48)).astype(np.float32)
                  for _ in range(2))
    g = np.full((48,), 1.1, np.float32)
    b = np.full((48,), 0.01, np.float32)
    jax_ln = LayerNorm(eps=1e-6)
    params = {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}}
    return res, delta, g, b, lambda x: np.asarray(jax_ln.apply(params, x))


def test_add_ln_and_ln_plain_versions_match_jax_layer_norm():
    res, delta, g, b, jax_ln = _ln_inputs()
    t = [torch.from_numpy(a) for a in (res, delta, g, b)]
    summed, normed = lnprobe.add_ln_reference(*t)
    np.testing.assert_array_equal(summed.numpy(), res + delta)
    np.testing.assert_allclose(normed.numpy(), jax_ln(res + delta), **TOL)
    np.testing.assert_allclose(lnprobe.ln_reference(t[0], *t[2:]).numpy(),
                               jax_ln(res), **TOL)
    # the public functions on CPU tensors take the plain versions
    for a, e in zip(lnprobe.add_ln(*t), (summed, normed)):
        assert torch.equal(a, e)
    assert torch.equal(lnprobe.ln(t[0], *t[2:]),
                       lnprobe.ln_reference(t[0], *t[2:]))


def test_add_ln_normalises_the_f32_sum_not_the_rounded_one():
    rng = np.random.default_rng(2)
    res, delta = (torch.from_numpy(rng.standard_normal((4, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    g, b = torch.full((64,), 1.1), torch.full((64,), 0.01)
    summed, normed = lnprobe.add_ln_reference(res, delta, g, b)
    exact = res.float() + delta.float()
    assert torch.equal(summed, exact.to(torch.bfloat16))
    assert torch.equal(normed,
                       lnprobe.ln_reference(exact, g, b).to(torch.bfloat16))
    # the two readings differ on these inputs, so the test tells them apart
    assert not torch.equal(normed, lnprobe.ln_reference(summed, g, b))


def test_ln_probe_variants_agree_at_a_tiny_width():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 32), generator=gen)
    w = lnprobe.make_weights(32, 64, torch.float32, "cpu", gen)
    runs = lnprobe.stacks(x, w, layers=2, heads=4, block_rows=4)
    a = runs["a"]()
    for v in "bc":
        torch.testing.assert_close(runs[v](), a, atol=1e-6, rtol=1e-6)


def test_flash_bshd_plain_version_matches_jax_attention():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 37, 4, 12)).astype(np.float32)
               for _ in range(3))
    scale = 12 ** -0.5
    want = flash_attention(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                             for a in (q, k, v)), scale=scale,
                           use_pallas=False).transpose(0, 2, 1, 3)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = attnlayoutprobe.flash_bshd_reference(*t, scale)
    assert tuple(got.shape) == (2, 37, 4, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(attnlayoutprobe.flash_bshd(*t, scale), got)


def test_attn_layout_probe_variants_agree_at_a_tiny_width():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 10, 32), generator=gen)
    w = attnlayoutprobe.make_weights(32, torch.float32, "cpu", gen)
    a = attnlayoutprobe.stack(attnlayoutprobe.layer_a, x, w, 2, 4)
    for v in "bc":
        got = attnlayoutprobe.stack(attnlayoutprobe.LAYERS[v], x, w, 2, 4)
        torch.testing.assert_close(got, a, atol=1e-6, rtol=1e-6)
