"""The port's W8A8 int8 path and kernel H's plain versions against the JAX
package, on the CPU.

* ``quantize_rows`` / ``quantize_cols`` / ``int8_matmul`` against
  ``videotgb_tpu.ops.quant``: bit for bit (int8 values and f32 scales; the
  same f32 arithmetic in the same order, half-to-even rounding).
* ``int8_mm_reference`` with the bf16 epilogue against the JAX probe's
  ``pallas_int8_mm`` (``tools/int8pallas_probe.py``, loaded by file path, its
  ``pallas_call`` run in interpret mode as in ``tests/test_ops.py``):
  exactly. The i32 -> bf16 rounding goes through f32 on both sides.
* ``bf16_mm_reference`` against ``dot_general(preferred_element_type=f32)``
  rounded to bf16 (the body of the probe's ``mm_kernel_bf16``, a closure
  inside its ``main``): within one bf16 ulp plus the f32 summation-order
  difference.
* The tiny ViT with ``quant="int8"`` in f32, weights made with numpy from a
  seed and carried across by ``convert.py``, against the JAX tower; the
  port's int8 tower against its own bf16 tower under the JAX package's
  serving gate (``tests/test_quant.py``).
* Kernel H's tiling rule ``gemm_tile``: the tiling measured fastest on the
  card at each timed shape, a valid index elsewhere; ``int8_matmul`` hands
  its pick to ``int8_mm``.
* The three int8 tools' ``main`` at tiny sizes on the CPU.
"""

import dataclasses
import importlib.util
import pathlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_port_helpers import few_torch_threads, random_tree  # noqa: F401
from videotgb_torch.convert import load_flax_params
from videotgb_torch.models.common import Dense, init_params
from videotgb_torch.models.vit import ViTConfig as TViTConfig
from videotgb_torch.models.vit import ViTModel as TViTModel
from videotgb_torch.ops import quant as TQ
from videotgb_torch.tools import int8pallas_probe, int8probe, int8sweep
from videotgb_tpu.models.vit import ViTConfig as JViTConfig
from videotgb_tpu.models.vit import ViTModel as JViTModel
from videotgb_tpu.ops import quant as JQ

REPO = pathlib.Path(__file__).resolve().parent.parent


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def _quant_inputs():
    rng = np.random.default_rng(0)
    gauss = (rng.standard_normal((12, 80)) * 3).astype(np.float32)
    gauss[3] = 0.0  # a zero row: the 1e-8 floor on the scale
    halves = np.zeros((4, 16), np.float32)
    halves[:, 0] = 127.0  # amax 127: scale exactly 1, x / scale = x
    halves[:, 1:11] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                       3.5, 4.5]  # half steps round to even
    return {"gaussian": gauss, "half steps": halves}


@pytest.mark.parametrize("case", ["gaussian", "half steps"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_and_cols_match_jax_bit_for_bit(case, dtype):
    x = _quant_inputs()[case]
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for jfn, tfn, jarg, targ in ((JQ.quantize_rows, TQ.quantize_rows, jx, tx),
                                 (JQ.quantize_cols, TQ.quantize_cols, jx.T,
                                  tx.T)):
        (jq, js), (tq, ts) = jfn(jarg), tfn(targ)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(_np(tq), np.asarray(jq))
        np.testing.assert_array_equal(_np(ts).view(np.uint32),
                                      np.asarray(js).view(np.uint32))
    if case == "half steps" and dtype == "float32":
        q, _ = TQ.quantize_rows(tx)
        assert q[0, 1:11].tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 4, 4]
        assert TQ.quantize_rows(torch.zeros(1, 16))[1].item() == np.float32(
            1e-8) / np.float32(127.0)


def test_quantized_weight_reaches_the_kernel_without_a_copy():
    """Dense passes the (K, N) view of its (N, K) weight: the quantized
    transpose is contiguous, so ``int8_mm`` gets it as it is."""
    w = torch.randn(48, 64)  # (out, in)
    q, s = TQ.quantize_cols(w.T)
    assert q.T.is_contiguous() and tuple(s.shape) == (1, 48)


def test_int8_matmul_exact_on_pre_quantized_inputs():
    """``tests/test_quant.py``'s case: inputs on the int8 grid with amax 127
    round-trip exactly, and the port equals the JAX package."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (8, 32)).astype(np.float32)
    x[:, 0] = 127
    w = rng.integers(-127, 128, (32, 16)).astype(np.float32)
    w[0, :] = 127
    got = TQ.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         out_dtype=torch.float32)
    want = JQ.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                          out_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), x @ w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_matmul_gaussian_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 21, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    got = TQ.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(JQ.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == want.shape == (3, 21, 128)
    # the same int8 values and an exact int32 product: only the f32
    # dequant, the same ops in the same order, could differ (measured: 0)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-6, rel
    exact = x @ w
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 2e-2


def _jax_int8_probe():
    """``tools/int8pallas_probe.py`` by file path. Its import sets a
    persistent compilation cache directory; that setting is put back."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_int8pallas_probe", REPO / "tools" / "int8pallas_probe.py")
    module = importlib.util.module_from_spec(spec)
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return module


def test_int8_mm_reference_matches_the_jax_probe_kernel():
    probe = _jax_int8_probe()
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (256, 512)).astype(np.int8)
    w = rng.integers(-127, 128, (512, 256)).astype(np.int8)
    real_call = probe.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return real_call(*args, **kwargs)

    with mock.patch.object(probe.pl, "pallas_call", interp_call):
        want = np.asarray(probe.pallas_int8_mm(
            jnp.asarray(x), jnp.asarray(w), bm=128, bn=128, bk=128))
    w_t = torch.from_numpy(np.ascontiguousarray(w.T))
    got = TQ.int8_mm(torch.from_numpy(x), w_t, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (256, 256)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    acc = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(
        TQ.int8_mm(torch.from_numpy(x), w_t).numpy(), acc)


def test_int8_mm_bf16_epilogue_rounds_through_f32():
    """An accumulator of 2^25 + 2^17 + 1 rounds to 2^25 + 2^17 in f32, a tie
    that bf16 rounds to even, 2^25; one direct rounding would give
    2^25 + 2^18."""
    target = 2 ** 25 + 2 ** 17 + 1
    # 2088 * 127^2 + 127 * 64 + 5 * 5 = target, zero-padded to K = 2096
    x = np.zeros((1, 2096), np.int8)
    w = np.zeros((1, 2096), np.int8)
    x[0, :2090] = 127
    w[0, :2088] = 127
    w[0, 2088] = 64
    x[0, 2089], w[0, 2089] = 5, 5
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert TQ.int8_mm(tx, tw).item() == target
    assert TQ.int8_mm(tx, tw, torch.bfloat16).item() == 2 ** 25
    assert torch.tensor([target]).to(torch.bfloat16).item() == 2 ** 25
    jax_cast = jnp.asarray([target], jnp.int32).astype(jnp.bfloat16)
    assert float(jax_cast[0]) == 2 ** 25


def test_bf16_mm_reference_matches_jax_dot_general():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 384)).astype(np.float32)
    w = rng.standard_normal((384, 96)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax.lax.dot_general(jx, jw, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32).astype(
                                   jnp.bfloat16)
    want = torch.from_numpy(np.asarray(want, np.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw_t = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    got = TQ.bf16_mm(tx, tw_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (64, 96)
    # one bf16 ulp for a rounding flipped by the f32 summation order, plus
    # that order's own difference, <= K * 2^-24 * max|x| * max|w|
    order = 384 * 2.0 ** -24 * float(tx.float().abs().max()
                                     * tw_t.float().abs().max())
    err = (got.float() - want).abs()
    assert bool((err <= TQ.bf16_ulp(want) + order).all()), float(err.max())


# ------------------------------------------------------------ the int8 ViT
def _vit_pair(quant, act, layers=2):
    """The tiny f32 ViT on both sides with one set of numpy weights."""
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    jcfg = dataclasses.replace(JViTConfig.tiny(), quant=quant, act=act,
                               num_layers=layers, **f32)
    tcfg = dataclasses.replace(TViTConfig.tiny(), quant=quant, act=act,
                               num_layers=layers, dtype=torch.float32,
                               param_dtype=torch.float32)
    jmodel = JViTModel(jcfg)
    pix = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, pix), jax.random.key(0))
    tree = random_tree(nn.meta.unbox(shapes)["params"], seed=4)
    tmodel = load_flax_params(TViTModel(tcfg, device="cpu"), tree)
    return jmodel, {"params": jax.tree.map(jnp.asarray, tree)}, tmodel


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_int8_vit_matches_the_jax_tower(act):
    jmodel, params, tmodel = _vit_pair("int8", act)
    img = np.random.default_rng(5).standard_normal((2, 56, 56, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 17, 64)
    # measured 3.4e-7 for both gelus (the f32 summation order of the
    # LayerNorms, attention and dequant); an upstream difference of ~1e-7
    # could flip one activation onto the next int8 step, ~1e-4 of a row
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_int8_vit_stays_within_the_serving_gate_of_the_bf16_tower():
    """``tests/test_quant.py``'s gate on the port: the tiny ViT at 4 layers
    in bf16, int8 against the same weights without quantization."""
    cfg = dataclasses.replace(TViTConfig.tiny(), num_layers=4)
    plain = TViTModel(cfg, device="cpu")
    int8 = TViTModel(dataclasses.replace(cfg, quant="int8"), device="cpu")
    init_params(plain, seed=0)
    int8.load_state_dict(plain.state_dict())
    pix = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    with torch.no_grad():
        out = plain(pix).float().numpy()
        out_q = int8(pix).float().numpy()
    rel = np.linalg.norm(out_q - out) / np.linalg.norm(out)
    assert rel < 0.08, rel
    cos = np.sum(out * out_q, -1) / (np.linalg.norm(out, axis=-1)
                                     * np.linalg.norm(out_q, axis=-1) + 1e-8)
    assert float(cos.min()) > 0.99, float(cos.min())


def test_int8_vit_has_the_plain_vits_state_dict():
    cfg = TViTConfig.tiny()
    plain = TViTModel(cfg, device="cpu").state_dict()
    int8 = TViTModel(dataclasses.replace(cfg, quant="int8"),
                     device="cpu").state_dict()
    assert list(plain) == list(int8)
    assert all(plain[k].shape == int8[k].shape for k in plain)


def test_quant_dense_adds_its_bias_after_the_dequant():
    dense = Dense(32, 8, quant="int8")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        dense.weight.copy_(torch.randn(8, 32, generator=gen))
        dense.bias.copy_(torch.randn(8, generator=gen))
    x = torch.randn(5, 32, generator=gen)
    want = TQ.int8_matmul(x, dense.weight.T) + dense.bias
    assert torch.equal(dense(x), want)
    dense.use_kernel = False
    assert torch.equal(dense(x), want)
    with pytest.raises(ValueError, match="quant"):
        Dense(4, 4, quant="int4")


# ------------------------------------------------- kernel H's tiling rule
# Device time per call (ms) of each tiling, by index into TQ.TILES, from
# one run of chip_smoke.py phase 12 on an H100 80GB HBM3 at 700 W (launches
# captured in a CUDA graph): (M, K, N, dtype) -> times. The W8A8 path's
# three products, the same for one image (264 tokens), and 8192^3 (int8
# with the bf16 epilogue). gemm_tile must pick the fastest.
MEASURED_TILE_MS = {
    (4224, 1408, 1408, torch.int8): (0.0204, 0.0252, 0.0251),
    (4224, 1408, 6144, torch.int8): (0.0760, 0.0772, 0.0946),
    (4224, 6144, 1408, torch.int8): (0.0631, 0.0761, 0.0808),
    (264, 1408, 1408, torch.int8): (0.0077, 0.0122, 0.0085),
    (264, 1408, 6144, torch.int8): (0.0141, 0.0125, 0.0102),
    (264, 6144, 1408, torch.int8): (0.0182, 0.0330, 0.0233),
    (8192, 8192, 8192, torch.int8): (1.0430, 0.7915, 1.3557),
    (8192, 8192, 8192, torch.bfloat16): (1.9764, 1.6043, 2.5578),
}


@pytest.mark.parametrize("shape", list(MEASURED_TILE_MS),
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}-{s[3]}")
def test_gemm_tile_picks_the_tiling_measured_fastest(shape):
    m, k, n, dtype = shape
    times = MEASURED_TILE_MS[shape]
    assert len(times) == len(TQ.TILES)
    assert TQ.gemm_tile(m, n, k, dtype) == min(range(len(times)),
                                               key=times.__getitem__)


@pytest.mark.parametrize("m, k, n", [(1, 1408, 1408), (48, 64, 40),
                                     (64, 4096, 4096), (300, 2064, 257),
                                     (1001, 1424, 999), (70000, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_gemm_tile_is_a_valid_index(m, k, n, dtype):
    tile = TQ.gemm_tile(m, n, k, dtype)
    assert isinstance(tile, int) and 0 <= tile < len(TQ.TILES)


def test_int8_matmul_hands_int8_mm_the_rules_tile(monkeypatch):
    calls = []

    def recording_int8_mm(x, w_t, out_dtype=torch.int32, tile=None):
        calls.append((tuple(x.shape), tuple(w_t.shape), tile))
        return TQ.int8_mm_reference(x, w_t, out_dtype)

    monkeypatch.setattr(TQ, "int8_mm", recording_int8_mm)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 100, 48), generator=gen)
    w = torch.randn((48, 72), generator=gen)
    got = TQ.int8_matmul(x, w)
    assert calls == [((300, 48), (72, 48), TQ.gemm_tile(300, 72, 48))]
    monkeypatch.undo()
    assert torch.equal(got, TQ.int8_matmul(x, w))


# --------------------------------------------------------------- the tools
def test_int8_pallas_probe_main_runs_on_the_cpu(capsys):
    res = int8pallas_probe.main(["--device", "cpu", "--m", "48", "--k", "64",
                                 "--n", "40", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(res) == 2 + 2 * len(TQ.TILES)
    assert all(v["ms"] > 0 for v in res.values())


def test_int8_sweep_main_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(int8sweep, "SHAPES", [(24, 64, 48, "tiny a"),
                                              (8, 32, 16, "tiny b")])
    res = int8sweep.main(["--device", "cpu", "--iters", "1"])
    assert len(res) == 2 * 5
    assert len([ln for ln in capsys.readouterr().out.splitlines()
                if "tiny" in ln]) == 10


def test_int8_probe_main_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(int8probe, "BASE", dataclasses.replace(
        TViTConfig.tiny(), act="gelu_new", param_dtype=torch.bfloat16))
    res = int8probe.main(["--device", "cpu", "--batch", "2", "--iters", "1"])
    assert set(res) == {"bf16", "int8"}
    out = capsys.readouterr().out
    assert "bf16:" in out and "int8:" in out
