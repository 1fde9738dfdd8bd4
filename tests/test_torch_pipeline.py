"""The whole ported slice against the JAX package on the CPU:
``generate_blip2`` and ``select_phase_blip2`` -> ``answer_phase_blip2`` on
the tiny VideoTGB (f32, shared weights, shared Gumbel noise) give identical
frame indices and greedy tokens; plus the port's import and device rules."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import Pair, close, few_torch_threads, t  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch import resolve_device
from videotgb_torch.models import videotgb as TV
from videotgb_torch.ops.decode import DecodeConfig as TDecode
from videotgb_tpu.data.constants import CLIP_MEAN, CLIP_STD
from videotgb_tpu.models import videotgb as JV
from videotgb_tpu.ops.decode import DecodeConfig as JDecode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE = dict(max_new_tokens=5, eos_token_id=1, pad_token_id=0)
BATCH_KEYS = ("flow_mask", "video_length", "sampler_question_ids",
              "sampler_question_mask", "question_ids", "question_mask")


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _batches(pair):
    x = pair.inputs
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    frames = (x["frames_u8"].astype(np.float32) / 255.0 - mean) / std
    jb = {k: jnp.asarray(x[k]) for k in BATCH_KEYS}
    jb["frames"] = jnp.asarray(frames)
    jb["flow"] = pair.japply(lambda m, f: m.flow_features(f),
                             jnp.asarray(x["flow_u8"], jnp.float32))
    tb = {k: t(v) for k, v in jb.items()}
    for k in ("sampler_question_ids", "question_ids"):
        tb[k] = tb[k].long()
    return jb, tb


def _noise(pair, key):
    """The Gumbel draws the JAX selection makes from ``key``."""
    shape = (pair.jcfg.top_k, 2, 2, pair.inputs["flow_mask"].shape[1] - 2)
    return t(jax.random.gumbel(key, shape, jnp.float32))


def test_generate_blip2_matches_jax(pair):
    jb, tb = _batches(pair)
    key = jax.random.key(0)
    sel_key, _ = jax.random.split(key)
    names = ("frames", "flow", "flow_mask", "video_length",
             "sampler_question_ids", "sampler_question_mask", "question_ids",
             "question_mask")
    # generate_blip2 and the encoder state its decode starts from, in one
    # JAX program: the encoder path compiles once
    (want_tokens, want_cand), (enc_j, mask_j, _) = jax.jit(
        lambda p, b, k: (
            JV.generate_blip2(pair.jmodel, p, b, JDecode(**DECODE), k),
            pair.jmodel.apply(p, *(b[n] for n in names),
                              jax.random.split(k)[0],
                              method=lambda m, *a: m.prepare_t5_inference(
                                  *a))))(pair.params, jb, key)
    got_tokens, got_cand = TV.generate_blip2(pair.tmodel, tb,
                                             TDecode(**DECODE),
                                             noise=_noise(pair, sel_key))
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))
    with torch.no_grad():
        enc_t, mask_t, _ = pair.tmodel.prepare_t5_inference(
            *[tb[k] for k in ("frames", "flow", "flow_mask", "video_length",
                              "sampler_question_ids", "sampler_question_mask",
                              "question_ids", "question_mask")],
            noise=_noise(pair, sel_key))
    close(enc_t, enc_j)
    close(mask_t, mask_j)


def test_two_phase_matches_jax(pair):
    jb, tb = _batches(pair)
    x = pair.inputs
    sel_key, dec_key = jax.random.split(jax.random.key(1))
    want_cand = jax.jit(lambda p, f, b, k: JV.select_phase_blip2(
        pair.jmodel, p, f, b, k))(pair.params, jnp.asarray(x["flow_u8"]), jb,
                                   sel_key)
    got_cand = TV.select_phase_blip2(pair.tmodel, t(x["flow_u8"]), tb,
                                     noise=_noise(pair, sel_key))
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))

    sel = np.stack([x["frames_u8"][i, np.asarray(want_cand)[i]]
                    for i in range(2)])
    want = jax.jit(lambda p, f, b, k: JV.answer_phase_blip2(
        pair.jmodel, p, f, b, JDecode(**DECODE), k))(
        pair.params, jnp.asarray(sel), jb, dec_key)
    got = TV.answer_phase_blip2(pair.tmodel, t(sel), tb, TDecode(**DECODE))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flow_features_timeline_matches_jax(pair):
    f = pair.inputs["flow_u8"]
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32)
    close(pair.tmodel.flow_features_timeline(t(f).float(), t(valid)),
          pair.japply(lambda m, *a: m.flow_features_timeline(*a),
                      jnp.asarray(f, jnp.float32), jnp.asarray(valid)))


def test_sampled_generation_is_seeded(pair):
    _, tb = _batches(pair)
    cfg = TDecode(max_new_tokens=4, do_sample=True, top_p=0.9)
    runs = [TV.generate_blip2(pair.tmodel, tb, cfg,
                              generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_port_imports_no_jax_and_runs_tiny_path():
    """A fresh interpreter imports the port, runs the tiny two-phase path
    on the CPU, and has loaded no jax, flax or videotgb_tpu module."""
    code = textwrap.dedent("""
        import sys
        import torch
        import videotgb_torch
        from videotgb_torch import convert, serve
        from videotgb_torch.data import tokenizer, transforms, video_io
        from videotgb_torch.data import native
        from videotgb_torch.evalsuite import debug, evaluate, inference
        from videotgb_torch.models import videotgb as V
        from videotgb_torch.tools import (
            build_llama_tokenizer, decodeprobe, perfprobe, qformerattnprobe,
            raftencprobe, stemprobe, traceprobe, traintraceprobe)
        from videotgb_torch.utils import profiling, sweep, task
        from videotgb_torch.ops.decode import DecodeConfig
        cfg = V.VideoTGBConfig.tiny()
        model = V.VideoTGB(cfg, device="cpu", seed=0)
        g = torch.Generator().manual_seed(0)
        flow = torch.randint(0, 255, (1, 4, 32, 32, 3), generator=g,
                             dtype=torch.uint8)
        batch = {"flow_mask": torch.ones(1, 5),
                 "video_length": torch.tensor([3]),
                 "sampler_question_ids": torch.tensor([[5, 6, 7]]),
                 "sampler_question_mask": torch.ones(1, 3),
                 "question_ids": torch.tensor([[8, 9, 10, 11]]),
                 "question_mask": torch.ones(1, 4)}
        cand = V.select_phase_blip2(model, flow, batch, generator=g)
        frames = torch.randint(0, 255, (1, cfg.nframe, 56, 56, 3),
                               generator=g, dtype=torch.uint8)
        tokens = V.answer_phase_blip2(model, frames, batch,
                                      DecodeConfig(max_new_tokens=3))
        assert cand.shape == (1, cfg.nframe) and tokens.shape == (1, 3)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "videotgb_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("root", ["videotgb_torch", "chip_smoke.py"])
def test_port_sources_import_nothing_of_jax(root):
    """No module of the port, and not chip_smoke.py, names jax, flax,
    videotgb_tpu or the JAX package's ``tools`` in an import, even inside a
    function."""
    import ast
    import pathlib

    path = pathlib.Path(REPO) / root
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "videotgb_tpu", "tools"), (f, name)


def test_no_device_without_cuda_raises(monkeypatch):
    """Entry points default to the CUDA device and never fall back to the
    CPU: with no CUDA device a call without ``device`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.VideoTGB(TV.VideoTGBConfig.tiny())
    assert resolve_device("cpu") == torch.device("cpu")
