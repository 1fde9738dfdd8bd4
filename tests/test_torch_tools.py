"""The trace and probe tools, the profiling helpers, sweeps, the judge
debug and the tokenizer asset's build of the port, on the CPU at tiny
sizes.

* ``utils/profiling.py``: the summariser on a hand-made event list (rows,
  counts, shares, families) and on a CPU ``torch.profiler`` run; ``timed``
  and ``decode_throughput``.
* The tools' ``main`` with ``--device cpu`` (the plain versions of the
  kernels) at tiny shapes: each segment and step runs and is summarised,
  and the variants of a probe agree with its first variant within bf16
  rounding (the JAX probes print these differences; the tolerances are
  stated beside each check).
* ``decodeprobe``'s copies of ``bench.py``'s ``make_synthetic_video`` and
  ``decode_clip_uint8``: the same file bytes and frames.
* ``utils/sweep.py`` against the JAX module: ``parse_space``,
  ``tpe_suggest`` and ``run_sweep`` with a stub ``train_fn`` give the same
  suggestions and history for one seed; a 2-trial sweep through
  ``videotgb_torch.train`` writes the multirun layout that
  ``tests/test_entries.py::test_hydra_sweep_multirun_subdirs`` asserts of
  the JAX one.
* ``evalsuite/debug.py::stats_from_combined`` equal to the JAX one.
* ``tools/build_llama_tokenizer.py::build`` byte-equal to the JAX
  ``build`` and to the committed asset.
"""

import json
import random

import numpy as np
import pytest
import torch

from _torch_port_helpers import few_torch_threads  # noqa: F401
from videotgb_torch.models.videotgb import VideoTGB, VideoTGBConfig
from videotgb_torch.tools import (
    decodeprobe,
    perfprobe,
    qformerattnprobe,
    raftencprobe,
    stemprobe,
    traceprobe,
    traintraceprobe,
)
from videotgb_torch.utils import profiling, sweep


@pytest.fixture(scope="module")
def tiny_model():
    """A tiny f32 model (the tools' bf16 serving config is held apart: bf16
    convolutions are slow on the CPU)."""
    torch.manual_seed(0)
    return VideoTGB(VideoTGBConfig.tiny(), device="cpu", seed=0)


# ------------------------------------------------------------- profiling
def test_summarize_groups_a_hand_made_event_list():
    events = [("void flash_mma_kernel<88, 64>(Args)", 2.0),
              ("void flash_mma_kernel<88, 64>(Args)", 1.0),
              ("corr_tile::tile_kernel<bf16>", 3.0),
              ("sm90_xmma_gemm_bf16bf16", 3.0),
              ("Memcpy HtoD (Pageable -> Device)", 1.0)]
    s = profiling.summarize(events, wall_ms=20.0)
    assert s["device_total_ms"] == 10.0 and s["wall_ms"] == 20.0
    assert s["ops"] == 5
    rows = list(s["by_name"].items())
    assert [r[1]["ms"] for r in rows] == [3.0, 3.0, 3.0, 1.0]
    flash = s["by_name"]["void flash_mma_kernel<88, 64>(Args)"]
    assert flash == {"ms": 3.0, "n": 2, "pct": 30.0}
    fam = {f: (g["ms"], g["n"]) for f, g in s["families"].items()}
    assert fam["kernel A"] == (3.0, 2) and fam["kernels B/E"] == (3.0, 1)
    assert fam["cuBLAS/cuDNN"] == (3.0, 1)
    assert fam[profiling.OTHER] == (1.0, 1)
    assert fam["kernel C"] == fam["kernel D"] == fam["kernel H"] == (0.0, 0)
    assert list(s["families"])[-1] == profiling.OTHER
    assert sum(g["pct"] for g in s["families"].values()) == pytest.approx(100)
    empty = profiling.summarize([])
    assert empty["device_total_ms"] == 0 and empty["ops"] == 0


def test_traced_summarises_a_cpu_profiler_run(tmp_path):
    a = torch.randn(64, 64)

    def fn():
        with torch.profiler.record_function("a span"):  # not an operation
            return (a @ a).relu().sum()

    s = profiling.traced(fn, "cpu", reps=3,
                         trace_path=str(tmp_path / "t.json"))
    assert 0 < s["device_total_ms"] <= s["wall_ms"]
    assert s["by_name"]["aten::mm"]["n"] == 3
    assert "a span" not in s["by_name"]
    assert (tmp_path / "t.json").stat().st_size > 0


def test_timed_and_decode_throughput(tmp_path):
    calls = []
    sec, out = profiling.timed(lambda x: calls.append(x) or x * 2, 3,
                               iters=3, warmup=2)
    assert out == 6 and len(calls) == 5 and sec >= 0
    path = str(tmp_path / "clip.mp4")
    decodeprobe.make_synthetic_video(path, num_frames=12, size=32)
    r = profiling.decode_throughput(path, num_frames=4, size=16, iters=1)
    assert r["decode_s"] > 0 and r["frames_per_s"] == 4 / r["decode_s"]


# ------------------------------------------------------------ trace tools
def test_serving_config_is_the_jax_trace_build():
    cfg = traceprobe.serving_config()
    assert cfg.blip2.vit.act == "gelu_new"
    assert cfg.raft.dtype == torch.bfloat16
    assert cfg.blip2.vit.param_dtype == cfg.blip2.t5.param_dtype == \
        cfg.tgb.param_dtype == torch.bfloat16


@pytest.mark.parametrize("which", traceprobe.SEGMENTS)
def test_traceprobe_segments_on_the_cpu(which, tiny_model, capsys):
    s = traceprobe.main([which, "--batch", "1", "--max_new", "2", "--top",
                         "3"], model=tiny_model)
    assert 0 < s["device_total_ms"] <= s["wall_ms"]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert list(lines[0]) == ["device_total_ms", "trace", "wall_ms"]
    assert len(lines) == 4 and all(set(x) == {"op", "ms", "n", "pct"}
                                   for x in lines[1:])


@pytest.mark.parametrize("which, kw", [
    ("tg", dict(batch=2, flow_len=4)), ("ivt", dict(micro=1, accum=2)),
    ("sf", dict(batch=2, flow_len=4))])
def test_traintraceprobe_steps_on_the_cpu(which, kw):
    r = traintraceprobe.main([which, "--preset", "tiny", "--device", "cpu",
                              "--top", "2"], **kw)
    # a warm step, two traced and one timed, the state threaded through
    assert r["state_step"] == 4 and np.isfinite(r["loss"])
    assert 0 < r["device_total_ms"] <= r["wall_ms"] and r["step_ms"] > 0


# ---------------------------------------------------------- decode probe
def test_decode_copies_match_bench(tmp_path):
    import bench

    ours, theirs = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    decodeprobe.make_synthetic_video(ours, num_frames=20, size=48)
    bench.make_synthetic_video(theirs, num_frames=20, size=48)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got = decodeprobe.decode_clip_uint8(ours, 6, 3, 32, 24)
    want = bench.decode_clip_uint8(ours, 6, 3, 32, 24)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_decodeprobe_main():
    out = decodeprobe.main(["--clips", "1", "--res", "32", "--frames", "12",
                            "--num_frames", "4", "--image", "16", "--flow",
                            "16"])
    assert set(out) == {"current", "readonly", "direct224_linear",
                        "direct224_area", "read_video_cv2"}
    assert all(v > 0 for v in out.values())


# ------------------------------------------------------------ perf probe
def test_perfprobe_vit_variants_agree():
    rows = perfprobe.vit_probe(2, 1, 20, torch.device("cpu"), iters=1,
                               width=64, heads=4, ff=128)
    names = [r["probe"] for r in rows]
    assert names == ["vit_A_current", "vit_B_einsum_bhsd", "vit_C_fused_qkv",
                     "vit_D_sdpa_bshd", "matmul_mlp_only"]
    # one bf16 layer (activations ~1): B, C and D round their products in
    # another order; 2^-4 is 4 bf16 ulps at 2
    for r in rows[1:4]:
        assert r["max_abs_vs_a"] <= 2 ** -4, r
    # the CLI at ViT-g's widths, one layer over 8 tokens
    rows = perfprobe.main(["vit", "--batch", "1", "--layers", "1", "--seq",
                           "8", "--iters", "1", "--device", "cpu"])
    assert [r["probe"] for r in rows] == names
    for r in rows[1:4]:
        assert r["max_abs_vs_a"] <= 2 ** -4, r


def test_perfprobe_raft_model_and_pipe(tiny_model):
    cpu = torch.device("cpu")
    raft = perfprobe.raft_probe(1, cpu, iters=1, res=32)
    assert [r["probe"] for r in raft] == ["raft_full", "raft_fnet_both",
                                          "raft_corr_build"]
    assert perfprobe.model_probe(1, cpu, iters=1, preset="tiny")[0]["ms"] > 0
    pipe = perfprobe.pipe_probe(1, cpu, max_new=2, iters=1, model=tiny_model)
    assert [r["probe"] for r in pipe] == [
        "pipe_raft_flow", "pipe_vit_qformer", "pipe_prepare_all",
        "pipe_t5_decode", "pipe_full"]


# ---------------------------------------------------- attention and RAFT
def test_qformerattnprobe_variants_agree():
    out = qformerattnprobe.main(["--frames", "1", "--layers", "1", "--iters",
                                 "1", "--device", "cpu"])
    assert len(out) == 6
    # b computes a's f32 scores by einsum; c is kernel A's plain version on
    # the CPU, a's own function: equal to a's rounding
    for (tag, variant), r in out.items():
        assert r["max_abs_vs_a"] <= (0.0 if variant in "ac" else 2 ** -6), \
            (tag, variant, r)


def test_raftencprobe_rewrites_are_exact():
    out = raftencprobe.main(["--fnet", "1", "--cnet", "1", "--res", "32",
                             "--iters", "1", "--device", "cpu"])
    # one-pass and two-pass variances of the same f32 sums; the stem's
    # rewrite sums the same 147 products in another order (bf16 outputs of
    # size ~1: one ulp 2^-8)
    assert out["inorm_maxdiff"] <= 2 ** -6
    assert out["stem_s2d_maxdiff"] <= 2 ** -7
    assert [k for k in out if k.startswith("prefix_")] == [
        "prefix_stem", "prefix_layer1", "prefix_layer2", "prefix_layer3",
        "prefix_head"]


def test_stemprobe_variants_agree():
    out = stemprobe.main(["--batch", "2", "--res", "16", "--iters", "1",
                          "--device", "cpu"])
    assert list(out) == ["direct", "im2col", "patches49"]
    # bf16 products of 147 terms, f32 accumulation in another order, one
    # bf16 rounding of outputs of size ~1 (2^-8) and one more of the sum
    for r in out.values():
        assert r["max_abs_err"] <= 2 ** -6, r


# ----------------------------------------------------------------- sweeps
def _stub(fail_on=None):
    def train_fn(overrides):
        kv = dict(o.split("=", 1) for o in overrides)
        if kv.get("data.batch_size") == fail_on:
            raise RuntimeError("trial fails")
        return {"val/m": float(kv["model.lr"]) * 1e3
                - float(kv.get("data.batch_size", 0))}
    return train_fn


@pytest.mark.parametrize("sampler, mode", [("tpe", "max"), ("tpe", "min"),
                                           ("random", "max")])
def test_run_sweep_matches_jax(sampler, mode):
    from videotgb_tpu.utils import sweep as JS

    specs = {"model.lr": "loguniform(1e-5,1e-3)",
             "data.batch_size": "choice(2,4,8)", "seed": "3"}
    runs = [m.run_sweep(["experiment=x"],
                        {k: m.parse_space(v) for k, v in specs.items()},
                        trials=8, metric="val/m", mode=mode, seed=5,
                        train_fn=_stub(fail_on="8"), sampler=sampler)
            for m in (sweep, JS)]
    assert runs[0] == runs[1]
    assert any("error" in h for h in runs[0]["history"])


def test_parse_space_and_tpe_suggest_match_jax():
    from videotgb_tpu.utils import sweep as JS

    for spec in ("choice(1e-4,2e-4)", "choice(a, b,3)", "uniform(0.1,0.9)",
                 "loguniform(1e-5,1e-3)", "0.5", "adamw"):
        assert (sweep.parse_space(spec).__dict__
                == JS.parse_space(spec).__dict__)
    specs = {"a": "uniform(0,1)", "b": "loguniform(1e-4,1e-1)",
             "c": "choice(x,y,z)", "d": "7"}
    rng = random.Random(0)
    completed = [{"params": {"a": rng.random(), "b": 10 ** -rng.uniform(1, 4),
                             "c": rng.choice("xyz"), "d": 7},
                  "value": rng.random()} for _ in range(9)]
    for n in (2, 9):
        got = [sweep.tpe_suggest({k: sweep.parse_space(v)
                                  for k, v in specs.items()},
                                 completed[:n], random.Random(s))
               for s in range(4)]
        want = [JS.tpe_suggest({k: JS.parse_space(v)
                                for k, v in specs.items()},
                               completed[:n], random.Random(s))
                for s in range(4)]
        assert got == want


def test_sweep_multirun_subdirs_through_train(tmp_path, monkeypatch):
    """Two trials of the tiny TG recipe on the CPU: one dated sweep dir,
    trials in ``<sweep_dir>/0`` and ``/1`` with their job logs, every trial
    finished."""
    monkeypatch.chdir(tmp_path)
    result = sweep.main([
        "--trials", "2", "--sampler", "random", "--metric", "val/iou_score",
        "--output", str(tmp_path / "sweep.json"),
        "experiment=smoke_tg_synthetic", "trainer=cpu",
        f"paths.root_dir={tmp_path}/run",
        "sweep.model.optimizer.lr=choice(1e-4,2e-4)"])
    assert all("value" in h for h in result["history"]), result
    assert json.loads((tmp_path / "sweep.json").read_text())["metric"] == \
        "val/iou_score"
    multirun_root = tmp_path / "run" / "logs" / "train" / "multiruns"
    sweeps = [p for p in multirun_root.iterdir() if p.is_dir()]
    assert len(sweeps) == 1, "trials scattered across sweep dirs"
    subdirs = sorted(p.name for p in sweeps[0].iterdir() if p.is_dir())
    assert subdirs == ["0", "1"]
    for sub in subdirs:
        assert (sweeps[0] / sub / "train.log").exists()
        assert (sweeps[0] / sub / ".hydra" / "overrides.yaml").exists()


def test_task_wrapper_logs_the_error_and_closes(tmp_path):
    from videotgb_torch.config import Config
    from videotgb_torch.utils.task import task_wrapper

    closed = []

    @task_wrapper
    def task(cfg):
        raise ValueError("boom")

    task._closers.append(lambda: closed.append(1))
    cfg = Config({"paths": Config({"output_dir": str(tmp_path / "out")})})
    with pytest.raises(ValueError, match="boom"):
        task(cfg)
    assert closed == [1]
    assert "ValueError: boom" in (tmp_path / "out" / "error.log").read_text()


# ---------------------------------------------- judge debug and tokenizer
def test_stats_from_combined_matches_jax(tmp_path):
    from videotgb_torch.evalsuite import debug as TD
    from videotgb_tpu.evalsuite import debug as JD

    combined = {"1": [{"pred": "Yes", "score": 4}, {"q": "?"}],
                "2": [{"pred": "no way", "score": "2"}, {}],
                "3": [{"pred": "maybe", "score": 3}, {}],
                "4": [{"pred": "yes"}, {}],
                "5": [{"score": "x", "pred": "no"}, {}]}
    path = tmp_path / "combined.json"
    path.write_text(json.dumps(combined))
    want = JD.stats_from_combined(str(path))
    assert TD.stats_from_combined(str(path)) == want
    assert TD.main(["--combined", str(path)]) == want
    judged = tmp_path / "judged"
    judged.mkdir()
    for k, v in combined.items():
        (judged / f"{k}.json").write_text(json.dumps(v))
    assert TD.main(["--output_dir", str(judged)]) == JD.main(
        ["--output_dir", str(judged)])


def test_build_llama_tokenizer_is_byte_equal(tmp_path):
    pytest.importorskip("tokenizers")
    from videotgb_torch.tools import build_llama_tokenizer as TB
    from videotgb_tpu.tools import build_llama_tokenizer as JB

    ours = TB.build(str(tmp_path / "ours.json"))
    theirs = JB.build(str(tmp_path / "theirs.json"))
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    assert data == open(TB.ASSET, "rb").read()
    assert TB.ASSET.endswith("videotgb_torch/data/assets/llama_tokenizer.json")
