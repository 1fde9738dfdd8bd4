"""videotgb_torch's sequence parallelism (``parallel/sequence.py``, the
``sp`` axis of ``trainer=sp``, ``ServingEngine(mesh=...)`` and
``run_inference --mesh``) against videotgb_tpu's ``constrain_batch`` and
its programs at world 1, tiny f32.

Pure parts: the ``("dp", "fsdp", "tp", "sp")`` rank layout against JAX's
``create_mesh``; the split rule against ``constrain_batch``'s placement on
an 8-device CPU mesh; T5's bias rows for a rank's queries; the flash
dispatch on the global query count; the layouts that still raise.

One 4-process gloo run (``tests/_torch_sp_worker.py``, at most
``TIMEOUT_S``, every process killed on expiry): SF, E2E, TG and
InstructBLIP-Vicuna IV steps at ``dp=2, sp=2`` gradient by gradient,
``generate_blip2``, the engine and the QA CLI at ``tp=2, sp=2`` and
``dp=2, sp=2``, and the training CLI at ``trainer=sp trainer.dp=2``,
against the JAX package at world 1 (which its own
``tests/test_sequence_parallel.py`` holds equal to its sp mesh) and the
port at world 1, each run's splits and gathers counted tower by tower;
the references run in the test's process while the ranks run.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_port_helpers import TOL, few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.models import common as TC
from videotgb_torch.models.t5 import RelativePositionBias, T5Config
from videotgb_torch.parallel import distributed as TDI
from videotgb_torch.parallel import mesh as TM
from videotgb_torch.parallel.sequence import SPGroup
from videotgb_tpu.parallel import mesh as JM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sp_worker.py")
TIMEOUT_S = 150
L = 4  # flow pairs: the TGB stream's L + 2 = 6 tokens split over sp = 2
MESHES = ("tp=2,sp=2", "dp=2,sp=2")


# ------------------------------------------------------------ pure parts
@pytest.mark.parametrize("axes,n", [
    (dict(dp=2, sp=2), 4), (dict(dp=1, tp=2, sp=2), 4),
    (dict(dp=2, tp=2, sp=2), 8), (dict(dp=-1, sp=4), 8),
    (dict(dp=1, sp=2), 2)])
def test_mesh_layout_with_sp_is_the_jax_mesh(axes, n):
    """The ranks of the port's (dp, fsdp, tp, pp, sp) mesh sit where JAX's
    ``create_mesh`` puts the devices of its mesh: ``sp`` innermost, so the
    sp ranks of one dp x fsdp x tp x pp position are consecutive."""
    import jax

    want = JM.create_mesh(JM.MeshConfig(**axes), jax.devices()[:n]).devices
    ids = np.vectorize(lambda d: d.id)(want)
    got = TM.mesh_layout(TM.MeshConfig(**axes), n)
    assert ids.shape[3] == 1  # pp
    np.testing.assert_array_equal(got, ids)


@pytest.mark.parametrize("shape", [(4, 8, 16), (4, 5, 16), (4, 1, 16)])
def test_the_split_rule_is_constrain_batchs(shape):
    """A stream splits where the JAX constraint puts its token axis on
    ``sp`` (``tests/test_sequence_parallel.py``'s three cases at sp = 4:
    T divisible, T = 5, a decode step's T = 1); at sp = 1 nothing does."""
    import jax
    import jax.numpy as jnp

    from videotgb_tpu.parallel.sharding import constrain_batch

    mesh = JM.create_mesh(JM.MeshConfig(dp=2, fsdp=1, tp=1, sp=4))
    with mesh:
        spec = jax.jit(constrain_batch)(jnp.ones(shape)).sharding.spec
    jax_splits = len(spec) >= 2 and spec[1] == "sp"
    assert SPGroup(1, 4, None).splits(torch.ones(shape)) == jax_splits
    assert jax_splits == (shape[1] == 8)
    assert not SPGroup(0, 4, None).splits(torch.ones(shape[:2]))


def test_t5_bias_rows_for_a_ranks_queries_are_the_whole_bias_rows():
    """``RelativePositionBias`` at a rank's query positions against every
    key is that rank's rows of the whole (1, heads, S, S) bias, for both
    stacks and each rank of sp = 2 and 4 (made for its queries, not a
    strided slice of the whole)."""
    cfg = T5Config.tiny()
    gen = torch.Generator().manual_seed(0)
    s = 24
    pos = torch.arange(s)
    for bidirectional in (True, False):
        rel = RelativePositionBias(cfg, bidirectional, device="cpu")
        rel.reset_parameters_from(gen)
        whole = rel(pos, pos)
        for size in (2, 4):
            for rank in range(size):
                sp = SPGroup(rank, size, None)
                rows = rel(sp.positions(s), pos)
                n = s // size
                assert torch.equal(rows, whole[:, :, rank * n:(rank + 1) * n])


def test_split_queries_take_the_flash_route_on_the_global_count(monkeypatch):
    """The dispatch reads the global query count, as the JAX rule does on
    its global shapes: E2E's flagship T5 encoder (160 tokens) at sp = 2
    hands a rank's 80 queries over 160 keys to ``flash_attention`` (kernel
    A on the card), where 80 x 160 alone would go plain; its serving
    encoder (96 tokens) goes plain, split or not."""
    seen = []
    flash, plain = TC.flash_attention, TC.dot_product_attention
    monkeypatch.setattr(TC, "flash_attention", lambda q, k, *a, **kw: (
        seen.append("flash") or flash(q, k, *a, **kw)))
    monkeypatch.setattr(TC, "dot_product_attention", lambda q, k, *a, **kw: (
        seen.append("plain") or plain(q, k, *a, **kw)))
    attn = TC.MultiHeadAttention(16, 2, 8, device="cpu")
    TC.init_params(attn, 0)
    for tokens, want in ((160, "flash"), (96, "plain")):
        x = torch.randn((1, tokens, 16))
        local = x[:, :tokens // 2]
        for sp, route in ((SPGroup(0, 2, None), want), (None, "plain")):
            seen.clear()
            attn(local, x_kv=x, sp=sp)
            assert seen == [route], (tokens, sp)


def test_sp_layouts_that_still_raise_name_their_items():
    """``sp`` builds in training and serving; beside an ``fsdp`` above 1 it
    raises naming ROADMAP.md queue 1 item 4, as ``pp`` names item 5."""
    for serving in (False, True):
        TM.check_ported(TM.MeshConfig(dp=2, sp=2), serving=serving)
        TM.check_ported(TM.MeshConfig(dp=1, tp=2, sp=2), serving=True)
        with pytest.raises(NotImplementedError, match="item 4"):
            TM.check_ported(TM.MeshConfig(dp=1, fsdp=2, sp=2),
                            serving=serving)
    with pytest.raises(NotImplementedError, match="item 4"):
        TM.check_ported(TM.MeshConfig(dp=1, tp=2, sp=2))  # tp training
    with pytest.raises(ValueError, match="device count"):
        TM.create_mesh(TM.MeshConfig(dp=1, sp=2))  # past the refusals


# --------------------------------------------------- the four-process run
def sp_inputs(qa) -> dict:
    """The run's inputs, from seeds: a training batch of 4 rows with SF's
    scores and TG's spans, a generate batch of 4 rows, Gumbel noise for
    each, 3 engine requests with noise for their batches, 3 mp4 clips and
    their questions (one without a clip) with the JAX CLI's draws for its
    batches, and the port's tiny f32 config."""
    import cv2
    import jax

    from _torch_port_helpers import jax_tiny_f32, torch_tiny_f32
    from videotgb_torch.data.datasets import pack_text_input_output

    rng = np.random.default_rng(5)
    jcfg = jax_tiny_f32()
    img, fs, b = jcfg.blip2.vit.image_size, jcfg.tgb.flow_size, 4

    def ids(n):
        return rng.integers(4, 60, (b, n)).astype(np.int32)

    common = {
        "frames": rng.standard_normal((b, jcfg.num_frames, img, img, 3)),
        "flow": rng.standard_normal((b, L, fs, fs, 2)),
        "flow_mask": np.ones((b, L + 2)),
        "video_length": np.full((b,), L, np.int32),
        "sampler_question_ids": ids(8), "sampler_question_mask": np.ones(
            (b, 8)),
        "question_ids": ids(6),
        "question_mask": np.array([[1.0] * 6, [1.0] * 4 + [0.0] * 2] * 2)}
    common = {k: v.astype(np.float32) if v.dtype == np.float64 else v
              for k, v in common.items()}
    answers = ids(6)
    answers[0, 4:] = 0
    train = dict(common, answer_ids=answers,
                 scores=rng.random((b, jcfg.num_frames)).astype(np.float32),
                 starts=np.array([0, 1, 2, 0], np.int32),
                 ends=np.array([2, L, 3, 1], np.int32))

    def gumbel(rows=b):
        return rng.gumbel(size=(jcfg.top_k, 2, rows, L)).astype(np.float32)

    requests = [(rng.integers(0, 255, (jcfg.num_frames, img, img, 3),
                              np.uint8),
                 rng.integers(0, 255, (L + 1, fs, fs, 3), np.uint8),
                 question) for question in ("what happens?", "", "why " * 30)]
    videos = qa / "videos"
    videos.mkdir(parents=True)
    for name in ("vid_a", "vid_b", "vid_c"):
        writer = cv2.VideoWriter(str(videos / f"{name}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                                 (64, 64))
        for _ in range(20):
            writer.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
        writer.release()
    names = ("vid_a", "vid_b", "missing", "vid_c")
    (qa / "q.json").write_text(json.dumps([
        {"video_name": n, "question": f"what is in {n}", "question_id": n}
        for n in names]))
    (qa / "a.json").write_text(json.dumps([{"answer": n} for n in names]))
    icfg = jax_tiny_f32("instructblip")
    inst_ids, inst_mask, labels = pack_text_input_output(
        [ids(6)[0, :n].tolist() for n in (6, 4, 5, 6)],
        [ids(5)[0, :n].tolist() for n in (3, 5, 2, 4)], 10, 0)
    # Vicuna's stream: 8 query tokens and the 10 of the packed text
    iv = {"frames": rng.standard_normal(
              (b, icfg.nframe, img, img, 3)).astype(np.float32),
          "qformer_input_ids": ids(5),
          "qformer_attention_mask": np.array([[1] * 5, [1] * 3 + [0] * 2]
                                             * 2, np.int32),
          "instruction_ids": inst_ids, "instruction_mask": inst_mask,
          "labels": labels}
    key = jax.random.key(0)
    return {
        "train_batch": train, "train_noise": gumbel(),
        "iv_batch": iv, "iv_cfg": torch_tiny_f32("instructblip"),
        "batch": common, "noise": gumbel(),
        "decode": dict(max_new_tokens=4, eos_token_id=1, pad_token_id=0),
        "requests": requests,
        "engine_noise": [gumbel(2) for _ in requests],
        "cli": {"video_dir": str(videos), "questions": str(qa / "q.json"),
                "answers": str(qa / "a.json"),
                "noise": {start: np.asarray(jax.random.gumbel(
                    jax.random.split(jax.random.fold_in(key, start))[0],
                    (jcfg.top_k, 2, 2, L)), np.float32)
                    for start in (0, 2)}},
        "torch_cfg": torch_tiny_f32()}


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """Writes the seeded weights as a port checkpoint, starts the four
    ranks, computes the references at world 1 here meanwhile (the JAX SF
    step, ``generate_blip2`` and QA CLI, the port's training CLI), and
    waits for the ranks at most TIMEOUT_S."""
    from _torch_port_helpers import jax_tiny_f32
    from _torch_sp_worker import (cli_references, generate_reference,
                                  step_reference, write_checkpoint)
    from videotgb_tpu.models import videotgb as JV

    d = tmp_path_factory.mktemp("sp")
    (d / "ckpt").mkdir()
    sp_in = sp_inputs(d / "qa")
    with open(d / "sp_in.pkl", "wb") as f:
        pickle.dump(sp_in, f)
    jcfg, icfg = jax_tiny_f32(), jax_tiny_f32("instructblip")
    jmodel, imodel = JV.VideoTGB(jcfg), JV.VideoTGB(icfg)
    tree = write_checkpoint(jmodel, jcfg, str(d / "ckpt"))
    itree = write_checkpoint(imodel, icfg, str(d / "ckpt"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = TDI.free_port()
    args = [str(d / "sp_in.pkl"), str(d / "ckpt")]
    cmds = [([sys.executable, WORKER, "--rank", *args, str(d / "out.pt")],
             dict(RANK=str(r), WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=str(port))) for r in range(4)]
    procs = [subprocess.Popen(cmd, env=dict(env, **extra), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd, extra in cmds]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        ref = {"sf": step_reference(jmodel, tree, "sf", sp_in["train_batch"],
                                    sp_in["train_noise"]),
               "iv": step_reference(imodel, itree, "iv", sp_in["iv_batch"]),
               "generate": generate_reference(jmodel, jcfg, tree, sp_in),
               **cli_references(sp_in, str(d / "ckpt"))}
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode()[-3000:]
    return {"out": torch.load(d / "out.pt", weights_only=False), "ref": ref,
            "sp_in": sp_in}


def assert_split(calls, cfg, towers, n=None, what="", tgb_mode="fusion"):
    """``calls`` (``_torch_sp_worker.SPCalls.take``) split the streams of
    ``towers`` (keys such as "T5Model.encode") and no others, ``n`` times
    each where given, and gathered each split stream once per
    self-attention layer it passed (the TGB's layers of ``tgb_mode``) and
    once at its end."""
    tgb = cfg.tgb
    layers = {"TGBModel.forward": tgb.num_layers - (
                  tgb.fusion_layer if tgb_mode == "fusion" else 0),
              "T5Model.encode": getattr(cfg.blip2, "t5", None)
              and cfg.blip2.t5.num_encoder_layers,
              "T5Model.decode": getattr(cfg.blip2, "t5", None)
              and cfg.blip2.t5.num_decoder_layers,
              "LlamaModel.forward": cfg.instructblip
              and cfg.instructblip.llm.num_layers}
    assert set(calls["split"]) == set(towers), (what, calls)
    assert set(calls["gather"]) == set(towers), (what, calls)
    for tower in towers:
        if n is not None:
            assert calls["split"][tower] == n, (what, tower, calls)
        assert calls["gather"][tower] == (
            calls["split"][tower] * (layers[tower] + 1)), (what, tower, calls)


def test_sequence_parallel_runs_match_world_1(sp_run):
    """The four ranks' work against world 1 (one test: under ``--dist
    load`` every worker that takes a test of the run would start its
    processes).

    * Training at ``dp=2, sp=2``: the SF step's loss and mrc loss within
      2e-4 and its trainable grad norm and each trainable gradient's sum
      of squares within 2e-3 of the JAX step's at world 1
      (``tests/test_sequence_parallel.py``'s tolerances); the E2E ("tgb")
      and TG steps, dropout on, within 2e-4 of the port's world-1 steps in
      loss, grad norm, each gradient and each trained tensor (Adam's first
      update reads a gradient's sign, not its scale: the gradients are
      what shows a leaf that lacks an sp rank's share); the IV step of
      InstructBLIP-Vicuna (no dropout, no draw) within 2e-4 of the JAX IV
      step's loss, grad norm and gradients; the trainable
      tensors equal on every rank; the route names the eager gloo step.
    * Every sp run split the streams it should and no others: the TGB's,
      the T5 encoder's and teacher-forced decoder's, and Vicuna's forward
      without caches, each split once a forward and gathered once for each
      self-attention layer and once at its end; the world-1 runs split
      nothing.
    * ``generate_blip2`` at ``tp=2, sp=2`` and ``dp=2, sp=2`` with the same
      noise as the JAX program: frames and tokens equal, the first decode
      step's logits within 2e-4, each rank's equal to the others of its
      position.
    * A T5 encoder pass of 160 tokens split over sp = 2 takes the flash
      route at 80 x 160 in every layer, as whole at 160 x 160; 96 tokens
      go plain either way; the output equals the whole pass's.
    * The engine at ``tp=2,sp=2`` and ``dp=2,sp=2``: the world-1 engine's
      frames and answers for each request, an eager route naming sp, and
      an answer through rank 0's HTTP server.
    * ``run_inference --mesh`` at both meshes: the JAX CLI's JSONL at
      world 1, with its draws.
    * ``train.main`` at ``trainer=sp trainer.dp=2``: the world-1 CLI's
      final metrics within 2e-4."""
    out, ref = sp_run["out"], sp_run["ref"]
    cfg, icfg = sp_run["sp_in"]["torch_cfg"], sp_run["sp_in"]["iv_cfg"]
    tgb, t5 = "TGBModel.forward", ("T5Model.encode", "T5Model.decode")
    steps = out["steps"]
    for case in ("sf", "iv"):
        got = steps[case, "sp"]["metrics"]
        for k in ("loss", "mrc_loss") if case == "sf" else ("loss",):
            np.testing.assert_allclose(got[k], ref[case][k], rtol=2e-4,
                                       err_msg=(case, k))
        rtol = 2e-3 if case == "sf" else 2e-4
        np.testing.assert_allclose(got["grad_norm"], ref[case]["grad_norm"],
                                   rtol=rtol, err_msg=case)
        for leaf, value in steps[case, "sp"]["grads"].items():
            np.testing.assert_allclose(value, ref[case]["grads"][leaf],
                                       rtol=rtol, atol=2e-4,
                                       err_msg=(case, leaf))
    for case, towers in (("sf", (tgb, *t5)), ("e2e", (tgb, *t5)),
                         ("tg", (tgb,))):
        assert_split(steps[case, "sp"]["calls"], cfg, towers, 1, case,
                     "multi_modal" if case == "e2e" else "fusion")
    assert_split(steps["iv", "sp"]["calls"], icfg, ("LlamaModel.forward",),
                 1, "iv")
    for case in ("e2e", "tg"):
        assert_split(steps[case, "world1"]["calls"], cfg, (), what=case)
    for case in ("e2e", "tg"):
        got, want = steps[case, "sp"], steps[case, "world1"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       err_msg=(case, k), **TOL)
        for what in ("grads", "trained"):
            assert got[what].keys() == want[what].keys()
            for name, value in got[what].items():
                np.testing.assert_allclose(value, want[what][name],
                                           err_msg=(case, what, name), **TOL)
        assert got["route"] == "dp" and "sp" in got["step_route"]
    ranks = out["ranks"]
    for case in ("sf", "e2e", "tg", "iv"):
        assert all(r["steps"][case, "sp"]["trained"]
                   == steps[case, "sp"]["trained"] for r in ranks), case

    want = ref["generate"]
    for i, mesh in enumerate(MESHES):
        # generate_blip2's pass and the first logits' (a second select and
        # encode); the decode steps are T5's cached ones, whole
        assert_split(out["generate"][mesh]["calls"], cfg,
                     (tgb, "T5Model.encode"), 2, mesh)
        rows = [r["generate"][mesh] for r in ranks]
        copies = 4 if mesh.startswith("tp") else 2
        for name in ("tokens", "cand", "logits"):
            parts = [rows[p * copies][name] for p in range(4 // copies)]
            got = torch.cat(parts).numpy()
            if name == "logits":
                np.testing.assert_allclose(got, want[name], err_msg=mesh,
                                           **TOL)
            else:
                np.testing.assert_array_equal(got, want[name], err_msg=mesh)
            for r, row in enumerate(rows):
                assert torch.equal(row[name], rows[r - r % copies][name]), (
                    mesh, name, r)

    routes = out["routes"]
    for name in ("whole", "split"):
        q = 160 if name == "whole" else 80
        assert routes[160, name]["routes"] == [("flash", q, 160)] * 2
        assert {r[0] for r in routes[96, name]["routes"]} == {"plain"}
    for tokens in (160, 96):
        np.testing.assert_allclose(routes[tokens, "split"]["enc"].numpy(),
                                   routes[tokens, "whole"]["enc"].numpy(),
                                   **TOL)

    assert_split(out["engine", "world1"]["calls"], cfg, ())
    for mesh in MESHES:
        assert out["engine", mesh]["replies"] == \
            out["engine", "world1"]["replies"], mesh
        assert "split over sp" in out["engine", mesh]["route"]
        # a batch a request (each is awaited before the next), and the
        # HTTP request at the first mesh
        assert_split(out["engine", mesh]["calls"], cfg,
                     (tgb, "T5Model.encode"),
                     len(sp_run["sp_in"]["requests"]) + (mesh == MESHES[0]),
                     mesh)
    assert set(out["http"]) == {"answer", "selected_frames", "latency_ms"}

    for mesh in MESHES:
        cli = out["cli", mesh]
        assert cli["starts"] == [0, 2]
        rows = [json.loads(line) for line in cli["rows"].splitlines()]
        assert [r["id"] for r in rows] == ["vid_a", "vid_b", "vid_c"]
        assert cli["rows"] == ref["cli"], mesh
        assert_split(cli["calls"], cfg, (tgb, "T5Model.encode"), 2, mesh)

    assert_split(out["train_cli_calls"], cfg, (tgb,), what="train_cli")
    got, want = out["train_cli"], ref["train_cli"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)

