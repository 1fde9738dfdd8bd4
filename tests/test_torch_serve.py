"""The port's serving engine (``videotgb_torch.serve``) on the CPU: against
the JAX package's engine with the same weights and the same Gumbel draws
(identical frames and answers, request by request), the behaviour that
``tests/test_serve.py`` asks of the JAX engine, the HTTP routes, and what
the port refuses.

Both engines serve the tiny f32 configuration: each package's
``VideoTGBConfig.tiny`` is swapped for its f32 form for this module, the
JAX engine gets numpy weights from a seed in place of flax's init
(``_torch_port_helpers.jax_load_model_seeded``), and its parameters are
carried into the port's model with ``videotgb_torch.convert``. The JAX engine's selection key of each batch is
captured and its Gumbel draws handed to the port's ``select_frames``, as
``tests/test_torch_pipeline.py::_noise`` does."""

import contextlib
import dataclasses
import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401
    f32_tiny_presets,
    few_torch_threads,
    gumbel_like,
    jax_load_model_seeded,
)
from videotgb_torch import serve as TS
from videotgb_torch.convert import load_flax_params
from videotgb_torch.device import step_generator
from videotgb_torch.evalsuite.inference import load_model
from videotgb_torch.models import videotgb as TV

ENGINE = dict(preset="tiny", batch_size=2, flow_frames=3, max_new_tokens=4,
              max_delay_ms=200.0, bf16_params=False)


@contextlib.contextmanager
def engine_pair(backbone="blip2"):
    """(JAX engine, port engine, selection keys) of ``backbone``: the JAX
    engine's keys are queued as it selects, and the port's next selection
    takes the next one (none queued: the port draws from its own
    generator)."""
    from videotgb_tpu.evalsuite import inference as jinference
    from videotgb_tpu.serve import ServingEngine

    with pytest.MonkeyPatch.context() as mp:
        f32_tiny_presets(mp)
        mp.setattr(jinference, "load_model", jax_load_model_seeded)
        jeng = ServingEngine("random:tiny", backbone=backbone, **ENGINE)
        peng = TS.ServingEngine("random:tiny", backbone=backbone,
                                device="cpu", **ENGINE)
        load_flax_params(peng.model, jax.device_get(jeng.params))
        keys = []
        select = jeng._select

        def jax_select(p, flow_u8, bd, key):
            keys.append(key)
            return select(p, flow_u8, bd, key)

        jeng._select = jax_select
        choose = peng.model.select_frames

        def port_select(start_logits, end_logits, video_length,
                        generator=None, **kw):
            if keys:
                kw["noise"] = gumbel_like(keys.pop(0), start_logits,
                                          peng.cfg.top_k)
            return choose(start_logits, end_logits, video_length, generator,
                          **kw)

        mp.setattr(peng.model, "select_frames", port_select)
        try:
            yield jeng, peng, keys
        finally:
            jeng.close()
            peng.close()


@pytest.fixture(scope="module")
def engines():
    with engine_pair() as pair:
        yield pair


def _inputs(eng, seed=0):
    rng = np.random.default_rng(seed)
    image = eng.cfg.vit.image_size
    fs = eng.cfg.tgb.flow_size
    frames = rng.integers(0, 255, (eng.cfg.num_frames, image, image, 3),
                          np.uint8)
    flow = rng.integers(0, 255, (eng.flow_frames + 1, fs, fs, 3), np.uint8)
    return frames, flow


def _request_by_request(jeng, peng, keys, n=4):
    """One request at a time (each its own batch, padded by repeating it):
    the same frames and the same answer from both engines."""
    assert not keys
    for i in range(n):
        frames, flow = _inputs(peng, seed=100 + i)
        question = ["what happens?", "who is there", "", "why " * 30][i]
        want = jeng.submit(frames, flow, question).result(timeout=600)
        assert len(keys) == 1
        got = peng.submit(frames, flow, question).result(timeout=600)
        assert not keys
        assert got.selected_frames == want.selected_frames, i
        assert got.answer == want.answer, i


def test_engine_matches_the_jax_engine_request_by_request(engines):
    _request_by_request(*engines)


def test_instructblip_engine_matches_the_jax_engine():
    """InstructBLIP-Vicuna: TGB "multi_modal" with the "ratio" rule, the
    instruction-aware Q-Former reading the question, a decoder-only answer
    with Vicuna's eos / pad; right-padded prompts of different lengths."""
    with engine_pair("instructblip") as (jeng, peng, keys):
        assert peng.decoder_only and peng.decode_config.eos_token_id == 2
        _request_by_request(jeng, peng, keys, n=3)


class Batches:
    """Records each batch the engine selects: its step and padded requests
    (``host_batch`` and ``step_generator`` wrapped for the duration)."""

    def __init__(self, engine, mp):
        self.engine, self.steps, self.padded = engine, [], []
        host_batch = engine.host_batch

        def record_batch(padded):
            self.padded.append(list(padded))
            return host_batch(padded)

        mp.setattr(engine, "host_batch", record_batch)
        mp.setattr(TS, "step_generator", lambda s, k, d: (
            self.steps.append(k) or step_generator(s, k, d)))

    def check(self, futures, frames_of):
        """Every request of every recorded batch got the frames and the
        answer that ``select_phase_blip2`` + gather +
        ``answer_phase_blip2`` give its row when called directly on the
        same padded batch with the generator of that step. Returns the
        rows' replies, batch by batch."""
        eng = self.engine
        assert len(self.steps) == len(self.padded)
        out = []
        for step, padded in zip(self.steps, self.padded):
            flow_u8, bd = eng.host_batch(padded)
            cand = TV.select_phase_blip2(
                eng.model, flow_u8, bd,
                generator=step_generator(eng.seed, step, eng.device))
            sel = torch.from_numpy(np.stack(
                [frames_of[r.future][cand[i].numpy()]
                 for i, r in enumerate(padded)]))
            answers = eng.tok.batch_decode(TV.answer_phase_blip2(
                eng.model, sel, bd, eng.decode_config).numpy())
            rows = []
            for i, r in enumerate(padded):
                if i and r is padded[i - 1]:
                    continue  # a pad row: its noise is not the reply's
                reply = r.future.result(timeout=600)
                assert reply.selected_frames == cand[i].tolist(), (step, i)
                assert reply.answer == answers[i], (step, i)
                rows.append(reply)
            out.append(rows)
        assert {r.future for p in self.padded for r in p} == set(futures)
        return out


def test_engine_equals_direct_phase_calls(engines):
    """Batches served by the engine, a full one and a padded one among
    them, equal ``select_phase_blip2`` + gather + ``answer_phase_blip2``
    called directly on the same padded batches, row by row."""
    _, peng, keys = engines
    assert not keys
    inputs = [_inputs(peng, seed=s) for s in (5, 6, 7)]
    with pytest.MonkeyPatch.context() as mp:
        batches = Batches(peng, mp)
        futs = [peng.submit(f, fl, f"direct {i}?")
                for i, (f, fl) in enumerate(inputs)]
        for f in futs:
            f.result(timeout=600)
    assert sum(len(p) for p in batches.padded) == 4  # 3 requests, 1 pad
    batches.check(futs, {f: x[0] for f, x in zip(futs, inputs)})


def test_concurrent_requests_all_resolve(engines):
    _, engine, _ = engines
    futs = []
    for i in range(5):  # 5 requests, batch_size 2 -> >= 3 batches
        frames, flow = _inputs(engine, seed=i)
        futs.append(engine.submit(frames, flow, f"question {i}?"))
    replies = [f.result(timeout=600) for f in futs]
    assert len(replies) == 5
    for r in replies:
        assert isinstance(r.answer, str)
        assert len(r.selected_frames) == engine.cfg.nframe
        assert all(0 <= i < engine.cfg.num_frames for i in r.selected_frames)
        assert r.latency_ms > 0


def test_identical_requests_in_one_batch_agree(engines):
    """Identical requests get their rows' direct answers; each row draws
    its own Gumbel noise (as in the JAX engine), so two identical rows of
    one batch agree on the answer wherever they agree on the frames."""
    _, engine, _ = engines
    frames, flow = _inputs(engine, seed=42)
    with pytest.MonkeyPatch.context() as mp:
        batches = Batches(engine, mp)
        futs = [engine.submit(frames, flow, "same question?")
                for _ in range(2)]
        replies = [f.result(timeout=600) for f in futs]
    batches.check(futs, dict.fromkeys(futs, frames))
    if replies[0].selected_frames == replies[1].selected_frames:
        assert replies[0].answer == replies[1].answer


def test_single_request_pads_batch(engines):
    _, engine, _ = engines
    frames, flow = _inputs(engine, seed=7)
    r = engine.submit(frames, flow, "lonely request?").result(timeout=600)
    assert isinstance(r.answer, str)
    assert len(r.selected_frames) == engine.cfg.nframe


def test_failure_resolves_future(engines):
    """Malformed shapes surface as an exception on the future, not a hang,
    and the engine goes on serving."""
    _, engine, _ = engines
    bad = np.zeros((2, 4, 4, 3), np.uint8)
    fut = engine.submit(bad, bad, "bad?")
    with pytest.raises(Exception):
        fut.result(timeout=600)
    frames, flow = _inputs(engine, seed=8)
    assert engine.submit(frames, flow, "after?").result(timeout=600)


def test_engine_stats_have_the_jax_engine_keys(engines):
    jeng, engine, keys = engines
    frames, flow = _inputs(engine, seed=21)
    jeng.submit(frames, flow, "stats?").result(timeout=600)
    engine.submit(frames, flow, "stats?").result(timeout=600)
    assert not keys
    s, want = engine.stats(), jeng.stats()
    assert set(s) == set(want)
    assert set(s["phase_ms"]) == set(want["phase_ms"]) == set(TS.PHASES)
    assert s["served"] >= 1 and s["batches"] >= 1
    assert s["batch_size"] == engine.batch_size
    assert s["p50_ms"] > 0 and s["throughput_req_s"] > 0
    for name in TS.PHASES:
        pm = s["phase_ms"][name]
        assert pm["p50"] >= 0 and pm["p90"] >= pm["p50"]


def test_adaptive_assembly_skips_soak_when_idle():
    """With the answer stage idle and the queue empty, a request dispatches
    at once: the max_delay soak applies only while the pipe is busy."""
    eng = TS.ServingEngine("random:tiny", preset="tiny", batch_size=4,
                           flow_frames=3, max_new_tokens=2,
                           max_delay_ms=2000.0, device="cpu")
    try:
        frames, flow = _inputs(eng, seed=5)
        eng.submit(frames, flow, "solo?").result(timeout=600)
        t0 = time.perf_counter()
        eng.submit(frames, flow, "solo again?").result(timeout=600)
        warm_s = time.perf_counter() - t0
        assert warm_s < 1.9, f"idle-pipe request waited out the soak: {warm_s:.2f}s"
        assert eng.stats()["phase_ms"]["assembly"]["p50"] < 1900.0
    finally:
        eng.close()
    assert not eng._worker.is_alive() and not eng._answer_worker.is_alive()


def _multipart(fields: dict, boundary="xxBOUNDARYxx") -> bytes:
    out = b""
    for name, (value, filename) in fields.items():
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        out += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n"
                .encode() + value + b"\r\n")
    return out + f"--{boundary}--\r\n".encode()


def test_http_round_trip(engines, tmp_path):
    """/healthz, /v1/stats and a POST /v1/generate of a small mp4 on an
    ephemeral port; a request without a video part gets a 400."""
    import cv2

    _, engine, _ = engines
    path = str(tmp_path / "clip.mp4")
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (64, 64))
    for _ in range(12):
        writer.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
    writer.release()
    server = TS.make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        ctype = "multipart/form-data; boundary=xxBOUNDARYxx"
        body = _multipart({"video": (open(path, "rb").read(), "clip.mp4"),
                           "question": (b"what happens?", None)})
        req = urllib.request.Request(base + "/v1/generate", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            reply = json.loads(r.read())
        assert set(reply) == {f.name for f in dataclasses.fields(TS.Reply)}
        assert len(reply["selected_frames"]) == engine.cfg.nframe
        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            assert json.loads(r.read())["served"] >= 1
        bad = urllib.request.Request(
            base + "/v1/generate", headers={"Content-Type": ctype},
            data=_multipart({"question": (b"no video", None)}))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_bf16_residency_by_default_and_f32_opt_out():
    args = SimpleNamespace(model_path="random:tiny", bf16_params=True)
    model, _ = load_model(args, device="cpu")
    dtypes = {p.dtype for n, p in model.named_parameters()
              if not n.startswith("of_extractor")}
    assert dtypes == {torch.bfloat16}
    raft = {p.dtype for p in model.of_extractor.parameters()}
    assert raft == {torch.float32}  # RAFT stays f32, as in the JAX package
    args.bf16_params = False
    model, _ = load_model(args, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("kw, match", [
    (dict(mesh="dp=2,tp=2"), "queue 1 item 7"),
    (dict(mesh="dp=2,tp=2", backbone="instructblip"), "queue 1 item 7"),
    (dict(mesh="dp=2,tp=2", backbone="instructblip_t5"), "queue 1 item 7"),
])
def test_what_the_port_lacks_raises(kw, match, tmp_path):
    """The mesh engine raises; a checkpoint directory of
    ``videotgb_torch.train`` (which raised until its restore was ported) is
    served with its parameters, the model of ``preset``."""
    from videotgb_torch.training import checkpoint as TCK

    with pytest.raises(NotImplementedError, match=match):
        TS.ServingEngine("random:tiny", device="cpu", **kw)
    backbone = kw.get("backbone", "blip2")
    saved = TV.VideoTGB(TV.VideoTGBConfig.tiny(backbone), device="cpu",
                        seed=4).state_dict()
    TCK.CheckpointManager(TCK.CheckpointConfig(directory=str(tmp_path))).save(
        1, {"params": saved, "step": 1}, {"val/score": 0.5})
    eng = TS.ServingEngine(str(tmp_path), preset="tiny", backbone=backbone,
                           device="cpu", batch_size=1, flow_frames=3,
                           max_new_tokens=2, bf16_params=False)
    try:
        got = eng.model.state_dict()
        assert got.keys() == saved.keys()
        assert all(torch.equal(got[k], v) for k, v in saved.items())
        frames, flow = _inputs(eng, seed=5)
        assert eng.submit(frames, flow, "what?").result(timeout=600)
    finally:
        eng.close()


def test_engine_wants_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ServingEngine("random:tiny")


def test_step_generator_is_a_function_of_seed_and_step():
    draws = {(s, k): torch.rand(4, generator=step_generator(s, k, "cpu"))
             for s in (0, 1) for k in (0, 1, 2)}
    for (s, k), x in draws.items():
        assert torch.equal(x, torch.rand(
            4, generator=step_generator(s, k, torch.device("cpu"))))
    values = [tuple(x.tolist()) for x in draws.values()]
    assert len(set(values)) == len(values)
