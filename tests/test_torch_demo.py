"""The port's chat demo (``videotgb_torch.demo.app``) on the CPU: its
``Chat.generate`` against the JAX package's ``Chat.generate`` on a clip
written with cv2 (answer string, selected frames, thumbnails bit for bit,
flow images within one uint8 level, their rendering bit for bit), greedy, with beams and with an ``nframe`` override,
with bf16 parameters (the JAX demo's ``flow_features`` jitted, see
``_JittedFlow``; its eager flow departs from the port's by about 5.6e-4,
held as such); the nframe view shares the loaded parameters; the
HTTP server answers a GET and a multipart POST, and decodes a clip posted
twice once; ``Chat`` without a device wants CUDA.

Both demos load the tiny preset with f32 compute (each package's
``VideoTGBConfig.tiny`` swapped for its f32 form) and bf16 parameters: the
JAX ``Chat`` gets numpy weights from a seed through
``_torch_port_helpers.jax_load_model_seeded`` in place of flax's init,
the port's ``Chat`` gets the same bf16 values carried across with
``videotgb_torch.convert``, and the port's selection takes the Gumbel draws
that the JAX selection makes from ``jax.random.key(seed)``."""

import io
import json
import threading
import urllib.request
import uuid

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401
    CHEAP_COMPILE,
    TOL,
    f32_tiny_presets,
    few_torch_threads,
    gumbel_like,
    jax_load_model_seeded,
)
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.convert import load_flax_params
from videotgb_torch.demo import app as TA
from videotgb_torch.models import videotgb as TV
from videotgb_tpu.models import videotgb as JV

CHAT = dict(model_path="random:tiny", flow_frames=3, max_new_tokens=4)


def write_clip(path, seed=0, frames=16, size=(64, 64)):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             10.0, size)
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (size[1], size[0], 3), np.uint8))
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("demo") / "clip.mp4")


def _jitted(generate):
    """``generate(model, params, batch, dcfg, key)`` jitted once per model
    and decode config at XLA's cheapest CPU level (eager, the tiny
    pipeline's ops compile one by one for some 40 s)."""
    compiled = {}

    def call(model, params, batch, dcfg, key):
        model = getattr(model, "model", model)
        if (model, dcfg) not in compiled:
            compiled[model, dcfg] = jax.jit(
                lambda p, b, k: generate(model, p, b, dcfg, k)).lower(
                    params, batch, key).compile(CHEAP_COMPILE)
        return compiled[model, dcfg](params, batch, key)

    return call


class _JittedFlow:
    """The JAX demo's model, whose ``flow_features`` (which the JAX ``Chat``
    runs op by op) runs jitted, as in every other path of the JAX package:
    op by op, JAX rounds RAFT's frozen batch norms' ``rsqrt(var + eps)`` to
    bf16 on bf16 parameters, where XLA keeps it in f32 (the port's
    ``load_model`` follows the jitted programs)."""

    def __init__(self, model):
        self.model = model
        self.flow = jax.jit(lambda p, f: model.apply(
            p, f, method=model.flow_features))

    def __getattr__(self, name):
        return getattr(self.model, name)

    def apply(self, params, flow, method):
        assert method == self.model.flow_features
        return self.flow(params, flow)


@pytest.fixture(scope="module")
def chats():
    """(JAX Chat, port Chat, the seed of the call under way)."""
    from videotgb_tpu.demo.app import Chat as JChat
    from videotgb_tpu.evalsuite import inference as JI

    seed = [0]
    choose = TV.VideoTGB.select_frames

    def select_jax_noise(self, start_logits, end_logits, video_length,
                         generator=None, **kw):
        sel_key = jax.random.split(jax.random.key(seed[0]))[0]
        kw["noise"] = gumbel_like(sel_key, start_logits, self.config.top_k)
        return choose(self, start_logits, end_logits, video_length,
                      generator, **kw)

    with pytest.MonkeyPatch.context() as mp:
        f32_tiny_presets(mp)
        mp.setattr(JI, "load_model", jax_load_model_seeded)
        for name in ("generate_blip2", "generate_instructblip"):
            mp.setattr(JV, name, _jitted(getattr(JV, name)))
        mp.setattr(TV.VideoTGB, "select_frames", select_jax_noise)
        jchat = JChat(**CHAT)
        jchat.model = _JittedFlow(jchat.model)
        tchat = TA.Chat(**CHAT, device="cpu")
        load_flax_params(tchat.model, jax.device_get(jchat.params))
        yield jchat, tchat, seed


@pytest.mark.parametrize("kw", [
    dict(do_sample=False),
    dict(do_sample=False, num_beams=3),
    dict(do_sample=True, num_beams=3, seed=2),  # beams turn sampling off
    dict(do_sample=False, nframe=3, seed=1),
], ids=["greedy", "beams3", "beams3-sample-flag", "nframe3"])
def test_chat_generate_matches_jax(chats, clip, kw):
    jchat, tchat, seed = chats
    seed[0] = kw.get("seed", 0)
    want = jchat.generate(clip, "what is happening?", **kw)
    got = tchat.generate(clip, "what is happening?", **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[1]) == kw.get("nframe", tchat.cfg.nframe)
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    # the flow images: RAFT's f32 flow agrees to about 1e-6 between XLA's
    # and torch's convolutions, so a colour at a rounding edge may land one
    # level apart (3 of 3072 values in the greedy case); the rendering
    # itself is held bit for bit in test_flow_to_image_matches_jax
    assert len(got[3]) == len(want[3]) == CHAT["flow_frames"]
    for a, b in zip(got[3], want[3]):
        assert a.dtype == b.dtype == np.uint8
        apart = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert apart.max() <= 1 and np.mean(apart > 0) < 0.01


def test_flow_departs_from_the_eager_jax_demo(chats, clip):
    """The port's RAFT follows the JAX package's jitted programs; the JAX
    demo runs ``flow_features`` op by op, where JAX rounds the frozen batch
    norms' ``rsqrt(var + eps)`` to bf16 on bf16 parameters, so the JAX
    demo's own flow departs from the port's by about 5.6e-4. Held here so
    the divergence stays visible if either side changes."""
    jchat, tchat, _ = chats
    model = jchat.model.model
    flow_rgb = tchat._prep_video(clip)[2][None]
    eager = np.asarray(model.apply(jchat.params, flow_rgb,
                                   method=model.flow_features))
    jitted = np.asarray(jchat.model.flow(jchat.params, flow_rgb))
    with torch.no_grad():
        port = tchat.model.flow_features(
            torch.from_numpy(flow_rgb)).float().numpy()
    np.testing.assert_allclose(port, jitted, **TOL)
    apart = float(np.abs(port - eager).max())
    assert 2e-4 < apart < 2e-3


def test_flow_to_image_matches_jax():
    from videotgb_torch.data.flow_viz import flow_to_image
    from videotgb_tpu.data.flow_viz import flow_to_image as jax_flow_to_image

    flow = np.random.default_rng(5).standard_normal((3, 32, 32, 2))
    for clip_flow in (None, 0.5):
        want = jax_flow_to_image(flow.astype(np.float32), clip_flow)
        got = flow_to_image(flow.astype(np.float32), clip_flow)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_nframe_view_shares_the_parameters(chats):
    _, tchat, _ = chats
    view, cfg = tchat._model_for_nframe(3)
    assert cfg.nframe == 3 and view.config.nframe == 3
    assert tchat.model.config.nframe == tchat.cfg.nframe == 4
    own = dict(tchat.model.named_parameters())
    shared = dict(view.named_parameters())
    assert own.keys() == shared.keys()
    assert all(shared[k] is p for k, p in own.items())
    assert tchat._model_for_nframe(None)[0] is tchat.model
    assert tchat._model_for_nframe(4)[0] is tchat.model


def _multipart(fields):
    boundary = uuid.uuid4().hex
    body = io.BytesIO()
    for name, (payload, filename) in fields.items():
        body.write(f"--{boundary}\r\n".encode())
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        body.write(f"Content-Disposition: {disp}\r\n\r\n".encode())
        body.write(payload if isinstance(payload, bytes)
                   else payload.encode())
        body.write(b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    return body.getvalue(), f"multipart/form-data; boundary={boundary}"


def test_http_round_trip(chats, clip):
    """GET serves the page; a multipart POST with beams answers what
    ``Chat.generate`` answers when called directly."""
    from http.server import ThreadingHTTPServer

    _, tchat, seed = chats
    seed[0] = 0
    server = ThreadingHTTPServer(("127.0.0.1", 0), TA.make_handler(tchat))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert "VideoTGB" in r.read().decode()
        with open(clip, "rb") as f:
            video = f.read()
        body, ctype = _multipart({
            "video": (video, "clip.mp4"), "question": ("what color?", None),
            "temperature": ("0.2", None), "nframe": ("2", None),
            "num_beams": ("3", None), "top_p": ("1.0", None)})
        req = urllib.request.Request(base + "/generate", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            reply = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert set(reply) == {"answer", "cand", "frames", "flows"}
    answer, cand, thumbs, flows = tchat.generate(clip, "what color?",
                                                 num_beams=3, nframe=2)
    assert reply["answer"] == answer and reply["cand"] == cand
    assert reply["frames"] == [TA._png_b64(x) for x in thumbs]
    assert reply["flows"] == [TA._png_b64(x) for x in flows]


def test_a_clip_posted_twice_is_decoded_once(clip, monkeypatch):
    """The HTTP handler writes each upload to a new temporary file: the
    second POST of the same clip reads the first's decode (one decode, one
    cache entry) and answers alike; the cache keeps at most
    ``CACHE_CLIPS`` clips."""
    from http.server import ThreadingHTTPServer

    from videotgb_torch.data import video_io

    decodes = []
    read = video_io.read_video_cv2
    monkeypatch.setattr(video_io, "read_video_cv2", lambda *a, **kw: (
        decodes.append(a[0]) or read(*a, **kw)))
    tchat = TA.Chat(**CHAT, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), TA.make_handler(tchat))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies = []
    try:
        with open(clip, "rb") as f:
            video = f.read()
        for _ in range(2):
            body, ctype = _multipart({"video": (video, "clip.mp4"),
                                      "question": ("what color?", None)})
            req = urllib.request.Request(base + "/generate", data=body,
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=600) as r:
                replies.append(json.loads(r.read()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert len(decodes) == 1 and len(tchat._cache) == 1
    assert replies[0] == replies[1]
    monkeypatch.setattr(TA, "CACHE_CLIPS", 1)
    tchat._prep_video(write_clip(clip + ".other.mp4", seed=1))
    assert len(decodes) == 2 and len(tchat._cache) == 1


def test_chat_wants_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.Chat(**CHAT)
