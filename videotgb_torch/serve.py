"""Serving: dynamic request batching over the two-phase pipeline (the
port's counterpart of ``videotgb_tpu/serve.py``: the same constructor,
``submit`` / ``submit_video``, ``stats()`` keys, admission rule, padding and
HTTP routes).

Concurrent requests stream into a queue. A select worker coalesces them
into fixed-size batches, ships the small uint8 flow frames, runs RAFT + TGB
+ selection (kernels B and D on the card), fetches the (B, nframe) indices,
gathers only the selected frames on the host and uploads them; an answer
worker runs ViT -> Q-Former -> LLM decode (kernel A on the card) and
resolves the per-request futures. The phase pair follows the backbone, as
in the JAX engine: ``select_phase_blip2`` in TGB "fusion" mode with the
"minus1" rule and ``answer_phase_blip2`` for the T5 backbones (blip2, and
instructblip_t5, whose Q-Former reads the question), "multi_modal" with the
"ratio" rule and ``answer_phase_instructblip`` for Vicuna (instructblip),
with the LLM's own eos / pad ids. The two workers are joined by a depth-1
queue, so select(N+1) can overlap answer(N).

On the card each worker issues its work on a CUDA stream of its own (on
the legacy default stream the two would serialise), and each phase is a
CUDA-graph program (``utils/graphs.py``): the constructor runs both phases
twice on a blank padded batch, so the graphs are captured before the
workers start and a worker only replays (a capture must not overlap the
other worker's eager work). What crosses from the
select stream to the answer stream (the uploaded frames and the question
tensors) is fenced by an event recorded on the select stream and waited on
by the answer stream, and handed to the caching allocator with
``record_stream``; the indices cross as a host array. On the CPU no stream
is used.

Batching policy: collect up to ``batch_size`` requests; wait up to
``max_delay_ms`` after the first arrival only while the answer worker is
busy. Short batches are padded by repeating the last request (pads are
dropped before reply). Batch ``step`` draws its selection noise from
``device.step_generator(seed, step, device)``.

Usage (library):
    engine = ServingEngine("random:tiny", device="cpu")
    fut = engine.submit(frames_u8, flow_u8, "what happens?")
    print(fut.result().answer)

Usage (HTTP, on the card):
    python -m videotgb_torch.serve --model_path random:small --port 8000
    POST /v1/generate  multipart(video=..., question=...)  -> JSON
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import queue
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import torch

from videotgb_torch.device import step_generator
from videotgb_torch.models.videotgb import (
    answer_phase_blip2,
    answer_phase_instructblip,
    select_phase_blip2,
)

PHASES = ("queue_wait", "assembly", "host_prep", "select", "gather",
          "answer", "postprocess")


@dataclasses.dataclass
class Reply:
    answer: str
    selected_frames: list[int]
    latency_ms: float


@dataclasses.dataclass
class _Request:
    frames_u8: np.ndarray  # (F, H, W, 3) uint8 candidate frames
    flow_u8: np.ndarray    # (L+1, hf, wf, 3) uint8 flow frames
    question: str
    future: Future
    t_submit: float


class ServingEngine:
    """Dynamically-batched two-phase VideoTGB serving (BLIP2-Flan-T5,
    InstructBLIP-Flan-T5 or InstructBLIP-Vicuna)."""

    def __init__(
        self,
        model_path: str = "random:tiny",
        preset: str = "tiny",
        batch_size: int = 4,
        flow_frames: int = 4,
        max_new_tokens: int = 16,
        max_delay_ms: float = 30.0,
        text_len: int = 64,
        seed: int = 0,
        model_base: str | None = None,
        sampler_base: str | None = None,
        backbone: str = "blip2",
        bf16_params: bool = True,
        mesh: str = "",
        device=None,
    ):
        """``model_base``/``sampler_base``: tokenizer dirs for the LLM and
        the TGB sampler (None = the byte tokenizer, for random weights).
        ``preset`` names the config of a checkpoint path (a
        ``videotgb_torch.train`` checkpoint without LoRA adapters, restored
        by ``evalsuite.inference.load_model``); ``random:<preset>`` carries
        its own.
        ``backbone``: "blip2", "instructblip_t5" or "instructblip".
        ``device``: None = the CUDA device (raises without one); "cpu" runs
        the plain path. ``mesh`` raises ``NotImplementedError``."""
        from videotgb_torch.data.tokenizer import load_tokenizer
        from videotgb_torch.evalsuite.inference import load_model
        from videotgb_torch.ops.decode import DecodeConfig

        if mesh:
            raise NotImplementedError(
                f"mesh-sharded serving ({mesh!r}) is not ported: ROADMAP.md "
                "queue 1 item 4")
        self.model, self.cfg = load_model(SimpleNamespace(
            model_path=model_path, preset=preset, backbone=backbone,
            bf16_params=bf16_params), device=device)
        dev = self.model.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.tok = load_tokenizer(model_base)
        self.sampler_tok = load_tokenizer(sampler_base)
        self.batch_size = batch_size
        self.flow_frames = flow_frames
        self.max_new_tokens = max_new_tokens
        self.max_delay_s = max_delay_ms / 1000.0
        self.text_len = text_len
        self.seed = seed
        self.decoder_only = self.cfg.backbone == "instructblip"
        if self.decoder_only:
            lm = self.cfg.instructblip.llm
            self.select_kw = dict(mode="multi_modal", rescale="ratio")
        else:
            lm = self.cfg.blip2.t5
            self.select_kw = dict(mode="fusion", rescale="minus1")
        self.decode_config = DecodeConfig(
            max_new_tokens=max_new_tokens, eos_token_id=lm.eos_token_id,
            pad_token_id=lm.pad_token_id)
        if dev.type == "cuda":
            self._select_stream = torch.cuda.Stream(dev)
            self._answer_stream = torch.cuda.Stream(dev)
            self._capture_phases()
        else:
            self._select_stream = self._answer_stream = None
        self._queue: "queue.Queue[_Request | None]" = queue.Queue()
        # depth 1: at most one batch between the phases, enough to overlap
        # select(N+1) with answer(N) without unbounded latency buildup
        self._mid: "queue.Queue" = queue.Queue(maxsize=1)
        self._answer_busy = threading.Event()
        self._recent_lat: list[float] = []  # last <= 512 latencies (ms)
        self._phase_t: dict[str, list] = {name: [] for name in PHASES}
        self._served = 0
        self._batches = 0
        self._t_start = time.perf_counter()
        self._worker = threading.Thread(target=self._run_select, daemon=True)
        self._worker.start()
        self._answer_worker = threading.Thread(target=self._run_answer,
                                               daemon=True)
        self._answer_worker.start()

    def _answer(self):
        return (answer_phase_instructblip if self.decoder_only
                else answer_phase_blip2)

    def _capture_phases(self):
        """On the card, before the workers start: each phase twice, on its
        worker's stream, on a batch of blank requests (the eager first call,
        then the capture of its CUDA graphs: ``utils/graphs.py``). Batches
        are padded to ``batch_size`` and questions to ``text_len``, so the
        workers only replay: no capture overlaps the other worker's work."""
        cfg, dev = self.cfg, self.device
        image, fs = cfg.vit.image_size, cfg.tgb.flow_size
        blank = _Request(
            np.zeros((cfg.num_frames, image, image, 3), np.uint8),
            np.zeros((self.flow_frames + 1, fs, fs, 3), np.uint8), "",
            Future(), 0.0)
        padded = [blank] * self.batch_size
        with torch.inference_mode(), torch.cuda.device(dev):
            for _ in range(2):
                gen = step_generator(self.seed, 0, dev)
                with torch.cuda.stream(self._select_stream):
                    flow_u8, bd = self.host_batch(padded)
                    select_phase_blip2(self.model, flow_u8, bd,
                                       generator=gen, **self.select_kw)
                    sel = torch.zeros((self.batch_size, cfg.nframe, image,
                                       image, 3), dtype=torch.uint8,
                                      device=dev)
                self._answer_stream.wait_stream(self._select_stream)
                with torch.cuda.stream(self._answer_stream):
                    self._answer()(self.model, sel, bd, self.decode_config,
                                   generator=gen)
            torch.cuda.synchronize(dev)

    def stats(self) -> dict:
        """Served counts, queue depth, latency percentiles over the last
        <= 512 requests (submit to reply, ``Reply.latency_ms``) and the
        per-phase wall time over the last <= 512 batches: queue_wait (submit
        -> first pop), assembly (batch soak), host_prep (tokenize + stack +
        upload), select (phase 1 incl. the index fetch), gather (host frame
        gather + upload), answer (phase 2 incl. the token fetch),
        postprocess (detokenize + future resolution)."""
        lat = list(self._recent_lat)
        up = time.perf_counter() - self._t_start
        out = {
            "served": self._served,
            "batches": self._batches,
            "queue_depth": self._queue.qsize(),
            "batch_size": self.batch_size,
            "uptime_s": round(up, 1),
            "throughput_req_s": round(self._served / up, 3) if up > 0 else 0.0,
        }
        if lat:
            arr = np.asarray(lat)
            out.update(
                p50_ms=round(float(np.percentile(arr, 50)), 1),
                p90_ms=round(float(np.percentile(arr, 90)), 1),
                p99_ms=round(float(np.percentile(arr, 99)), 1),
            )
        out["phase_ms"] = {
            name: {"p50": round(float(np.percentile(np.asarray(ts), 50)), 1),
                   "p90": round(float(np.percentile(np.asarray(ts), 90)), 1)}
            for name, ts in self._phase_t.items() if ts}
        return out

    # --------------------------------------------------------------- submit
    def submit(self, frames_u8: np.ndarray, flow_u8: np.ndarray,
               question: str) -> Future:
        """frames_u8 (num_frames, H, W, 3) uint8 at the ViT size; flow_u8
        (flow_frames+1, hf, wf, 3) uint8 at the TGB flow size."""
        fut: Future = Future()
        self._queue.put(_Request(frames_u8, flow_u8, question, fut,
                                 time.perf_counter()))
        return fut

    def submit_video(self, video_path: str, question: str) -> Future:
        """Decode on the caller's thread (needs ``cv2``), then submit."""
        from videotgb_torch.data.transforms import resize_video
        from videotgb_torch.data.video_io import read_video_cv2, sample_frames

        image = self.cfg.vit.image_size
        fs = self.cfg.tgb.flow_size
        raw, _ = read_video_cv2(video_path, num_frames=self.cfg.num_frames,
                                size=(max(image, fs),) * 2)
        flow_ids = sample_frames(self.flow_frames + 1, self.cfg.num_frames)
        return self.submit(
            np.ascontiguousarray(resize_video(raw, (image, image))),
            np.ascontiguousarray(resize_video(raw[flow_ids], (fs, fs))),
            question)

    def host_batch(self, padded: list) -> tuple[torch.Tensor, dict]:
        """The device inputs of the select phase for a padded batch of
        requests (anything with ``flow_u8`` and ``question``): the flow
        frames (B, L+1, hf, wf, 3) uint8 and the batch dict."""
        from videotgb_torch.evalsuite.inference import text_batch

        b, dev = len(padded), self.device
        bd = {
            "flow_mask": torch.ones((b, self.flow_frames + 2), device=dev),
            "video_length": torch.full((b,), self.flow_frames,
                                       dtype=torch.int32, device=dev),
            **text_batch(self.tok, self.sampler_tok,
                         [r.question for r in padded], self.text_len, dev),
        }
        flow_u8 = torch.from_numpy(np.stack([r.flow_u8 for r in padded]))
        return flow_u8.to(dev), bd

    # --------------------------------------------------------------- worker
    def _phase(self, name: str, ms: float):
        ts = self._phase_t[name]
        ts.append(round(ms, 2))
        if len(ts) > 512:
            del ts[: len(ts) - 512]

    @contextlib.contextmanager
    def _worker_context(self, stream):
        """A worker's thread-local state: inference mode, and on the card
        the engine's device and the worker's own stream."""
        with torch.inference_mode():
            if stream is None:
                yield
                return
            torch.cuda.set_device(self.device)
            with torch.cuda.stream(stream):
                yield

    def _collect(self) -> list[_Request] | None:
        """Block for the first request, then batch adaptively.

        Whatever is already queued is drained for free. Beyond that, soak
        up to max_delay_ms for more arrivals only while the answer stage is
        busy (the pipe is occupied anyway, so waiting costs no latency);
        with the pipe idle, dispatch at once."""
        first = self._queue.get()
        if first is None:
            return None
        t_pop = time.perf_counter()
        self._phase("queue_wait", (t_pop - first.t_submit) * 1000)
        group = [first]
        while len(group) < self.batch_size:  # free: already queued
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # propagate shutdown after this batch
                self._phase("assembly", (time.perf_counter() - t_pop) * 1000)
                return group
            group.append(nxt)
        if len(group) < self.batch_size and self._answer_busy.is_set():
            deadline = t_pop + self.max_delay_s
            while len(group) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)
                    break
                group.append(nxt)
        self._phase("assembly", (time.perf_counter() - t_pop) * 1000)
        return group

    def _run_select(self):
        """Stage 1: collect -> tokenize -> RAFT + TGB + selection on the
        device -> host frame gather + upload -> hand off to the answer
        stage."""
        with self._worker_context(self._select_stream):
            step = 0
            while True:
                group = self._collect()
                if group is None:
                    self._mid.put(None)  # shutdown to the answer stage
                    return
                padded = group + [group[-1]] * (self.batch_size - len(group))
                try:
                    t0 = time.perf_counter()
                    flow_u8, bd = self.host_batch(padded)
                    gen = step_generator(self.seed, step, self.device)
                    step += 1
                    t1 = time.perf_counter()
                    self._phase("host_prep", (t1 - t0) * 1000)
                    cand = select_phase_blip2(self.model, flow_u8, bd,
                                              generator=gen, **self.select_kw)
                    sel_idx = cand.cpu().numpy()
                    t2 = time.perf_counter()
                    self._phase("select", (t2 - t1) * 1000)
                    sel = np.stack([padded[i].frames_u8[sel_idx[i]]
                                    for i in range(len(padded))])
                    sel_dev = torch.from_numpy(sel).to(self.device)
                    ready = None
                    if self._select_stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(self._select_stream)
                    self._phase("gather", (time.perf_counter() - t2) * 1000)
                except Exception as e:  # resolve futures even on failure
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)
                    continue
                self._answer_busy.set()
                self._mid.put((group, bd, sel_idx, sel_dev, gen, ready))

    def _run_answer(self):
        """Stage 2: LLM decode on the device -> detokenize -> resolve
        futures."""
        with self._worker_context(self._answer_stream):
            while True:
                item = self._mid.get()
                if item is None:
                    return
                group, bd, sel_idx, sel_dev, gen, ready = item
                try:
                    t0 = time.perf_counter()
                    if ready is not None:
                        self._answer_stream.wait_event(ready)
                        for x in (sel_dev, *bd.values()):
                            x.record_stream(self._answer_stream)
                    tokens = self._answer()(self.model, sel_dev, bd,
                                    self.decode_config,
                                    generator=gen).cpu().numpy()
                    t1 = time.perf_counter()
                    self._phase("answer", (t1 - t0) * 1000)
                    answers = self.tok.batch_decode(tokens,
                                                    skip_special_tokens=True)
                    now = time.perf_counter()
                    for i, r in enumerate(group):
                        lat_ms = round((now - r.t_submit) * 1000, 1)
                        r.future.set_result(Reply(
                            answer=answers[i],
                            selected_frames=[int(x) for x in sel_idx[i]],
                            latency_ms=lat_ms))
                        self._recent_lat.append(lat_ms)
                    self._phase("postprocess", (now - t1) * 1000)
                    self._recent_lat = self._recent_lat[-512:]
                    self._served += len(group)
                    self._batches += 1
                except Exception as e:
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)
                finally:
                    if self._mid.empty():
                        self._answer_busy.clear()

    def close(self):
        self._queue.put(None)
        self._worker.join(timeout=30)
        self._answer_worker.join(timeout=30)


# ------------------------------------------------------------------- HTTP
def make_server(engine: ServingEngine, host: str = "0.0.0.0",
                port: int = 8000):
    """A ``ThreadingHTTPServer`` over ``engine``: GET /healthz, GET
    /v1/stats, POST /v1/generate (multipart video + question -> the
    ``Reply`` as JSON; a failed batch or a timeout -> 500 with the error)."""
    import os
    import tempfile
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, b'{"status": "ok"}')
            elif self.path == "/v1/stats":
                self._json(200, json.dumps(engine.stats()).encode())
            else:
                self._json(404, b'{"error": "not found"}')

        def do_POST(self):
            import email
            from email import policy

            length = int(self.headers["Content-Length"])
            ctype = self.headers["Content-Type"]
            body = self.rfile.read(length)
            msg = email.message_from_bytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
                policy=policy.default)
            question, video_bytes = "", None
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name == "video":
                    video_bytes = part.get_payload(decode=True)
                elif name == "question":
                    question = part.get_content().strip()
            if not video_bytes:
                self._json(400, b'{"error": "missing video part"}')
                return
            with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
                f.write(video_bytes)
                path = f.name
            try:
                try:
                    reply = engine.submit_video(path, question).result(
                        timeout=600)
                except Exception as e:  # batch failure / timeout -> 500 JSON
                    self._json(500, json.dumps({"error": str(e)}).encode())
                    return
                self._json(200, json.dumps(dataclasses.asdict(reply)).encode())
            finally:
                os.unlink(path)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default="random:small")
    p.add_argument("--preset", default="small")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--flow_frames", type=int, default=4)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--max_delay_ms", type=float, default=30.0)
    p.add_argument("--model_base", default=None,
                   help="LLM tokenizer dir (required for real checkpoints)")
    p.add_argument("--sampler_base", default=None,
                   help="TGB sampler tokenizer dir")
    p.add_argument("--backbone", default="blip2",
                   choices=["blip2", "instructblip_t5", "instructblip"])
    p.add_argument("--f32_params", action="store_true",
                   help="keep f32 parameters (default bf16 for ViT, "
                        "Q-Former, the LLM and TGB)")
    p.add_argument("--mesh", default="",
                   help="mesh-sharded serving; not ported, raises")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA device when not given")
    args = p.parse_args(argv)

    engine = ServingEngine(
        args.model_path, preset=args.preset, batch_size=args.batch_size,
        flow_frames=args.flow_frames, max_new_tokens=args.max_new_tokens,
        max_delay_ms=args.max_delay_ms, model_base=args.model_base,
        sampler_base=args.sampler_base, backbone=args.backbone,
        bf16_params=not args.f32_params, mesh=args.mesh, device=args.device)
    server = make_server(engine, port=args.port)
    print(f"VideoTGB (PyTorch) serving on http://localhost:{args.port}"
          f"/v1/generate (batch {args.batch_size}, max delay "
          f"{args.max_delay_ms} ms, {engine.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
