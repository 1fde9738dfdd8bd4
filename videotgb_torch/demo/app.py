"""Interactive chat demo: upload a video, ask questions, see which frames the
TGB selected and their flow visualizations (the port's counterpart of
``videotgb_tpu/demo/app.py``: the same routes, form fields, JSON reply,
flags and defaults).

A dependency-free stdlib HTTP server with a single-page chat frontend; the
handler surface (:class:`Chat`.generate) matches the reference demo's Chat
class (reference: demo/utils/gradio_utils.py:50-139), so a gradio frontend
can be dropped on top unchanged. Each answer runs RAFT ``flow_features``
on the flow frames (kernel B), then ``generate_blip2`` or
``generate_instructblip``: TGB, the frame selection (kernel D), ViT-g
(kernel A), the Q-Former, and T5 or Vicuna decode, greedy, sampled or with
beams.

Run: python -m videotgb_torch.demo.app --model_path random:small --port 7860
[--device cpu]   (without --device it wants the CUDA device)
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import json
import os
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import torch

TEXT_LEN = 64


class Chat:
    """Model handler (reference demo/utils/gradio_utils.py:50-139): holds the
    loaded model + per-conversation state, returns (answer, selected frame
    indices, frame thumbnails, flow visualizations). ``device`` None means
    the CUDA device (raises without one); "cpu" runs the plain path."""

    def __init__(self, model_path: str = "random:small", nframe: int = 4,
                 flow_frames: int = 8, max_new_tokens: int = 32,
                 preset: str = "small", backbone: str = "blip2",
                 model_base: str | None = None,
                 sampler_base: str | None = None,
                 flow_size: int | None = None,
                 bf16_params: bool = True, device=None):
        from videotgb_torch.data.tokenizer import load_tokenizer
        from videotgb_torch.evalsuite.inference import load_model

        # the full load_model surface: a checkpoint directory needs preset
        # and backbone to rebuild the matching config; bf16 residency by
        # default, as the JAX demo serves
        args = SimpleNamespace(
            model_path=model_path, preset=preset, backbone=backbone,
            nframe=nframe, flow_size=flow_size, lora=0,
            flow_frames=flow_frames, bf16_params=bf16_params)
        self.model, self.cfg = load_model(args, device=device)
        self.device = self.model.device
        self.tok = load_tokenizer(model_base)
        self.sampler_tok = load_tokenizer(sampler_base)
        self.nframe = nframe
        self.flow_frames = flow_frames
        self.max_new_tokens = max_new_tokens
        # keyed by path, as in the JAX demo; the HTTP handler's temporary
        # path never hits it again (ROADMAP.md)
        self._cache: dict[str, tuple] = {}

    def _prep_video(self, video_path: str):
        if video_path in self._cache:
            return self._cache[video_path]
        from videotgb_torch.data.transforms import clip_transform, resize_video
        from videotgb_torch.data.video_io import read_video_cv2, sample_frames

        image = self.cfg.vit.image_size
        fs = self.cfg.tgb.flow_size
        raw, _ = read_video_cv2(video_path, num_frames=self.cfg.num_frames,
                                size=(max(image, fs),) * 2)
        frames = clip_transform(resize_video(raw, (image, image)), image)
        flow_ids = sample_frames(self.flow_frames + 1, self.cfg.num_frames)
        flow_rgb = resize_video(raw[flow_ids], (fs, fs)).astype(np.float32)
        self._cache[video_path] = (raw, frames, flow_rgb)
        return self._cache[video_path]

    def _model_for_nframe(self, nframe: int | None):
        """nframe only widens the selection gather, so the SAME parameters
        drive a view of the model with the replaced config: a shallow copy
        that shares every submodule and tensor (a copy of Vicuna-7B would
        double its memory on the card)."""
        if nframe in (None, self.cfg.nframe):
            return self.model, self.cfg
        cfg = dataclasses.replace(self.cfg, nframe=int(nframe))
        view = copy.copy(self.model)
        view.config = cfg
        return view, cfg

    @torch.no_grad()
    def inputs(self, video_path: str, question: str):
        """(raw frames, flow features (1, L, H, W, 2), the batch of one
        request) for ``generate_blip2`` / ``generate_instructblip``: RAFT
        runs here, on the flow frames."""
        raw, frames, flow_rgb = self._prep_video(video_path)
        prompt = f"USER: <video>\n{question} ASSISTANT: "
        q = self.tok([prompt], padding="max_length", max_length=TEXT_LEN)
        sq = self.sampler_tok([question], padding="max_length",
                              max_length=TEXT_LEN)
        dev = self.device

        def ids(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.long).to(dev)

        def mask(x):
            return torch.as_tensor(np.asarray(x),
                                   dtype=torch.float32).to(dev)

        flow = self.model.flow_features(
            torch.from_numpy(flow_rgb)[None].to(dev))
        batch = {
            "frames": torch.from_numpy(frames)[None].to(dev),
            "flow": flow,
            "flow_mask": torch.ones((1, self.flow_frames + 2), device=dev),
            "video_length": torch.full((1,), self.flow_frames,
                                       dtype=torch.int32, device=dev),
            "sampler_question_ids": ids(sq["input_ids"]),
            "sampler_question_mask": mask(sq["attention_mask"]),
            "question_ids": ids(q["input_ids"]),
            "question_mask": mask(q["attention_mask"]),
            "qformer_input_ids": ids(sq["input_ids"]),
            "qformer_attention_mask": mask(sq["attention_mask"]),
        }
        return raw, flow, batch

    def decode_config(self, temperature: float = 0.2, do_sample: bool = True,
                      num_beams: int = 1, top_p: float = 1.0,
                      max_new_tokens: int | None = None):
        """The backbone's ``DecodeConfig`` for the knobs; beams turn
        sampling off."""
        from videotgb_torch.ops.decode import DecodeConfig

        if self.cfg.backbone == "instructblip":
            lm = self.cfg.instructblip.llm
            eos_id, pad_id = lm.eos_token_id, lm.pad_token_id
        else:
            eos_id = self.cfg.blip2.t5.eos_token_id
            pad_id = self.cfg.blip2.t5.pad_token_id
        return DecodeConfig(
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            eos_token_id=eos_id, pad_token_id=pad_id,
            do_sample=do_sample and num_beams == 1, temperature=temperature,
            num_beams=max(int(num_beams), 1), top_p=top_p,
        )

    @torch.no_grad()
    def generate(self, video_path: str, question: str,
                 temperature: float = 0.2, do_sample: bool = True,
                 seed: int = 0, num_beams: int = 1, top_p: float = 1.0,
                 nframe: int | None = None, max_new_tokens: int | None = None):
        """Generation-parameter knobs mirror the reference demo sliders
        (demo/demo.py:205-274: nframe / beams / top-p / temperature); one
        ``torch.Generator`` seeded from ``seed`` draws the selection and
        the samples."""
        from videotgb_torch.data.flow_viz import flow_to_image
        from videotgb_torch.models.videotgb import (
            generate_blip2, generate_instructblip)

        model, _cfg = self._model_for_nframe(nframe)
        raw, flow, batch = self.inputs(video_path, question)
        dcfg = self.decode_config(temperature, do_sample, num_beams, top_p,
                                  max_new_tokens)
        gen = (generate_instructblip if self.cfg.backbone == "instructblip"
               else generate_blip2)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        tokens, cand = gen(model, batch, dcfg, generator=generator)
        answer = self.tok.batch_decode(tokens.cpu().numpy(),
                                       skip_special_tokens=True)[0]
        cand_idx = cand[0].cpu().tolist()

        thumbs = [raw[i] for i in cand_idx]
        flow_imgs = list(flow_to_image(flow[0].float().cpu().numpy()))
        return answer, cand_idx, thumbs, flow_imgs


def _png_b64(img: np.ndarray) -> str:
    import cv2

    ok, buf = cv2.imencode(".png", np.ascontiguousarray(img[..., ::-1]))
    return base64.b64encode(buf.tobytes()).decode()


PAGE = """<!doctype html><html><head><title>VideoTGB demo</title><style>
body{font-family:sans-serif;max-width:900px;margin:2em auto}
.msg{padding:.5em;margin:.3em;border-radius:8px}.user{background:#e3edfd}
.bot{background:#f0f0f0}img{height:96px;margin:2px;border-radius:4px}
</style></head><body>
<h2>VideoTGB — long video QA</h2>
<form id=f><input type=file id=video accept=video/*>
<input id=q size=50 placeholder="ask about the video">
<label>temp <input id=t type=number step=0.1 value=0.2 style="width:4em"></label>
<label>nframe <input id=nf type=number min=1 max=32 value=4 style="width:4em"></label>
<label>beams <input id=nb type=number min=1 max=8 value=1 style="width:4em"></label>
<label>top-p <input id=tp type=number step=0.05 min=0 max=1 value=1.0 style="width:4em"></label>
<button>Ask</button></form><div id=chat></div>
<script>
f.onsubmit=async e=>{e.preventDefault();
const fd=new FormData();fd.append('video',video.files[0]);
fd.append('question',q.value);fd.append('temperature',t.value);
fd.append('nframe',nf.value);fd.append('num_beams',nb.value);
fd.append('top_p',tp.value);
chat.innerHTML+=`<div class="msg user">${q.value}</div>`;
const r=await fetch('/generate',{method:'POST',body:fd});const d=await r.json();
let imgs=d.frames.map(b=>`<img src="data:image/png;base64,${b}">`).join('');
let flows=d.flows.map(b=>`<img src="data:image/png;base64,${b}">`).join('');
chat.innerHTML+=`<div class="msg bot"><b>${d.answer}</b><br>
selected frames ${JSON.stringify(d.cand)}<br>${imgs}<br>flow:<br>${flows}</div>`;};
</script></body></html>"""


def make_handler(chat: Chat):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(PAGE.encode())

        def do_POST(self):
            import email
            from email import policy

            length = int(self.headers["Content-Length"])
            ctype = self.headers["Content-Type"]
            body = self.rfile.read(length)
            msg = email.message_from_bytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
                policy=policy.default)
            fields = {}
            video_bytes = None
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name == "video":
                    video_bytes = part.get_payload(decode=True)
                else:
                    fields[name] = part.get_content().strip()
            with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
                f.write(video_bytes)
                path = f.name
            try:
                answer, cand, thumbs, flows = chat.generate(
                    path, fields.get("question", ""),
                    temperature=float(fields.get("temperature", 0.2)),
                    nframe=int(fields["nframe"]) if fields.get("nframe")
                    else None,
                    num_beams=int(fields.get("num_beams", 1)),
                    top_p=float(fields.get("top_p", 1.0)))
                payload = {
                    "answer": answer, "cand": cand,
                    "frames": [_png_b64(t) for t in thumbs],
                    "flows": [_png_b64(f_) for f_ in flows],
                }
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps(payload).encode())
            finally:
                os.unlink(path)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default="random:small")
    p.add_argument("--preset", default="small")
    p.add_argument("--backbone", default="blip2",
                   choices=["blip2", "instructblip_t5", "instructblip"])
    p.add_argument("--model_base", default=None,
                   help="LLM tokenizer dir (required for real checkpoints)")
    p.add_argument("--sampler_base", default=None,
                   help="TGB sampler tokenizer dir")
    p.add_argument("--flow_size", type=int, default=None,
                   help="override cfg.tgb.flow_size (must match the "
                        "converted checkpoint)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--nframe", type=int, default=4)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA device when not given "
                        "(raises without one), 'cpu' for the plain path")
    args = p.parse_args(argv)
    chat = Chat(args.model_path, nframe=args.nframe,
                max_new_tokens=args.max_new_tokens, preset=args.preset,
                backbone=args.backbone, model_base=args.model_base,
                sampler_base=args.sampler_base, flow_size=args.flow_size,
                device=args.device)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(chat))
    print(f"VideoTGB demo on http://localhost:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
