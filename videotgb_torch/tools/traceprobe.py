"""Trace one serving segment under ``torch.profiler`` and print the top
device operations.

The counterpart of the JAX package's ``tools/traceprobe.py``. It builds the
model the JAX tool builds: ``VideoTGBConfig.flagship()`` with bf16
parameters (``bf16_param_config``), the ViT's tanh GELU (``act="gelu_new"``,
the JAX benchmark's ``_fast_act``) and RAFT's convolutions in bf16, random
weights from seed 0. A segment is

  raft     ``flow_features`` on (batch, 5) flow frames: kernel B, 20 a call
  vit      ``encode_selected`` (ViT-g + Q-Former) on nframe frames a clip:
           kernel A on every ViT-g layer, 39 a call
  qformer  the Q-Former alone at the answer phase's shapes (batch x nframe
           frames of 257 ViT-g tokens, 32 queries): no kernel (its
           attentions are below the flash rule's 128^2)
  decode   ``t5_generate_from_encoder`` (``max_new`` greedy steps, no early
           stop) on an encoder state the tool computes once first (RAFT's
           flow and ``prepare_t5_inference``: 20 kernel B, 1 D and 39 A;
           the T5 encoder reads 32 pooled visual + 24 text tokens, under
           the rule); the steps launch no kernel

It runs one warm call, then traces two. The first line is the JAX tool's
``{"device_total_ms", "trace"}`` with the synchronised ``wall_ms`` added,
then one ``{"op", "ms", "n", "pct"}`` line per operation, the ``top`` by
device time. The Chrome trace goes to a temporary directory.

    python -m videotgb_torch.tools.traceprobe raft|vit|qformer|decode
        [--batch 32] [--max_new 16] [--top 40] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.utils.profiling import print_summary, traced

SEGMENTS = ("raft", "vit", "qformer", "decode")
FLOW_FRAMES, TEXT_LEN = 4, 24


def serving_config():
    """The JAX tool's build: the flagship with bf16 parameters, the ViT's
    tanh GELU, RAFT's convolutions in bf16."""
    from videotgb_torch.models import videotgb as V

    cfg = V.bf16_param_config(V.VideoTGBConfig.flagship())
    blip2 = dataclasses.replace(
        cfg.blip2, vit=dataclasses.replace(cfg.blip2.vit, act="gelu_new"))
    return dataclasses.replace(
        cfg, blip2=blip2,
        raft=dataclasses.replace(cfg.raft, dtype=torch.bfloat16))


def serving_model(device):
    from videotgb_torch.models.videotgb import VideoTGB

    return VideoTGB(serving_config(), device=device, seed=0)


def build(which: str, model, batch: int, max_new: int):
    """The segment's call on ``model``, its inputs made from seed 0."""
    from videotgb_torch.models.videotgb import t5_generate_from_encoder
    from videotgb_torch.ops.decode import DecodeConfig

    cfg, dev = model.config, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    image, fs = cfg.blip2.vit.image_size, cfg.tgb.flow_size
    if which == "raft":
        flow_rgb = torch.rand((batch, FLOW_FRAMES + 1, fs, fs, 3),
                              generator=gen, device=dev) * 255.0
        return lambda: model.flow_features(flow_rgb).float().sum()
    frames = torch.rand((batch, cfg.num_frames, image, image, 3),
                        generator=gen, device=dev)
    if which == "vit":
        cand = torch.arange(cfg.nframe, device=dev).expand(batch, -1)
        return lambda: model.encode_selected(frames, cand).float().sum()
    if which == "qformer":
        qf = model.model.qformer
        qcfg = qf.config
        n = batch * cfg.nframe
        tokens = (image // cfg.blip2.vit.patch_size) ** 2 + 1
        enc = torch.randn((n, tokens, qcfg.encoder_hidden_size),
                          generator=gen, device=dev).to(torch.bfloat16)
        queries = torch.randn((n, qcfg.num_query_tokens, qcfg.hidden_size),
                              generator=gen, device=dev).to(torch.bfloat16)
        return lambda: qf(queries, enc).float().sum()
    if which == "decode":
        ids = torch.full((batch, TEXT_LEN), 200, dtype=torch.long, device=dev)
        ones = torch.ones((batch, TEXT_LEN), device=dev)
        flow_rgb = torch.rand((batch, FLOW_FRAMES + 1, fs, fs, 3),
                              generator=gen, device=dev) * 255.0
        with torch.no_grad():
            flow = model.flow_features(flow_rgb)
            enc_hidden, enc_mask, _ = model.prepare_t5_inference(
                frames, flow, torch.ones((batch, FLOW_FRAMES + 2), device=dev),
                torch.full((batch,), FLOW_FRAMES, device=dev), ids, ones,
                ids, ones, generator=gen)
        dcfg = DecodeConfig(max_new_tokens=max_new, eos_token_id=-1,
                            pad_token_id=0)
        return lambda: t5_generate_from_encoder(model, enc_hidden, enc_mask,
                                                dcfg, gen)
    raise ValueError(f"unknown segment {which!r} (one of {SEGMENTS})")


def run_and_trace(fn, device, trace_dir: str | None = None) -> dict:
    """One warm call, then two traced: the summary of the traced pair, its
    Chrome trace written under ``trace_dir`` (a new temporary directory by
    default)."""
    with torch.no_grad():
        fn()
        trace_dir = trace_dir or tempfile.mkdtemp(prefix="torchtrace_")
        return traced(fn, device, reps=2,
                      trace_path=os.path.join(trace_dir, "trace.json"))


def main(argv=None, model=None) -> dict:
    """``model`` (optional) is a model built by :func:`serving_model`, so a
    caller tracing several segments builds it once."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=SEGMENTS)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    if model is None:
        model = serving_model(resolve_device(args.device))
    dev = model.device
    summary = run_and_trace(build(args.which, model, args.batch,
                                  args.max_new), dev)
    print_summary(summary, args.top)
    return summary


if __name__ == "__main__":
    main()
