"""Standalone batch-inference CLI for MSVD / MSRVTT / ActivityNet-QA (the
port's copy of ``videotgb_tpu/evalsuite/inference.py``, same flags and
JSONL rows).

CLI-compatible with the reference harness (reference: eval/inference.py):
the --gt_file_question/--gt_file_answers question-answer json pair,
--num_chunks/--chunk_idx sharding, --nframe, and the JSONL output rows
{'id', 'question', 'answer', 'pred'}. The ActivityNet "v_" filename prefix
quirk is kept.

Samples are decoded by a host thread pool, one batch ahead of the device,
and run in fixed-size batches through ``generate_blip2`` (flow -> TGB ->
select -> ViT -> Q-Former -> T5 decode; --backbone blip2 and
instructblip_t5) or ``generate_instructblip`` (the same through an
instruction-aware Q-Former into Vicuna; --backbone instructblip). Flow
sampling defaults to the reference's whole-timeline ~1 fps mode
(duration-bucketed flow lengths); --flow_mode=fixed takes flow_frames+1 of
the 32 candidates.

    python -m videotgb_torch.evalsuite.inference --model_path random:tiny \\
        --video_dir videos --gt_file_question q.json --gt_file_answers a.json \\
        --output_dir out --output_name preds [--device cpu]

--model_path is ``random:<preset>`` or a checkpoint directory written by
``python -m videotgb_torch.train`` (with --preset naming its config and
--lora 1 for an IVT checkpoint); --mesh raises ``NotImplementedError``
naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from videotgb_torch.device import step_generator

VIDEO_FORMATS = (".mp4", ".avi", ".mov", ".mkv")
FLOW_BUCKETS = (8, 16, 32, 64)
TEXT_LEN = 64


def split_list(lst, n):
    chunk = math.ceil(len(lst) / n)
    return [lst[i : i + chunk] for i in range(0, len(lst), chunk)]


def get_chunk(lst, n, k):
    return split_list(lst, n)[k]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True,
                   help="'random:<preset>' (random weights from seed 0) or "
                        "a checkpoint directory of videotgb_torch.train")
    p.add_argument("--preset", default="flagship",
                   help="VideoTGBConfig preset for a checkpoint model_path")
    p.add_argument("--backbone", default="blip2",
                   choices=["blip2", "instructblip_t5", "instructblip"])
    p.add_argument("--mesh", default="",
                   help="mesh-sharded inference; not ported, raises")
    p.add_argument("--flow_size", type=int, default=None,
                   help="override cfg.tgb.flow_size")
    p.add_argument("--cache_dir", default="", required=False)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--gt_file_question", required=True)
    p.add_argument("--gt_file_answers", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_name", required=True)
    p.add_argument("--nframe", type=int, default=4)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA device when not given "
                        "(raises without one), 'cpu' for the plain path")
    p.add_argument("--model_base", type=str, default=None)
    p.add_argument("--sampler_base", type=str, default=None)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--lora", type=int, default=0,
                   help="1: rank-8 LoRA adapters on the LLM (an IVT "
                        "checkpoint)")
    p.add_argument("--bf16_params", type=int, default=1,
                   help="bf16 parameters for ViT, Q-Former, the LLM and "
                        "TGB (default); 0 keeps f32")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--flow_frames", type=int, default=8,
                   help="(fixed mode) flow frames sampled from the "
                        "candidate set")
    p.add_argument("--flow_mode", default="timeline",
                   choices=["timeline", "fixed"],
                   help="timeline = the reference's ~1 fps whole-duration "
                        "flow decode, duration-bucketed; fixed = "
                        "flow_frames uniform stride")
    p.add_argument("--flow_fps", type=float, default=2.0,
                   help="requested flow decode rate (the effective rate is "
                        "~1 fps: every int(native_fps)-th frame)")
    p.add_argument("--max_flow_frames", type=int, default=64,
                   help="flow-length cap; longer timelines thin uniformly")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--do_sample", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--decode_workers", type=int, default=8)
    p.add_argument("--stop", action="append", default=[],
                   help="stop keyword(s), tokenized and matched as generated "
                        "suffixes")
    return p.parse_args(argv)


def encode_stop_words(tok, words) -> list[tuple[int, ...]]:
    """Tokenize stop keywords the way KeywordsStoppingCriteria does: strip
    the leading BOS that LLaMA-style tokenizers prepend, and drop a trailing
    EOS (T5-style tokenizers append it; EOS already ends decode)."""
    out = []
    bos = getattr(tok, "bos_token_id", None)
    eos = getattr(tok, "eos_token_id", None)
    for word in words:
        if not hasattr(tok, "encode"):
            continue
        ids = [int(t) for t in tok.encode(word)]
        if len(ids) > 1 and bos is not None and ids[0] == bos:
            ids = ids[1:]
        if len(ids) > 1 and eos is not None and ids[-1] == eos:
            ids = ids[:-1]
        if ids:
            out.append(tuple(ids))
    return out


def find_video(video_dir: str, video_name: str) -> str | None:
    for fmt in VIDEO_FORMATS:
        name = f"v_{video_name}{fmt}" if "Activitynet" in video_dir else f"{video_name}{fmt}"
        path = os.path.join(video_dir, name)
        if os.path.exists(path):
            return path
    return None


def _warn_ignored_flags(args) -> None:
    """Reference-compat flags accepted but not used get a loud warning."""
    import warnings

    if getattr(args, "model_max_length", 2048) != 2048:
        warnings.warn("--model_max_length is a reference-compat stub; prompt "
                      "length is fixed by the pipeline's text_len")
    if getattr(args, "cache_dir", ""):
        warnings.warn("--cache_dir is a reference-compat stub (no HF hub "
                      "download cache in this pipeline)")


def load_model(args, device=None):
    """Build the VideoTGB of ``backbone`` (blip2, instructblip_t5 or
    instructblip) on ``device`` (None = the CUDA device), honouring
    ``nframe``, ``flow_size``, ``lora`` and ``bf16_params``. Returns
    (model, cfg).

    ``model_path`` is ``random:<preset>`` (random weights from seed 0) or a
    checkpoint of ``training.checkpoint.CheckpointManager`` (its root, its
    best/ or last/ directory, or one step directory; the root gives its
    newest step), whose ``params`` are restored onto the model of
    ``preset``. ``lora`` puts rank-8 adapters on the LLM (T5 or LLaMA)
    before the restore, as the IVT recipe trains them. The checkpoint's keys
    must be the model's exactly: a LoRA checkpoint without ``lora``, or the
    reverse, raises naming the keys. ``bf16_params`` builds
    the ViT, Q-Former, LLM (with its adapters) and TGB in bf16 and copies
    the restored values in, rounding them; RAFT stays f32, as for random
    weights."""
    from videotgb_torch.models.videotgb import (
        VideoTGB,
        VideoTGBConfig,
        bf16_param_config,
        with_lora,
    )

    _warn_ignored_flags(args)
    backbone = getattr(args, "backbone", "blip2")
    random_weights = args.model_path.startswith("random:")
    preset = (args.model_path.split(":", 1)[1] if random_weights
              else getattr(args, "preset", "flagship"))
    cfg = getattr(VideoTGBConfig, preset)(backbone)
    nframe = getattr(args, "nframe", None)
    if nframe and nframe != cfg.nframe:
        cfg = dataclasses.replace(cfg, nframe=nframe)
    if getattr(args, "flow_size", None):
        cfg = dataclasses.replace(
            cfg, tgb=dataclasses.replace(cfg.tgb, flow_size=args.flow_size))
    if getattr(args, "lora", 0):
        cfg = with_lora(cfg, 8)
    if getattr(args, "bf16_params", False):
        cfg = bf16_param_config(cfg)
    model = VideoTGB(cfg, device=device, seed=0)
    if not random_weights:
        from videotgb_torch.training.checkpoint import restore_params

        restore_params(model, args.model_path)
    return model, cfg


def text_batch(tok, sampler_tok, questions, text_len, device):
    """The question tensors of one batch: the LLM prompt
    ("USER: <video>\\n{q} ASSISTANT: ") and the sampler's question, each
    padded to ``text_len``; ids int64, masks f32."""
    prompts = [f"USER: <video>\n{q} ASSISTANT: " for q in questions]
    q_enc = tok(prompts, padding="max_length", truncation=True,
                max_length=text_len)
    sq_enc = sampler_tok(list(questions), padding="max_length",
                         truncation=True, max_length=text_len)

    def ids(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.long).to(device)

    def mask(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)

    return {
        "sampler_question_ids": ids(sq_enc["input_ids"]),
        "sampler_question_mask": mask(sq_enc["attention_mask"]),
        "question_ids": ids(q_enc["input_ids"]),
        "question_mask": mask(q_enc["attention_mask"]),
        # instruction-aware Q-Former text: the sampler's tokens
        "qformer_input_ids": ids(sq_enc["input_ids"]),
        "qformer_attention_mask": mask(sq_enc["attention_mask"]),
    }


def decode_sample(video_path: str, num_frames: int, flow_frames: int,
                  image: int, flow_size: int):
    """Fixed-stride mode: ``num_frames`` uniform candidates, flow_frames+1
    of them for RAFT."""
    from videotgb_torch.data.transforms import clip_transform, resize_video
    from videotgb_torch.data.video_io import read_video_cv2, sample_frames

    frames, _ = read_video_cv2(video_path, num_frames=num_frames,
                               size=(max(image, flow_size),) * 2)
    flow_ids = sample_frames(flow_frames + 1, num_frames)
    flow_raw = resize_video(frames[flow_ids], (flow_size, flow_size))
    return (clip_transform(resize_video(frames, (image, image)), image),
            flow_raw.astype(np.float32))


def flow_bucket(length: int, max_flow_frames: int) -> int:
    """Smallest bucketed flow length >= ``length``, so short clips skip most
    of the padded TGB/RAFT work."""
    for b in FLOW_BUCKETS:
        if b >= length and b <= max_flow_frames:
            return b
    return max_flow_frames


def decode_sample_timeline(video_path: str, num_frames: int,
                           max_flow_frames: int, flow_fps: float,
                           image: int, flow_size: int):
    """The reference's eval decode (builder_utils.py:117-144 get_frames):
    flow frames at ~1 fps over the whole native timeline (<=
    max_flow_frames), candidate frames = ``num_frames`` uniform picks of the
    flow frames (duplicate-when-short)."""
    from videotgb_torch.data.transforms import clip_transform, resize_video
    from videotgb_torch.data.video_io import (
        candidate_indices,
        read_video_timeline,
    )

    timeline, length = read_video_timeline(
        video_path, max_frames=max_flow_frames, fps=flow_fps,
        size=(max(image, flow_size),) * 2)
    cand = candidate_indices(length, num_frames)
    frames = clip_transform(
        resize_video(timeline[cand], (image, image)), image)
    flow_raw = resize_video(timeline, (flow_size, flow_size)).astype(np.float32)
    return frames, flow_raw, length


def _flow_batch(model, decoded, timeline, bsz, flow_frames, max_flow_frames,
                fs):
    """The flow tensors of one batch: (flow, flow_mask, video_length)."""
    dev = model.device
    if not timeline:
        flow_rgb = torch.from_numpy(np.stack([d[1] for d in decoded]))
        return (model.flow_features(flow_rgb.to(dev)),
                torch.ones((bsz, flow_frames + 2), device=dev),
                torch.full((bsz,), flow_frames, dtype=torch.int32,
                           device=dev))
    bucket = flow_bucket(max(d[2] for d in decoded), max_flow_frames)
    flow_rgb = np.zeros((bsz, bucket, fs, fs, 3), np.float32)
    valid = np.zeros((bsz, bucket), np.float32)
    flow_mask = np.zeros((bsz, bucket + 2), np.float32)
    lengths = np.zeros((bsz,), np.int32)
    for i, (_, fl, ln) in enumerate(decoded):
        ln = min(ln, bucket)
        flow_rgb[i, :ln] = fl[:ln]
        # repeat-last padding: pad pairs give ~zero flow and are masked out
        # of normalization and attention anyway
        flow_rgb[i, ln:] = fl[ln - 1]
        valid[i, :ln] = 1.0
        flow_mask[i, : ln + 2] = 1.0
        lengths[i] = ln
    flow = model.flow_features_timeline(torch.from_numpy(flow_rgb).to(dev),
                                        torch.from_numpy(valid).to(dev))
    return (flow, torch.from_numpy(flow_mask).to(dev),
            torch.from_numpy(lengths).to(dev))


def run_inference(args) -> str:
    """Answer every question of the chunk whose video exists, writing one
    JSONL row per answer; returns the output path. Runs on ``args.device``
    (None = the CUDA device)."""
    from videotgb_torch.data.tokenizer import load_tokenizer
    from videotgb_torch.models.videotgb import (
        generate_blip2,
        generate_instructblip,
    )
    from videotgb_torch.ops.decode import DecodeConfig

    if args.mesh:
        raise NotImplementedError(
            "mesh-sharded inference is not ported: ROADMAP.md queue 1 "
            "item 7")
    model, cfg = load_model(args, device=args.device)
    tok = load_tokenizer(args.model_base)
    sampler_tok = load_tokenizer(args.sampler_base)
    image = cfg.vit.image_size
    fs = cfg.tgb.flow_size
    decoder_only = cfg.backbone == "instructblip"

    with open(args.gt_file_question) as f:
        gt_questions = get_chunk(json.load(f), args.num_chunks,
                                 args.chunk_idx)
    with open(args.gt_file_answers) as f:
        gt_answers = get_chunk(json.load(f), args.num_chunks, args.chunk_idx)

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")

    lm = cfg.instructblip.llm if decoder_only else cfg.blip2.t5
    generate = generate_instructblip if decoder_only else generate_blip2
    dcfg = DecodeConfig(
        max_new_tokens=args.max_new_tokens,
        eos_token_id=lm.eos_token_id,
        pad_token_id=lm.pad_token_id,
        do_sample=bool(args.do_sample),
        temperature=args.temperature,
    )
    stop_sequences = tuple(encode_stop_words(tok, args.stop))

    samples = []
    for i, q in enumerate(gt_questions):
        path = find_video(args.video_dir, q["video_name"])
        if path is None:
            continue
        samples.append({
            "id": q["question_id"], "question": q["question"],
            "answer": gt_answers[i]["answer"], "path": path,
        })

    bsz = args.batch_size
    timeline = args.flow_mode == "timeline"
    groups = []
    for start in range(0, len(samples), bsz):
        group = samples[start : start + bsz]
        pad = bsz - len(group)  # fixed batch: pad the last one
        groups.append((start, group, group + [group[-1]] * pad))

    def decode_group(padded):
        if timeline:
            return list(pool.map(
                lambda s: decode_sample_timeline(
                    s["path"], cfg.num_frames, args.max_flow_frames,
                    args.flow_fps, image, fs), padded))
        return list(pool.map(
            lambda s: decode_sample(s["path"], cfg.num_frames,
                                    args.flow_frames, image, fs), padded))

    written = 0
    # batch N+1 decodes on host threads while batch N runs on the device
    with ThreadPoolExecutor(args.decode_workers) as pool, \
            ThreadPoolExecutor(1) as prefetcher, \
            open(out_path, "w") as ans_file, torch.inference_mode():
        next_fut = (prefetcher.submit(decode_group, groups[0][2])
                    if groups else None)
        for gi, (start, group, padded) in enumerate(groups):
            decoded = next_fut.result()
            if gi + 1 < len(groups):
                next_fut = prefetcher.submit(decode_group, groups[gi + 1][2])
            flow, flow_mask, video_length = _flow_batch(
                model, decoded, timeline, bsz, args.flow_frames,
                args.max_flow_frames, fs)
            batch = {
                "frames": torch.from_numpy(
                    np.stack([d[0] for d in decoded])).to(model.device),
                "flow": flow,
                "flow_mask": flow_mask,
                "video_length": video_length,
                **text_batch(tok, sampler_tok,
                             [s["question"] for s in padded], TEXT_LEN,
                             model.device),
            }
            tokens, _ = generate(
                model, batch, dcfg,
                generator=step_generator(0, start, model.device),
                stop_sequences=stop_sequences)
            preds = tok.batch_decode(tokens.cpu().numpy(),
                                     skip_special_tokens=True)

            for s, pred in zip(group, preds[: len(group)]):
                row = {"id": s["id"], "question": s["question"],
                       "answer": s["answer"], "pred": pred}
                ans_file.write(json.dumps(row) + "\n")
                written += 1
                if written % 500 == 0:  # case printouts (inference.py:184-189)
                    print("==================CASE====================")
                    print("Question: ", s["question"])
                    print("Answer: ", s["answer"])
                    print("Prediction: ", pred)
    return out_path


if __name__ == "__main__":
    run_inference(parse_args())
