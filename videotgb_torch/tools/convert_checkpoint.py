"""Checkpoint conversion CLI: released torch weights -> a port checkpoint
(the port's counterpart of ``videotgb_tpu/tools/convert_checkpoint.py``,
the same flags).

Assembles a whole VideoTGB from the published checkpoints:

  --backbone_dir   HF BLIP2 / InstructBLIP model dir (config.json +
                   pytorch_model*.bin / *.safetensors)
  --bert_dir       bert-base-uncased dir (TGB initialization)
  --sampler_path   the reference's trained TGB sampler.pth (overrides bert)
  --raft_path      raft-sintel.pth (DataParallel prefixes handled)
  --lightning_ckpt a reference Lightning .ckpt (full model state_dict with
                   model./temporal_encoder./of_extractor. prefixes)

and writes a ``training.checkpoint.CheckpointManager`` checkpoint (step 0,
its ``params`` item) that ``evalsuite.inference.load_model``, the QA CLI,
``ServingEngine`` and the demo restore with ``--model_path <dir>``
(``--preset`` / ``--backbone`` naming the same config). Sources not given
keep the seeded random init of their subtree, as the reference's
``from_pretrained`` does with its fresh heads. It launches no kernel, so it
assembles the model on the CPU.

  python -m videotgb_torch.tools.convert_checkpoint --preset flagship \\
      --backbone blip2 --backbone_dir /ckpts/blip2-flan-t5-xl \\
      --bert_dir /ckpts/bert-base-uncased --raft_path /ckpts/raft-sintel.pth \\
      --output outputs/converted
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from typing import Mapping

import numpy as np
import torch


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a .pth/.bin/.ckpt/safetensors file (or an HF model dir) into
    numpy (bf16 tensors widened to f32, exactly), stripping DataParallel
    'module.' prefixes (raft_utils/utils.py:85-91 semantics)."""
    state: dict = {}
    if os.path.isdir(path):
        files = sorted(
            glob.glob(os.path.join(path, "*.safetensors"))
            or glob.glob(os.path.join(path, "pytorch_model*.bin"))
            or glob.glob(os.path.join(path, "*.pth"))
        )
        if not files:
            raise FileNotFoundError(f"no weight files under {path}")
        for f in files:
            state.update(load_torch_state_dict(f))
        return state
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        raw = load_file(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
    out = {}
    for k, v in raw.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if torch.is_tensor(v):
            v = v.float() if v.dtype == torch.bfloat16 else v
            out[k] = v.numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _backbone(sd: Mapping, bb, backbone: str, lm_required=True) -> dict:
    """The flat dict of an HF BLIP2 / InstructBLIP state dict: ViT, Q-Former,
    query tokens, the projections it has, and the language model (where it
    has one, unless ``lm_required``)."""
    from videotgb_torch.training import hf_convert as C

    instruct = backbone in ("instructblip", "instructblip_t5")
    out = C.with_subtree(
        C.convert_blip2_vision(sd, bb.vit.num_layers, "vision_model."),
        "model", "vision_model")
    out.update(C.with_subtree(
        C.convert_blip2_qformer(sd, bb.qformer.num_layers,
                                bb.qformer.cross_attention_frequency,
                                "qformer.", instruct=instruct),
        "model", "qformer"))
    if "query_tokens" in sd:
        out[("model", "query_tokens")] = np.asarray(sd["query_tokens"])
    for proj in ("language_projection", "temporal_projection"):
        if f"{proj}.weight" in sd:
            out[("model", proj, "kernel")] = np.asarray(
                sd[f"{proj}.weight"]).T
            out[("model", proj, "bias")] = np.asarray(sd[f"{proj}.bias"])
    if lm_required or any(k.startswith("language_model.") for k in sd):
        if backbone in ("blip2", "instructblip_t5"):
            lm = C.convert_t5(sd, bb.t5.num_encoder_layers,
                              bb.t5.num_decoder_layers, "language_model.")
        else:
            lm = C.convert_llama(sd, bb.llm.num_layers, "language_model.")
        out.update(C.with_subtree(lm, "model", "language_model"))
    return out


def build_model(args):
    """The VideoTGB of ``preset`` / ``backbone`` (seeded random init from
    ``seed``) with every given source grafted in. Returns (model, cfg)."""
    from videotgb_torch.models.videotgb import VideoTGB, VideoTGBConfig
    from videotgb_torch.training import hf_convert as C

    cfg = getattr(VideoTGBConfig, args.preset)(args.backbone)
    if getattr(args, "flow_size", None):
        # the released sampler.pth embeds 224^2 flow patches regardless of
        # preset (xropebert TemporalOFEmbedding hardcodes 224//16 patches)
        cfg = dataclasses.replace(
            cfg, tgb=dataclasses.replace(cfg.tgb, flow_size=args.flow_size))
    model = VideoTGB(cfg, device="cpu", seed=args.seed)
    bb = cfg.blip2 or cfg.instructblip
    flat: dict = {}

    def tgb(sd):
        return C.with_subtree(C.convert_reference_tgb(
            sd, cfg.tgb.num_layers, cfg.tgb.fusion_layer), "temporal_encoder")

    if args.backbone_dir:
        flat.update(_backbone(load_torch_state_dict(args.backbone_dir), bb,
                              args.backbone))
    if args.sampler_path:
        flat.update(tgb(load_torch_state_dict(args.sampler_path)))
    elif args.bert_dir:
        sd = load_torch_state_dict(args.bert_dir)
        prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
        flat.update(C.with_subtree(
            C.convert_bert_to_tgb(sd, cfg.tgb.num_layers, prefix),
            "temporal_encoder"))
    if args.raft_path:
        flat.update(C.with_subtree(
            C.convert_raft(load_torch_state_dict(args.raft_path)),
            "of_extractor"))
    if args.lightning_ckpt:
        sd = load_torch_state_dict(args.lightning_ckpt)
        sub = _strip_prefix(sd, "temporal_encoder.")
        if sub:
            flat.update(tgb(sub))
        sub = _strip_prefix(sd, "of_extractor.")
        if sub:
            flat.update(C.with_subtree(C.convert_raft(sub), "of_extractor"))
        # the backbone under "model." carries the HF names: convert all of
        # it, as --backbone_dir does, since a Lightning checkpoint holds the
        # stage-3-trained query tokens, projections and language model
        sub = _strip_prefix(sd, "model.")
        if sub:
            flat.update(_backbone(sub, bb, args.backbone, lm_required=False))
    C.graft(model, flat, strict=not args.lenient)
    return model, cfg


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="flagship")
    p.add_argument("--backbone",
                   choices=["blip2", "instructblip", "instructblip_t5"],
                   default="blip2")
    p.add_argument("--backbone_dir", default=None)
    p.add_argument("--bert_dir", default=None)
    p.add_argument("--sampler_path", default=None)
    p.add_argument("--raft_path", default=None)
    p.add_argument("--lightning_ckpt", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flow_size", type=int, default=None,
                   help="override cfg.tgb.flow_size (released sampler.pth "
                        "is built for 224)")
    p.add_argument("--lenient", action="store_true",
                   help="ignore source entries with no destination")
    args = p.parse_args(argv)

    from videotgb_torch.training.checkpoint import (
        CheckpointConfig,
        CheckpointManager,
    )

    model, _ = build_model(args)
    mgr = CheckpointManager(CheckpointConfig(directory=args.output))
    mgr.save(0, {"params": model.state_dict(), "step": 0})
    mgr.wait()
    print(f"converted checkpoint written to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
