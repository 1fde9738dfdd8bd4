"""Performance probe: segment timings and ViT attention-layout variants.

The counterpart of the JAX package's ``tools/perfprobe.py``. Each
measurement prints one JSON line ``{"probe", "ms", ...}`` (the median of
``--iters`` synchronised calls after one warm call):

  vit    flagship-shape ViT layer stacks (1408 wide, 16 heads of 88, MLP
         6144, bf16) written as plain functions so the attention layouts
         can be compared:
           A: reshape -> transpose -> kernel A -> transpose back
           B: einsum projections straight to (B, H, S, D) and back, kernel A
           C: one fused QKV einsum, then B's, kernel A
           D: ``F.scaled_dot_product_attention`` on (B, S, H, D) views (the
              counterpart of XLA's dot_product_attention; a yardstick the
              port never calls, it replaces no kernel)
         and the MLP products alone. B, C and D report their largest
         difference from A on one layer (C's fused weight is A's three).
  raft   one RAFT flow pair at 224^2 (kernel B, 20 lookups a call), the
         feature net over both images, the correlation pyramid's build.
  model  the real ViT-g tower (bf16 parameters): kernel A, 39 a call.
  pipe   the flagship serving segments on the trace probe's model (bf16
         parameters, tanh GELU, RAFT in bf16): RAFT flow (B), ViT-g +
         Q-Former (A), the whole preparation (TGB, selection (D), ViT-g,
         Q-Former, T5 encoder (A)), the T5 decode, and ``generate_blip2``
         from flow frames (A, B and D).

    python -m videotgb_torch.tools.perfprobe vit|raft|model|pipe
        [--batch 128] [--layers 39] [--pairs 32] [--max_new 16] [--seq 257]
        [--iters 5] [--device cuda]

``--device cpu`` runs the plain versions of the kernels (use small shapes
there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
import torch.nn.functional as F

from videotgb_torch.device import resolve_device
from videotgb_torch.ops.attention import flash_attention
from videotgb_torch.utils.profiling import timed

H, HEADS, D, FF = 1408, 16, 88, 6144


def report(name, seconds, flops=None, extra=None) -> dict:
    rec = {"probe": name, "ms": round(seconds * 1000, 3)}
    if flops:
        rec["tflops_per_s"] = round(flops / seconds / 1e12, 1)
    rec.update(extra or {})
    print(json.dumps(rec), flush=True)
    return rec


def _sum(out):
    return out.float().sum()


# --------------------------------------------------------------------- ViT
def vit_weights(dev, gen, dtype=torch.bfloat16, width=H, heads=HEADS,
                ff=FF) -> dict:
    """The stack's weights; the layers read the widths from their shapes."""
    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    d = width // heads
    w = {k: rand(width, width) for k in ("wq", "wk", "wv", "wo")}
    w["w1"], w["w2"] = rand(width, ff), rand(ff, width)
    for k in ("wq", "wk", "wv"):
        w[k + "4"] = w[k].reshape(width, heads, d)
    w["wo4"] = w["wo"].reshape(heads, d, width)
    w["wqkv"] = torch.stack([w["wq4"], w["wk4"], w["wv4"]], dim=1)
    return w


def ln(x):
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


def mlp(x, w):
    return F.gelu(x @ w["w1"], approximate="tanh") @ w["w2"]


def layer_a(x, w):
    """Reshape and transpose around kernel A."""
    (b, s, width), (heads, d, _) = x.shape, w["wo4"].shape
    h = ln(x)

    def proj(name):
        return (h @ w[name]).reshape(b, s, heads, d).transpose(1, 2)

    ctx = flash_attention(proj("wq"), proj("wk"), proj("wv"), scale=d ** -0.5)
    x = x + ctx.transpose(1, 2).reshape(b, s, width) @ w["wo"]
    return x + mlp(ln(x), w)


def layer_b(x, w):
    """Einsum projections straight to (B, H, S, D) and back."""
    h = ln(x)
    q, k, v = (torch.einsum("bse,ehd->bhsd", h, w[n])
               for n in ("wq4", "wk4", "wv4"))
    ctx = flash_attention(q, k, v, scale=q.shape[-1] ** -0.5)
    x = x + torch.einsum("bhsd,hde->bse", ctx, w["wo4"])
    return x + mlp(ln(x), w)


def layer_c(x, w):
    """One fused QKV product."""
    h = ln(x)
    qkv = torch.einsum("bse,ethd->tbhsd", h, w["wqkv"])
    ctx = flash_attention(qkv[0], qkv[1], qkv[2],
                          scale=qkv.shape[-1] ** -0.5)
    x = x + torch.einsum("bhsd,hde->bse", ctx, w["wo4"])
    return x + mlp(ln(x), w)


def layer_d(x, w):
    """SDPA on (B, S, H, D) views, no hand-written kernel."""
    (b, s, width), (heads, d, _) = x.shape, w["wo4"].shape
    h = ln(x)

    def proj(name):
        return (h @ w[name]).reshape(b, s, heads, d).transpose(1, 2)

    ctx = F.scaled_dot_product_attention(proj("wq"), proj("wk"), proj("wv"),
                                         scale=d ** -0.5)
    x = x + ctx.transpose(1, 2).reshape(b, s, width) @ w["wo"]
    return x + mlp(ln(x), w)


VIT_LAYERS = {"A_current": layer_a, "B_einsum_bhsd": layer_b,
              "C_fused_qkv": layer_c, "D_sdpa_bshd": layer_d}


def stack(layer, x, w, layers):
    for _ in range(layers):
        x = layer(x, w)
    return x


def vit_probe(batch, layers, seq, dev, iters=5, width=H, heads=HEADS,
              ff=FF) -> list:
    """The layout variants at ViT-g's widths (smaller ``width``, ``heads``
    and ``ff`` for a quick run on the CPU)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = vit_weights(dev, gen, width=width, heads=heads, ff=ff)
    x = torch.randn((batch, seq, width), generator=gen,
                    device=dev).to(torch.bfloat16)
    flops = layers * batch * (4 * 2 * seq * width * width
                              + 2 * 2 * seq * width * ff
                              + 4 * seq * seq * width)
    rows = []
    with torch.no_grad():
        ref = layer_a(x, w).float()
        for name, layer in VIT_LAYERS.items():
            sec, _ = timed(lambda layer=layer: _sum(stack(layer, x, w,
                                                          layers)),
                           iters=iters)
            extra = {"batch": batch, "layers": layers}
            if name != "A_current":
                extra["max_abs_vs_a"] = float(
                    (layer(x, w).float() - ref).abs().max())
            rows.append(report(f"vit_{name}", sec, flops, extra))
        sec, _ = timed(lambda: _sum(stack(mlp, x, w, layers)), iters=iters)
        rows.append(report("matmul_mlp_only", sec,
                           batch * 2 * 2 * seq * width * ff * layers,
                           {"batch": batch}))
    return rows


# -------------------------------------------------------------------- RAFT
def raft_probe(pairs, dev, iters=5, res=224) -> list:
    from videotgb_torch.models.common import init_params
    from videotgb_torch.models.raft import RAFT, RAFTConfig
    from videotgb_torch.ops.correlation_pallas import build_corr_pyramid_t

    model = init_params(RAFT(RAFTConfig(), device=dev), seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((pairs, res, res, 3), generator=gen, device=dev) * 255.0
    img2 = torch.roll(img, 3, dims=2)
    rows = []
    with torch.no_grad():
        sec, _ = timed(lambda: _sum(model(img, img2)), iters=iters)
        rows.append(report("raft_full", sec, extra={
            "pairs": pairs, "ms_per_pair": round(sec * 1000 / pairs, 3)}))
        both = model._normalize(torch.cat([img, img2]))
        sec, _ = timed(lambda: _sum(model.fnet(both)), iters=iters)
        rows.append(report("raft_fnet_both", sec, extra={"pairs": pairs}))
        f1, f2 = (f.permute(0, 2, 3, 1)
                  for f in model.fnet(both).chunk(2, dim=0))
        sec, _ = timed(lambda: torch.stack(
            [lvl.float().sum() for lvl in build_corr_pyramid_t(f1, f2)]).sum(),
            iters=iters)
        rows.append(report("raft_corr_build", sec, extra={"pairs": pairs}))
    return rows


# ------------------------------------------------------------------- model
def model_probe(batch, dev, iters=5, preset="flagship") -> list:
    from videotgb_torch.models.common import init_params
    from videotgb_torch.models.vit import ViTConfig, ViTModel

    cfg = ViTConfig() if preset == "flagship" else ViTConfig.tiny()
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    model = init_params(ViTModel(cfg, device=dev), seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    px = torch.rand((batch, cfg.image_size, cfg.image_size, 3),
                    generator=gen, device=dev)
    s, hid = cfg.seq_len, cfg.hidden_size
    flops = batch * cfg.num_layers * (
        4 * 2 * s * hid * hid + 2 * 2 * s * hid * cfg.intermediate_size
        + 4 * s * s * hid)
    with torch.no_grad():
        sec, _ = timed(lambda: _sum(model(px)), iters=iters)
    return [report("vit_flagship" if preset == "flagship" else
                   f"vit_{preset}", sec, flops, {"batch": batch})]


# -------------------------------------------------------------------- pipe
def pipe_probe(batch, dev, max_new=16, flow_frames=4, iters=5,
               model=None) -> list:
    """``model`` reuses a model built by ``traceprobe.serving_model``."""
    from videotgb_torch.models.videotgb import (
        generate_blip2,
        t5_generate_from_encoder,
    )
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.tools.traceprobe import TEXT_LEN, serving_model

    model = model or serving_model(dev)
    cfg = model.config
    image, fs = cfg.blip2.vit.image_size, cfg.tgb.flow_size
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.full((batch, TEXT_LEN), 200, dtype=torch.long, device=dev)
    ones = torch.ones((batch, TEXT_LEN), device=dev)
    bd = {"frames": torch.rand((batch, cfg.num_frames, image, image, 3),
                               generator=gen, device=dev),
          "sampler_question_ids": ids, "sampler_question_mask": ones,
          "question_ids": ids, "question_mask": ones,
          "flow_mask": torch.ones((batch, flow_frames + 2), device=dev),
          "video_length": torch.full((batch,), flow_frames, device=dev)}
    flow_rgb = torch.rand((batch, flow_frames + 1, fs, fs, 3), generator=gen,
                          device=dev) * 255.0
    dcfg = DecodeConfig(max_new_tokens=max_new, eos_token_id=-1,
                        pad_token_id=0)
    rows = []

    def prepare(flow):
        return model.prepare_t5_inference(
            bd["frames"], flow, bd["flow_mask"], bd["video_length"], ids,
            ones, ids, ones, generator=torch.Generator(
                device=dev).manual_seed(1))

    with torch.no_grad():
        sec, _ = timed(lambda: _sum(model.flow_features(flow_rgb)),
                       iters=iters)
        rows.append(report("pipe_raft_flow", sec, extra={
            "batch": batch, "pairs": batch * flow_frames}))
        flow = model.flow_features(flow_rgb)
        cand = torch.arange(cfg.nframe, device=dev).expand(batch, -1)
        sec, _ = timed(lambda: _sum(model.encode_selected(bd["frames"],
                                                          cand)),
                       iters=iters)
        rows.append(report("pipe_vit_qformer", sec,
                           extra={"frames": batch * cfg.nframe}))
        sec, _ = timed(lambda: _sum(prepare(flow)[0]), iters=iters)
        rows.append(report("pipe_prepare_all", sec, extra={"batch": batch}))
        enc_hidden, enc_mask, _ = prepare(flow)
        sec, _ = timed(lambda: t5_generate_from_encoder(
            model, enc_hidden, enc_mask, dcfg, gen), iters=iters)
        rows.append(report("pipe_t5_decode", sec,
                           extra={"batch": batch, "max_new": max_new}))
        sec, _ = timed(lambda: generate_blip2(
            model, dict(bd, flow=model.flow_features(flow_rgb)), dcfg,
            generator=torch.Generator(device=dev).manual_seed(1))[0],
            iters=iters)
        rows.append(report("pipe_full", sec, extra={"batch": batch}))
    return rows


def main(argv=None, model=None) -> list:
    """``model`` (``pipe`` only) reuses a model built by
    ``traceprobe.serving_model``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=["vit", "raft", "model", "pipe"])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--layers", type=int, default=39)
    ap.add_argument("--pairs", type=int, default=32)
    ap.add_argument("--max_new", type=int, default=16)
    ap.add_argument("--seq", type=int, default=257)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    dev = model.device if model is not None else resolve_device(args.device)
    if args.which == "vit":
        return vit_probe(args.batch, args.layers, args.seq, dev, args.iters)
    if args.which == "raft":
        return raft_probe(args.pairs, dev, args.iters)
    if args.which == "pipe":
        return pipe_probe(args.batch, dev, args.max_new, iters=args.iters,
                          model=model)
    return model_probe(args.batch, dev, args.iters)


if __name__ == "__main__":
    main()
