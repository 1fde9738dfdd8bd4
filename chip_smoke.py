#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``videotgb_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):

1. the card's name and power limit (``nvidia-smi``), then an ``nvcc`` build
   of every kernel in ``videotgb_torch/csrc`` (one process per source);
2. kernel A (flash-attention forward) against its plain PyTorch version at
   the main-path shape (ViT-g: 16 images x 16 heads x 264 x 88, bf16, a
   (1,1,1,264) pad bias) and at the other bias layouts, f32, and a fully
   masked row; timed beside the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls);
3. kernel B (RAFT correlation lookup) against its plain version at 16 pairs,
   28x28 queries, 4 levels, r = 4, f32 and bf16, coordinates partly off the
   image; timed beside the plain version;
4. the main path at flagship width (ViT-g, Q-Former, Flan-T5-xl, TGB
   BERT-base, RAFT; random weights from a seed) for 4 requests:
   ``select_phase_blip2`` -> gather -> ``answer_phase_blip2``, then
   ``flow_features`` + ``generate_blip2`` on the same batch, with exact
   launch counts of both kernels; the ViT once without the flash kernel and
   RAFT once without the lookup kernel, against the kernel path.

The last three lines are a JSON object of per-kernel numbers, the card's
name and power limit, and a JSON object ``{"ok": true, "device": {...}}``.
Needs one CUDA card; exits non-zero without one, or without the package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, atol, rtol, reason) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    log(f"  {name}: max_abs_err {max_err:.3e} (tolerance atol {atol:g} + "
        f"rtol {rtol:g}: {reason}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_err


def rel_diff(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------------------------ kernel A
def check_flash(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from videotgb_torch.ops.attention import NEG_INF, dot_product_attention, flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.bfloat16: (2e-2, 2e-2, "bf16 output rounding (ulp 2^-8) "
                            "plus a different f32 summation order"),
           torch.float32: (1e-4, 1e-4, "f32 summation order only")}

    def qkv(b, h, s, d, dtype):
        # the main path hands (B, S, H, D) projections over as strided views
        return [torch.randn((b, s, h, d), generator=gen, device=dev).to(
            dtype).transpose(1, 2) for _ in range(3)]

    def case(name, b, h, s, d, dtype, bias):
        q, k, v = qkv(b, h, s, d, dtype)
        got = flash_attention(q, k, v, bias)
        want = dot_product_attention(q, k, v, bias)
        torch.cuda.synchronize()
        atol, rtol, why = tol[dtype]
        return check_close(f"flash {name}", got, want, atol, rtol, why), (q, k, v)

    b, h, s, d = 16, 16, 264, 88
    keys = torch.arange(s, device=dev)
    pad_bias = torch.where(keys < 257, 0.0, NEG_INF).float()[None, None, None]
    err_main, (q, k, v) = case("main (16,16,264,88) bf16 pad bias (1,1,1,264)",
                               b, h, s, d, torch.bfloat16, pad_bias)
    lens = torch.randint(100, s + 1, (b,), generator=gen, device=dev)
    per_batch = torch.where(keys[None] < lens[:, None], 0.0,
                            NEG_INF).float()[:, None, None]
    case("per-batch padding bias (B,1,1,S)", b, h, s, d, torch.bfloat16,
         per_batch)
    case("per-row bias (B,H,S,S)", 2, h, s, d, torch.bfloat16,
         torch.randn((2, h, s, s), generator=gen, device=dev))
    case("learned bias (1,H,S,S) S=300 D=64", 2, 12, 300, 64, torch.bfloat16,
         torch.randn((1, 12, 300, 300), generator=gen, device=dev))
    case("no bias", 4, h, s, d, torch.bfloat16, None)
    case("f32 pad bias", 4, h, s, d, torch.float32, pad_bias)
    masked = torch.zeros((1, 1, s, s), device=dev)
    masked[..., 10, :] = NEG_INF
    err, (mq, mk, mv) = case("fully masked row 10", 2, h, s, d, torch.float32,
                             masked)
    row = flash_attention(mq, mk, mv, masked)[:, :, 10]
    check_close("flash masked row = mean of v", row, mv.float().mean(dim=2),
                1e-4, 1e-4, "the plain softmax's uniform average")

    scale = d ** -0.5
    ms = time_ms(lambda: flash_attention(q, k, v, pad_bias))
    plain_ms = time_ms(lambda: dot_product_attention(q, k, v, pad_bias))
    mask_bf16 = pad_bias.to(torch.bfloat16)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_bf16, scale=scale))
    elem = q.element_size()
    nbytes = 4 * b * h * s * d * elem + pad_bias.numel() * 4
    flops = 4 * b * h * s * s * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"  flash main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {lib_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) on {card}")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "videotgb_torch/csrc/flash_fwd.cu",
            "replaces": "videotgb_tpu/ops/attention.py:54",
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


# ------------------------------------------------------------------ kernel B
def lookup_needed_bytes(pyramid, coords, radius) -> int:
    """Bytes the lookup must read: per query, the in-range part of the
    (2r+2)^2 corner window of each level (each query owns its column of the
    query-minor pyramid), plus coords and the output."""
    import torch

    p, h, w, _ = coords.shape
    from videotgb_torch.ops.correlation_pallas import level_sizes

    total = 0
    sizes = level_sizes(h, w, len(pyramid))
    for lvl, (level, (hl, wl)) in enumerate(zip(pyramid, sizes)):
        fx = torch.floor(coords[..., 0] / 2 ** lvl)
        fy = torch.floor(coords[..., 1] / 2 ** lvl)
        nx = (torch.clamp(fx + radius + 1, max=wl - 1)
              - torch.clamp(fx - radius, min=0) + 1).clamp(min=0)
        ny = (torch.clamp(fy + radius + 1, max=hl - 1)
              - torch.clamp(fy - radius, min=0) + 1).clamp(min=0)
        total += int((nx * ny).sum()) * level.element_size()
    k = 2 * radius + 1
    out = p * h * w * len(pyramid) * k * k * pyramid[0].element_size()
    return total + coords.numel() * 4 + out


def check_lookup(card: str) -> dict:
    import torch

    from videotgb_torch.ops.correlation_pallas import (
        build_corr_pyramid_t,
        lookup_corr_pyramid_t,
        lookup_corr_pyramid_t_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    pairs, hw, radius = 16, 28, 4
    f1, f2 = (torch.randn((pairs, hw, hw, 256), generator=gen, device=dev)
              for _ in range(2))
    coords = torch.rand((pairs, hw, hw, 2), generator=gen,
                        device=dev) * 44.0 - 8.0  # partly off the 28x28 map
    out = None
    for dtype, (atol, rtol, why) in (
            (torch.float32, (1e-4, 1e-4, "f32 sums, 2-tap vs dense hat order")),
            (torch.bfloat16, (2e-2, 2e-2, "both round f32 sums to bf16: "
                              "<= 1 ulp (2^-8 relative) apart"))):
        pyr = build_corr_pyramid_t(f1.to(dtype), f2.to(dtype), 4)
        got = lookup_corr_pyramid_t(pyr, coords, radius)
        want = lookup_corr_pyramid_t_plain(pyr, coords, radius)
        torch.cuda.synchronize()
        if got.dtype != dtype or tuple(got.shape) != (pairs, hw, hw, 324):
            fail(f"lookup output {got.dtype} {tuple(got.shape)}")
        err = check_close(f"lookup {dtype}", got, want, atol, rtol, why)
        ms = time_ms(lambda: lookup_corr_pyramid_t(pyr, coords, radius))
        plain_ms = time_ms(lambda: lookup_corr_pyramid_t_plain(pyr, coords,
                                                               radius))
        nbytes = lookup_needed_bytes(pyr, coords, radius)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  lookup {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB needed) on {card}")
        if dtype == torch.bfloat16:  # the serving path's pyramid dtype
            out = {"name": "corr_lookup", "route": "cuda",
                   "source": "videotgb_torch/csrc/corr_lookup.cu",
                   "replaces": "videotgb_tpu/ops/correlation_pallas.py:73",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": "bytes", "library_ms": None}
    return out


# ------------------------------------------------------------- request batch
def _batch(cfg, b, l_flow, text_len, gen, dev):
    import torch

    tgb_vocab = min(cfg.tgb.vocab_size, 5000)
    lm_vocab = min(cfg.blip2.t5.vocab_size, 5000)
    lo = 4 if tgb_vocab < 200 else 100
    return {
        "flow_mask": torch.ones((b, l_flow + 2), device=dev),
        "video_length": torch.full((b,), l_flow, device=dev),
        "sampler_question_ids": torch.randint(lo, tgb_vocab, (b, text_len),
                                              generator=gen, device=dev),
        "sampler_question_mask": torch.ones((b, text_len), device=dev),
        "question_ids": torch.randint(lo, lm_vocab, (b, text_len),
                                      generator=gen, device=dev),
        "question_mask": torch.ones((b, text_len), device=dev),
    }


# --------------------------------------------------------- flagship main path
def main_path(card: str) -> dict:
    import torch

    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.decode import DecodeConfig

    dev = torch.device("cuda")
    cfg = V.bf16_param_config(V.VideoTGBConfig.flagship())
    # serving precision: RAFT's convolutions in bf16, params/norms/flow f32
    cfg = dataclasses.replace(
        cfg, raft=dataclasses.replace(cfg.raft, dtype=torch.bfloat16))
    t0 = time.perf_counter()
    model = V.VideoTGB(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  flagship built on the card: {n_params / 1e6:.1f}M params in "
        f"{build_s:.2f} s")

    b, n_flow, text_len, img = 4, 5, 24, cfg.blip2.vit.image_size
    gen = torch.Generator(device=dev).manual_seed(0)
    frames_u8 = torch.randint(0, 256, (b, cfg.num_frames, img, img, 3),
                              generator=gen, device=dev, dtype=torch.uint8)
    fs = cfg.tgb.flow_size
    flow_u8 = torch.randint(0, 256, (b, n_flow, fs, fs, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
    batch = _batch(cfg, b, n_flow - 1, text_len, gen, dev)
    dcfg = DecodeConfig(max_new_tokens=16,
                        eos_token_id=cfg.blip2.t5.eos_token_id,
                        pad_token_id=cfg.blip2.t5.pad_token_id)
    vocab = cfg.blip2.t5.vocab_size
    sel_gen = torch.Generator(device=dev)
    times = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return out

    def counts():
        return dict(kernels.LAUNCHES)

    def check_tokens(name, tokens):
        if tuple(tokens.shape) != (b, 16):
            fail(f"{name}: tokens {tuple(tokens.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
            fail(f"{name}: token ids outside the vocabulary")

    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=dev)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=dev)

    def drive():
        """select -> gather -> answer, then flow_features + generate on the
        same batch; launch counts are read after each phase."""
        snaps = {}
        sel_gen.manual_seed(7)
        cand = run("select_phase_blip2", lambda: V.select_phase_blip2(
            model, flow_u8, batch, generator=sel_gen))
        snaps["select"] = counts()
        sel = run("gather", lambda: frames_u8[
            torch.arange(b, device=dev)[:, None], cand])
        tokens = run("answer_phase_blip2", lambda: V.answer_phase_blip2(
            model, sel, batch, dcfg))
        snaps["answer"] = counts()
        flow = run("flow_features", lambda: model.flow_features(
            flow_u8.float()))
        frames = (frames_u8.float() / 255.0 - mean) / std
        full = dict(batch, frames=frames, flow=flow)
        sel_gen.manual_seed(7)
        tokens_g, cand_g = run("generate_blip2", lambda: V.generate_blip2(
            model, full, dcfg, generator=sel_gen))
        snaps["end"] = counts()
        return cand, sel, tokens, flow, tokens_g, cand_g, snaps

    # one untimed, uncounted pass first: cuDNN / cuBLAS plans, lazy kernel
    # loading and the caching allocator's first allocations
    drive()
    cold = dict(times)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    cand, sel, tokens, flow, tokens_g, cand_g, snaps = drive()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    after_select, after_answer, end = snaps["select"], snaps["answer"], \
        snaps["end"]
    if tuple(cand.shape) != (b, cfg.nframe) or int(cand.min()) < 0 or \
            int(cand.max()) >= cfg.num_frames:
        fail(f"cand_index {tuple(cand.shape)} out of range")
    check_tokens("answer_phase_blip2", tokens)
    if not torch.isfinite(flow).all() or tuple(flow.shape) != (
            b, n_flow - 1, fs, fs, 2):
        fail(f"flow features {tuple(flow.shape)} not finite")
    check_tokens("generate_blip2", tokens_g)

    per_phase = {
        "select_phase_blip2": {k: after_select[k] for k in end},
        "answer_phase_blip2": {k: after_answer[k] - after_select[k]
                               for k in end},
        "flow_features + generate_blip2": {k: end[k] - after_answer[k]
                                           for k in end}}
    expected = {
        "select_phase_blip2": {"flash_fwd": 0, "corr_lookup": cfg.raft.iters},
        "answer_phase_blip2": {"flash_fwd": cfg.blip2.vit.num_layers,
                               "corr_lookup": 0},
        "flow_features + generate_blip2": {
            "flash_fwd": cfg.blip2.vit.num_layers,
            "corr_lookup": cfg.raft.iters}}
    for phase, want in expected.items():
        log(f"  launches in {phase}: {per_phase[phase]} (expected {want})")
        if per_phase[phase] != want:
            fail(f"launch counts of {phase}: {per_phase[phase]} != {want}")
    agree = float((tokens_g == tokens).float().mean())
    log(f"  generate_blip2 vs two-phase (same flow, same noise seed): "
        f"cand equal {torch.equal(cand_g, cand)}, greedy tokens agree on "
        f"{agree:.3f}")
    for name, ms in times.items():
        log(f"  wall {name}: {ms:.2f} ms warm ({cold[name]:.2f} ms on the "
            f"first pass) on {card}")
    log(f"  peak device memory {peak_gib:.2f} GiB on {card}")

    # kernel paths against the plain paths, end to end
    with torch.no_grad():
        sel_frames = ((sel.float() / 255.0 - mean) / std).reshape(
            b * cfg.nframe, img, img, 3)
        vit = model.model.vision_model
        flash_out = vit(sel_frames)
        for layer in vit.layers:
            layer.attn.use_flash = False
        plain_out = vit(sel_frames)
        for layer in vit.layers:
            layer.attn.use_flash = True
        vit_diff = rel_diff(flash_out, plain_out)
        raft = model.of_extractor
        raft.config = dataclasses.replace(raft.config, fused_lookup=False)
        dense_flow = model.flow_features(flow_u8.float())
        raft.config = dataclasses.replace(raft.config, fused_lookup=None)
    checks = [
        ("ViT-g flash vs use_flash=False", vit_diff, 5e-2,
         "the two attentions differ by bf16 rounding (2^-8) per layer; over "
         "39 residual layers that walks to ~sqrt(39)*2^-8 = 2.4%"),
        ("flow features: kernel path vs fused_lookup=False", rel_diff(
            flow, dense_flow), 2e-2,
         "the dense path keeps an f32 pyramid where the kernel path keeps "
         "bf16 (as in the JAX package), 20 GRU iterations on random weights"),
    ]
    for name, diff, tol, why in checks:
        log(f"  {name}: relative difference {diff:.3e} (tolerance {tol:g}: "
            f"{why}) {'ok' if diff <= tol else 'MISMATCH'}")
        if not diff <= tol:
            fail(name)
    # where the time of one request batch goes, warm, tower by tower
    parts = {}

    def part(name, fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t) * 1e3 / reps
        return out

    with torch.no_grad():
        blip2 = model.model
        lm = blip2.language_model
        part("raft flow_features", lambda: model.flow_features(flow_u8.float()))
        part("tgb span_logits", lambda: model.span_logits(
            flow, batch["flow_mask"], batch["sampler_question_ids"],
            batch["sampler_question_mask"]))
        emb = part("vit", lambda: blip2.vision_model(sel_frames))
        query = blip2.query_tokens.to(emb.dtype).expand(emb.shape[0], -1, -1)
        visual = part("qformer + pool + projection", lambda: (
            blip2.language_projection(blip2.qformer(query, emb).reshape(
                b, cfg.nframe, query.shape[1], -1).mean(dim=1))))
        embeds, mask = blip2.encoder_inputs(visual, batch["question_ids"],
                                            batch["question_mask"])
        enc = part("t5 encode", lambda: lm.encode(embeds, mask))
        part("t5 decode (16 greedy steps)", lambda: V.t5_generate_from_encoder(
            model, enc, mask, dcfg))
    for name, ms in parts.items():
        log(f"  component {name}: {ms:.2f} ms on {card}")
    return {"flash_fwd": end["flash_fwd"], "corr_lookup": end["corr_lookup"]}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        from videotgb_torch.ops import kernels
    except ImportError as e:
        fail(f"the videotgb_torch package is not beside chip_smoke.py ({e})")

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    build_s = time.perf_counter() - t0
    log(f"phase 1: built {sorted(kernels.SOURCES)} in {build_s:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 2: kernel A, flash-attention forward")
    flash = check_flash(card)
    log("phase 3: kernel B, correlation lookup")
    lookup = check_lookup(card)
    log("phase 4: flagship main path, 4 requests")
    launches = main_path(card)
    flash["launches"] = launches["flash_fwd"]
    lookup["launches"] = launches["corr_lookup"]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    line = {"kernels": [{k: kern[k] for k in order} for kern in (flash, lookup)]}
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
