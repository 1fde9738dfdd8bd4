"""The port's InstructBLIP-Vicuna slice against the JAX package on the CPU:
``llama_rope``, ``LlamaModel`` without and with KV caches,
``InstructBlipModel.encode_frames``, ``prepare_llama_inference``, and the
whole pipeline (``generate_instructblip``; ``select_phase_blip2`` in
"multi_modal" / "ratio" + ``answer_phase_instructblip``), with right-padded
prompts of different lengths in one batch; the instructblip_t5 variant end
to end; plain attention at kernel A's Vicuna-prefill shape class against
the Pallas kernel in interpret mode.

Both sides run the tiny configs in f32 with one set of numpy weights from a
seed (``tests/_torch_port_helpers.py``) and share the JAX selection's
Gumbel draws. Every JAX function is jitted once per shape."""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401
    Pair,
    close,
    few_torch_threads,
    gumbel_like,
    t,
)
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.models import videotgb as TV
from videotgb_torch.ops import attention as TA
from videotgb_torch.ops.decode import DecodeConfig as TDecode
from videotgb_torch.ops.rope import llama_rope
from videotgb_tpu.data.constants import CLIP_MEAN, CLIP_STD
from videotgb_tpu.models import videotgb as JV
from videotgb_tpu.ops import attention as JA
from videotgb_tpu.ops.decode import DecodeConfig as JDecode
from videotgb_tpu.ops.rope import llama_rope as jax_llama_rope

DECODE = dict(max_new_tokens=5, eos_token_id=2, pad_token_id=0)
BATCH_KEYS = ("flow_mask", "video_length", "sampler_question_ids",
              "sampler_question_mask", "question_ids", "question_mask",
              "qformer_input_ids", "qformer_attention_mask")


@pytest.fixture(scope="module")
def pair():
    return Pair(backbone="instructblip")


@pytest.fixture(scope="module")
def batches(pair):
    return _batches(pair)


def _batches(pair):
    """The JAX and the port batch of the tiny pipeline: prompts right-padded
    to 6 with 6 and 3 real tokens, the instruction 5 and 4."""
    x = dict(pair.inputs)
    x["question_mask"] = np.array([[1] * 6, [1] * 3 + [0] * 3], np.float32)
    x["qformer_input_ids"] = x["sampler_question_ids"]
    x["qformer_attention_mask"] = np.array([[1] * 5, [1] * 4 + [0]],
                                           np.float32)
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    jb = {k: jnp.asarray(x[k]) for k in BATCH_KEYS}
    jb["frames"] = jnp.asarray(
        (x["frames_u8"].astype(np.float32) / 255.0 - mean) / std)
    jb["flow"] = pair.japply(lambda m, f: m.flow_features(f),
                             jnp.asarray(x["flow_u8"], jnp.float32))
    tb = {k: t(v) for k, v in jb.items()}
    for k in ("sampler_question_ids", "question_ids", "qformer_input_ids"):
        tb[k] = tb[k].long()
    return jb, tb


def _llm(pair):
    return pair.tmodel.model.language_model


# ------------------------------------------------------------------- rope
@pytest.mark.parametrize("d", [8, 128])
def test_llama_rope_matches_jax(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 5, 3, d)).astype(np.float32)  # (B, S, H, D)
    positions = np.array([[0, 1, 2, 2, 2], [7, 8, 9, 10, 300]], np.int32)
    want = jax.jit(jax_llama_rope)(jnp.asarray(x), jnp.asarray(positions))
    got = llama_rope(t(x).transpose(1, 2), t(positions).long())
    close(got.transpose(1, 2), want)


# ------------------------------------------------------------------ LLaMA
def test_llama_without_caches_matches_jax(pair):
    """Causal + right padding over [visual | prompt] embeddings."""
    rng = np.random.default_rng(1)
    d = pair.jcfg.instructblip.llm.hidden_size
    embeds = rng.standard_normal((2, 7, d)).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3], np.float32)
    want = pair.japply(lambda m, e, a: m.model.language_model(
        inputs_embeds=e, attention_mask=a)[0], embeds, mask)
    with torch.no_grad():
        got, caches = _llm(pair)(inputs_embeds=t(embeds),
                                 attention_mask=t(mask))
    assert caches is None
    close(got, want)


def test_llama_with_caches_matches_jax(pair):
    """A prefill at S = 6 into a 10-slot buffer, then 3 single-token steps:
    the logits and every layer's written K/V after each call; the same
    calls with the cache index a 0-dim tensor (the graphed decode's device
    index: the cache write, the positions and the mask from it) give the
    same logits and caches bit for bit."""
    cfg = pair.jcfg.instructblip.llm
    b, s, slots = 2, 6, 10
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((b, s, cfg.hidden_size)).astype(np.float32)
    prompt = np.array([[1] * 6, [1] * 4 + [0] * 2], np.float32)
    positions = np.clip(np.cumsum(prompt, 1).astype(np.int32) - 1, 0, None)
    lengths = prompt.sum(1).astype(np.int32)
    jcaches = [{"k": jnp.zeros((b, cfg.num_heads, slots, cfg.head_dim)),
                "v": jnp.zeros((b, cfg.num_heads, slots, cfg.head_dim))}
               for _ in range(cfg.num_layers)]
    tcaches = _llm(pair).init_caches(b, slots)
    dcaches = _llm(pair).init_caches(b, slots)

    def step(m, caches, index, valid, pos, embeds=None, tokens=None):
        return m.model.language_model(
            input_ids=tokens, inputs_embeds=embeds, positions=pos,
            caches=caches, cache_index=index, cache_positions_valid=valid)

    prefill = jax.jit(lambda p, c, i, v, pos, e: pair.jmodel.apply(
        p, c, i, v, pos, e, method=step))
    decode = jax.jit(lambda p, c, i, v, pos, tok: pair.jmodel.apply(
        p, c, i, v, pos, tokens=tok, method=step))
    valid = np.concatenate([prompt, np.zeros((b, slots - s), np.float32)], 1)
    want, jcaches = prefill(pair.params, jcaches, jnp.int32(0), valid,
                            positions, embeds)
    with torch.no_grad():
        got, tcaches = _llm(pair)(
            inputs_embeds=t(embeds), positions=t(positions).long(),
            caches=tcaches, cache_index=0, cache_positions_valid=t(valid))
        got_d, dcaches = _llm(pair)(
            inputs_embeds=t(embeds), positions=t(positions).long(),
            caches=dcaches, cache_index=torch.tensor(0),
            cache_positions_valid=t(valid))
    def snapshot(caches):  # the port writes its buffers in place
        return [{n: c[n].clone() for n in c} for c in caches]

    calls = [(got, want, snapshot(tcaches), jcaches)]
    device = [(got_d, snapshot(dcaches))]
    for i in range(3):
        tokens = rng.integers(3, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = (lengths + i)[:, None]
        valid[:, s + i] = 1.0
        want, jcaches = decode(pair.params, jcaches, jnp.int32(s + i), valid,
                               pos, tokens)
        with torch.no_grad():
            got, tcaches = _llm(pair)(
                input_ids=t(tokens).long(), positions=t(pos).long(),
                caches=tcaches, cache_index=s + i,
                cache_positions_valid=t(valid))
            got_d, dcaches = _llm(pair)(
                input_ids=t(tokens).long(), positions=t(pos).long(),
                caches=dcaches, cache_index=torch.tensor(s + i),
                cache_positions_valid=t(valid))
        calls.append((got, want, snapshot(tcaches), jcaches))
        device.append((got_d, snapshot(dcaches)))
    for (got, want, tc, jc), (got_d, dc) in zip(calls, device):
        close(got, want)
        assert torch.equal(got_d, got)
        for tl, jl, dl in zip(tc, jc, dc):
            close(tl["k"], jl["k"])
            close(tl["v"], jl["v"])
            assert torch.equal(dl["k"], tl["k"])
            assert torch.equal(dl["v"], tl["v"])


# ----------------------------------------------------------- InstructBLIP
def test_encode_frames_with_instruction_matches_jax(pair):
    """ViT -> instruction-aware Q-Former (a padded instruction) ->
    projection, mean-pooled over each request's 2 frames."""
    rng = np.random.default_rng(3)
    img = pair.jcfg.instructblip.vit.image_size
    pix = rng.standard_normal((4, img, img, 3)).astype(np.float32)
    ids = rng.integers(4, 60, (4, 5)).astype(np.int32)
    mask = np.array([[1] * 5, [1] * 3 + [0] * 2] * 2, np.float32)
    want = pair.japply(lambda m, p, i, a: m.model.encode_frames(
        p, i, a, mean_pool_groups=2), pix, ids, mask)
    with torch.no_grad():
        got = pair.tmodel.model.encode_frames(
            t(pix), qformer_input_ids=t(ids).long(),
            qformer_attention_mask=t(mask), mean_pool_groups=2)
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_prepare_llama_inference_matches_jax(pair, batches):
    """TGB in "multi_modal" mode, the "ratio" rule, the instruction-aware
    Q-Former: the same frame indices, embeddings and mask."""
    jb, tb = batches
    key = jax.random.key(4)
    names = ("frames", "flow", "flow_mask", "video_length",
             "sampler_question_ids", "sampler_question_mask",
             "question_ids", "question_mask")
    want = pair.japply(
        lambda m, q_ids, q_mask, k, *a: m.prepare_llama_inference(
            *a, k, qformer_input_ids=q_ids, qformer_attention_mask=q_mask),
        jb["qformer_input_ids"], jb["qformer_attention_mask"], key,
        *[jb[k] for k in names])
    with torch.no_grad():
        _, start_logits, _ = pair.tmodel.span_logits(
            tb["flow"], tb["flow_mask"], tb["sampler_question_ids"],
            tb["sampler_question_mask"], "multi_modal")
        got = pair.tmodel.prepare_llama_inference(
            *[tb[k] for k in names],
            noise=gumbel_like(key, start_logits, pair.tcfg.top_k),
            qformer_input_ids=tb["qformer_input_ids"],
            qformer_attention_mask=tb["qformer_attention_mask"])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------- pipeline
def _noise(pair, key, tb):
    shape = (tb["flow_mask"].shape[0], tb["flow_mask"].shape[1] - 2)
    return gumbel_like(key, torch.zeros(shape), pair.tcfg.top_k)


def test_generate_instructblip_matches_jax(pair, batches):
    """One call: identical frame indices and greedy tokens."""
    jb, tb = batches
    key = jax.random.key(5)
    sel_key, _ = jax.random.split(key)
    want_tokens, want_cand = jax.jit(
        lambda p, b, k: JV.generate_instructblip(
            pair.jmodel, p, b, JDecode(**DECODE), k))(pair.params, jb, key)
    got_tokens, got_cand = TV.generate_instructblip(
        pair.tmodel, tb, TDecode(**DECODE), noise=_noise(pair, sel_key, tb))
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))


def test_two_phase_instructblip_matches_jax(pair, batches):
    """``select_phase_blip2`` in "multi_modal" / "ratio" on the uint8 flow
    frames, the host gather, ``answer_phase_instructblip`` on the uint8
    frames: identical to the JAX phases."""
    jb, tb = batches
    x = pair.inputs
    key = jax.random.key(6)
    cand_j = jax.jit(lambda p, f, b, k: JV.select_phase_blip2(
        pair.jmodel, p, f, b, k, mode="multi_modal", rescale="ratio"))(
        pair.params, jnp.asarray(x["flow_u8"]), jb, key)
    sel = np.stack([x["frames_u8"][i, np.asarray(cand_j)[i]]
                    for i in range(2)])
    tokens_j = jax.jit(lambda p, s, b, k: JV.answer_phase_instructblip(
        pair.jmodel, p, s, b, JDecode(**DECODE), k))(
        pair.params, jnp.asarray(sel), jb, key)
    cand = TV.select_phase_blip2(
        pair.tmodel, t(x["flow_u8"]), tb, noise=_noise(pair, key, tb),
        mode="multi_modal", rescale="ratio")
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cand_j))
    tokens = TV.answer_phase_instructblip(pair.tmodel, t(sel), tb,
                                          TDecode(**DECODE))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(tokens_j))


def test_generate_instructblip_t5_matches_jax():
    """The instruction-aware T5 variant: ``generate_blip2`` reads the
    batch's instruction; identical frames and greedy tokens."""
    pair = Pair(backbone="instructblip_t5")
    assert pair.tcfg.instruction_aware and pair.tcfg.backbone == "blip2"
    jb, tb = _batches(pair)
    key = jax.random.key(7)
    sel_key, _ = jax.random.split(key)
    dec = dict(max_new_tokens=5, eos_token_id=1, pad_token_id=0)
    want_tokens, want_cand = jax.jit(lambda p, b, k: JV.generate_blip2(
        pair.jmodel, p, b, JDecode(**dec), k))(pair.params, jb, key)
    got_tokens, got_cand = TV.generate_blip2(
        pair.tmodel, tb, TDecode(**dec), noise=_noise(pair, sel_key, tb))
    np.testing.assert_array_equal(got_cand.numpy(), np.asarray(want_cand))
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(want_tokens))


# ---------------------------------------------------- kernel A's new shape
def test_flash_plain_matches_pallas_at_the_prefill_shape_class():
    """(B, H, Sq, Skv, D) = (1, 2, 24, 40, 128), Skv > Sq, with the cache
    forward's (1, 1, 24, 40) bias: k_pos <= q_pos plus padding of the
    prompt's tail and of the unwritten decode slots."""
    rng = np.random.default_rng(8)
    b, h, sq, skv, d = 1, 2, 24, 40, 128
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, skv, d)).astype(np.float32)
            for _ in range(2))
    valid = np.zeros((b, skv), np.float32)
    valid[:, :20] = 1.0
    causal = np.where(np.arange(skv)[None] <= np.arange(sq)[:, None], 0.0,
                      JA.NEG_INF)[None, None]
    bias = (causal + np.asarray(JA.make_padding_bias(jnp.asarray(valid)))
            ).astype(np.float32)
    scale = d ** -0.5
    real = JA.pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    with mock.patch.object(JA.pl, "pallas_call", interpret):
        want = jax.jit(JA._flash_forward, static_argnums=(4, 5, 6))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
            scale, 8, 16)
    close(TA.dot_product_attention(t(q), t(k), t(v), t(bias), scale), want)
    close(TA.flash_attention(t(q), t(k), t(v), t(bias), scale), want)


# ------------------------------------------------------------ what raises
def test_what_the_vicuna_port_lacks_raises():
    cfg = TV.VideoTGBConfig.tiny("instructblip")
    llm = cfg.instructblip.llm
    for change, match in ((dict(scan_layers=True), "item 5"),
                          (dict(remat=True), "item 5")):
        bad = dataclasses.replace(cfg, instructblip=dataclasses.replace(
            cfg.instructblip, llm=dataclasses.replace(llm, **change)))
        with pytest.raises(NotImplementedError, match=match):
            TV.VideoTGB(bad, device="cpu")
    # LoRA is ported: rank-8 adapters on every LLaMA attention's q and v
    lora = TV.VideoTGB(TV.with_lora(cfg, 8), device="cpu")
    names = [n for n, _ in lora.model.language_model.named_parameters()
             if "_lora." in n]
    assert len(names) == 2 * 2 * llm.num_layers


def test_flagship_instructblip_wants_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.VideoTGB(TV.VideoTGBConfig.flagship("instructblip"))
