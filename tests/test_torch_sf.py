"""videotgb_torch's self-refinement (SF) recipe and InstructBLIP training
forward against videotgb_tpu's, on the CPU.

The largest-rectangle span against both JAX versions (numpy and jitted) on
random, tied, flat and single-peak profiles at F = 32, ``rescale_index``,
the tiny SF loss and the gradient of every trainable parameter on the three
backbones (and with RAFT in the step, ``online_flow``) against
``jax.value_and_grad`` with the JAX trainer's freeze and dropout off, the
pseudo-label pass's tokens, scores and spans on the T5 and LLaMA branches,
and the InstructBLIP-Vicuna training forward. Both sides run the tiny
configs in f32 with one set of numpy weights from a seed
(``tests/_torch_port_helpers.py``) and share the selection's Gumbel noise.
Tolerance 2e-4 (tests/test_parity.py's f32 tolerance); tokens and spans are
exact.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401
    B, L_FLOW, TOL, Pair, close, few_torch_threads, grads_against_jax,
    run_once, t)
from videotgb_torch import train as TT
from videotgb_torch.convert import flax_to_state_dict
from videotgb_torch.data.datasets import pack_text_input_output
from videotgb_torch.data.tokenizer import load_tokenizer as t_tokenizer
from videotgb_torch.ops import span as TS
from videotgb_torch.training import recipes as TR
from videotgb_tpu import train as JT
from videotgb_tpu.data.tokenizer import load_tokenizer as j_tokenizer
from videotgb_tpu.ops import span as JS
from videotgb_tpu.training import recipes as JR

F = 32
PSEUDO_NEW = 4
ANSWERS = ["playing a guitar on stage </s>", "the car is bright red </s>"]


# --------------------------------------------------------------- the span
def _profiles(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((6, F)).astype(np.float32)
    if kind == "tied":  # rouge-like steps: many equal heights and areas
        return (rng.integers(0, 4, (6, F)) / 4).astype(np.float32)
    if kind == "flat":
        return np.stack([np.zeros(F), np.full(F, 0.5), np.ones(F)]
                        ).astype(np.float32)
    assert kind == "single_peak"
    out = np.zeros((F, F), np.float32)
    out[np.arange(F), np.arange(F)] = 0.7
    return out


@pytest.mark.parametrize("kind", ["random", "tied", "flat", "single_peak"])
def test_largest_rectangle_span_matches_both_jax_versions(kind):
    scores = _profiles(kind)
    want = np.stack(JS.largest_rectangle_span(jnp.asarray(scores)), 1)
    want_np = np.array([JS.largest_rectangle_span_np(s) for s in scores])
    np.testing.assert_array_equal(want, want_np)
    got = np.array([TS.largest_rectangle_span_np(s) for s in scores])
    np.testing.assert_array_equal(got, want_np)
    starts, ends = TS.largest_rectangle_span(torch.from_numpy(scores))
    assert starts.dtype == ends.dtype == torch.int64
    np.testing.assert_array_equal(torch.stack([starts, ends], 1).numpy(), want)
    if kind == "flat":
        assert (want == [0, F - 1]).all()


def test_rescale_index_matches_jax():
    idx = np.arange(F)[:, None].repeat(5, 1)
    dst = np.array([1, 2, 3, 31, 64], np.int32)
    for src in (F, 1, 2):
        want = np.asarray(JS.rescale_index(jnp.asarray(idx), src,
                                           jnp.asarray(dst)))
        got = TS.rescale_index(torch.from_numpy(idx), src,
                               torch.from_numpy(dst))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- shared set-up
@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(backbone):
        if backbone not in cache:
            cache[backbone] = Pair(seed=5, backbone=backbone)
        return cache[backbone]

    return get


def sf_batch(pair, seed):
    """numpy SF batch of the tiny config: candidate frames, flow (and the
    RGB it comes from), both text encodings (T5 question and answer; the
    packed Vicuna prompt and answer with labels), the instruction for the
    Q-Former and per-frame scores with one plateau per row."""
    cfg = pair.jcfg
    rng = np.random.default_rng(seed)
    img, fs = (cfg.blip2 or cfg.instructblip).vit.image_size, cfg.tgb.flow_size
    nf = cfg.num_frames
    prompt = [rng.integers(4, 60, n).tolist() for n in (6, 4)]
    answer = [rng.integers(4, 60, n).tolist() for n in (3, 5)]
    inst_ids, inst_mask, labels = pack_text_input_output(prompt, answer, 10, 0)
    answers = rng.integers(2, 60, (B, 5)).astype(np.int32)
    answers[0, 3:] = 0
    scores = np.zeros((B, nf), np.float32)
    scores[0, 1:3] = 0.5
    scores[1, 2:] = 0.25
    q_mask = np.ones((B, 6), np.float32)
    q_mask[1, 4:] = 0
    return {
        "frames": rng.standard_normal((B, nf, img, img, 3)).astype(np.float32),
        "flow": rng.standard_normal((B, L_FLOW, fs, fs, 2)).astype(np.float32),
        "flow_frames": rng.integers(0, 255, (B, L_FLOW + 1, fs, fs, 3)
                                    ).astype(np.float32),
        "flow_mask": np.ones((B, L_FLOW + 2), np.float32),
        "video_length": np.array([L_FLOW, L_FLOW - 1], np.int32),
        "sampler_question_ids": rng.integers(4, 60, (B, 5)).astype(np.int32),
        "sampler_question_mask": np.ones((B, 5), np.float32),
        "qformer_input_ids": rng.integers(4, 60, (B, 5)).astype(np.int32),
        "qformer_attention_mask": np.array([[1] * 5, [1] * 3 + [0] * 2],
                                           np.float32),
        "question_ids": rng.integers(4, 60, (B, 6)).astype(np.int32),
        "question_mask": q_mask,
        "answer_ids": answers,
        "instruction_ids": inst_ids, "instruction_mask": inst_mask,
        "labels": labels,
        "scores": scores,
    }


def gumbel(pair):
    rng = np.random.default_rng(13)
    return rng.gumbel(size=(pair.jcfg.top_k, 2, B, L_FLOW)).astype(np.float32)


# ------------------------------------------------------ the SF loss, grads
# instructblip_t5 runs with RAFT in the step (online_flow), which leaves
# the rest of its step as with precomputed flow
SF_CASES = {"blip2": ("blip2", False),
            "instructblip_t5_online_flow": ("instructblip_t5", True),
            "instructblip": ("instructblip", False)}


@pytest.mark.parametrize("case", sorted(SF_CASES))
def test_sf_loss_and_gradients_match_jax(pairs, case):
    """The joint loss (and its lm / mrc parts and span targets) and every
    trainable gradient, T5's relative-position bias and the TGB included;
    the ViT and RAFT get none."""
    backbone, online = SF_CASES[case]
    pair = pairs(backbone)
    jrecipe = JR.SFRecipe(online_flow=online)
    trecipe = TR.SFRecipe(online_flow=online)
    x = sf_batch(pair, 7)
    if online:
        del x["flow"]
    noise = gumbel(pair)

    def jloss(p, b):
        with mock.patch.object(jax.random, "gumbel",
                               lambda key, shape, dtype=None: noise):
            loss, a = jrecipe.loss_fn(pair.jmodel, p, b, jax.random.key(0),
                                      deterministic=True)
        return loss, {k: a[k] for k in ("lm_loss", "mrc_loss",
                                        "start_targets", "end_targets",
                                        "cand")}

    def tloss(model, b):
        return trecipe.loss_fn(model, b, None, deterministic=True,
                               noise=t(noise))

    names, want, got = grads_against_jax(
        pair, jloss, tloss, (jrecipe.filter_fn, trecipe.filter_fn), x)
    assert any(n.startswith("temporal_encoder") for n in names)
    assert not any(n.startswith(("model.vision_model", "of_extractor"))
                   for n in names)
    if backbone != "instructblip":
        assert any(n.startswith("model.language_model.enc_rel_bias")
                   for n in names)
    for k in ("lm_loss", "mrc_loss"):
        close(got[k], want[k])
    for k in ("start_targets", "end_targets", "cand"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# -------------------------------------------------- the pseudo-label pass
@pytest.mark.parametrize("backbone", ["instructblip_t5", "instructblip"])
def test_pseudo_tokens_scores_and_spans_match_jax(pairs, backbone):
    """The per-frame greedy tokens of the T5 and the LLaMA branch (the
    instruction repeated per frame) are identical, and so are the rouge
    scores of ``sf_pseudo_scores`` and the spans made from them."""
    pair = pairs(backbone)
    x = sf_batch(pair, 9)
    keys = ("frames", "question_ids", "question_mask", "qformer_input_ids",
            "qformer_attention_mask")
    jb = {k: jnp.asarray(x[k]) for k in keys}
    want = run_once(lambda p, b: JR.pseudo_label_generate(
        pair.jmodel, p, b["frames"], b["question_ids"], b["question_mask"],
        max_new_tokens=PSEUDO_NEW, qformer_input_ids=b["qformer_input_ids"],
        qformer_attention_mask=b["qformer_attention_mask"]), pair.params, jb)
    tb = {k: t(x[k]) for k in keys}
    got = TR.pseudo_label_generate(
        pair.tmodel, tb["frames"], tb["question_ids"].long(),
        tb["question_mask"], max_new_tokens=PSEUDO_NEW,
        qformer_input_ids=tb["qformer_input_ids"].long(),
        qformer_attention_mask=tb["qformer_attention_mask"])
    assert tuple(got.shape) == (B * pair.jcfg.num_frames, PSEUDO_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    with mock.patch.object(JR, "pseudo_label_generate",
                           lambda *a, **k: want):
        want_scores = np.asarray(JT.sf_pseudo_scores(
            pair.jmodel, pair.params, jb, ANSWERS, j_tokenizer("byte"),
            max_new_tokens=PSEUDO_NEW))
    got_scores = TT.sf_pseudo_scores(pair.tmodel, tb, ANSWERS,
                                     t_tokenizer("byte"),
                                     max_new_tokens=PSEUDO_NEW)
    assert got_scores.dtype == torch.float32
    np.testing.assert_array_equal(got_scores.numpy(), want_scores)
    np.testing.assert_array_equal(
        torch.stack(TS.largest_rectangle_span(got_scores), 1).numpy(),
        np.stack(JS.largest_rectangle_span(jnp.asarray(want_scores)), 1))


# --------------------------------------------- the Vicuna training forward
def test_instructblip_training_forward_matches_jax(pairs):
    """Loss, logits and every parameter's gradient of
    ``InstructBlipModel.forward`` with the mean-pooled visual prefix (the
    SF case above holds the per-frame prefix) before the packed prompt +
    answer, a text-only row through ``visual_valid``, causal CE on the
    answer only."""
    mean_pool = True
    pair = pairs("instructblip")
    x = sf_batch(pair, 11)
    keys = ("instruction_ids", "instruction_mask", "labels",
            "qformer_input_ids", "qformer_attention_mask")
    frames = x["frames"][:, :pair.jcfg.nframe]
    valid = np.array([1.0, 0.0], np.float32)
    args = (frames, *(x[k] for k in keys), valid)

    def jforward(p, *a):
        return pair.jmodel.apply(
            {"params": p}, *a, method=lambda m, fr, ids, msk, lab, qi, qm, vv:
            m.model(fr, ids, msk, lab, qi, qm, mean_pool=mean_pool,
                    visual_valid=vv))

    (loss_j, logits_j), grads_j = run_once(
        jax.value_and_grad(jforward, has_aux=True), pair.params["params"],
        *(jnp.asarray(a) for a in args))
    grads_j = flax_to_state_dict(jax.device_get(grads_j))
    from videotgb_torch.convert import load_flax_params
    from videotgb_torch.models import videotgb as TV

    model = load_flax_params(TV.VideoTGB(pair.tcfg, device="cpu"), pair.tree)
    model.model.requires_grad_(True)
    targs = [t(a) for a in args]
    for i in (1, 4):  # token ids
        targs[i] = targs[i].long()
    loss, logits = model.model(*targs[:6], mean_pool=mean_pool,
                               visual_valid=targs[6])
    loss.backward()
    close(logits, logits_j)
    close(loss, loss_j)
    seen = 0
    for name, p in model.model.named_parameters():
        want = grads_j["model." + name].numpy()
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), want, err_msg=name, **TOL)
        seen += int(p.grad is not None)
    assert seen > 0
