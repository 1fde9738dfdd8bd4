"""videotgb_torch's stage 3 (the IV and IVT recipes) against videotgb_tpu's,
on the CPU.

The conversation templates (every ``conv_templates`` entry, exact strings),
the LoRA adapters (``LoRADelta``, ``MultiHeadAttention`` with adapters, T5
and LLaMA with ``lora_rank=8``), the IV / IVT freeze filters against the
JAX ``trainable_mask``, ``IVInstructDataset`` and ``collate_iv`` on image,
video and text-only rows written with ``cv2`` (exact arrays and strings),
the IV / IVT loss and the gradient of every trainable parameter on the
three backbones against ``jax.value_and_grad``, and ``generate_iv``'s
tokens on the T5 and the LLaMA branch, each batch with a text-only row.
Both sides run the tiny configs in f32 with one set of numpy weights from a
seed (``tests/_torch_port_helpers.py``, LoRA factors included); tolerance
2e-4 (tests/test_parity.py's f32 tolerance), strings, arrays and tokens
exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401
    B, Pair, close, few_torch_threads, grads_against_jax, image_size,
    random_tree, run_once, t, write_stage3_media)
from videotgb_torch.convert import _map_path, load_flax_params
from videotgb_torch.data import conversation as TC
from videotgb_torch.data import datasets as TD
from videotgb_torch.data.datasets import pack_text_input_output
from videotgb_torch.data.tokenizer import load_tokenizer as t_tokenizer
from videotgb_torch.models import common as TM
from videotgb_torch.models import lora as TL
from videotgb_torch.models import videotgb as TV
from videotgb_torch.ops.decode import DecodeConfig as TDecode
from videotgb_torch.training import optim as TO
from videotgb_torch.training import recipes as TR
from videotgb_tpu.data import conversation as JC
from videotgb_tpu.data import datasets as JD
from videotgb_tpu.data.tokenizer import load_tokenizer as j_tokenizer
from videotgb_tpu.models import common as JM
from videotgb_tpu.models import lora as JL
from videotgb_tpu.models import videotgb as JV
from videotgb_tpu.ops.decode import DecodeConfig as JDecode
from videotgb_tpu.training import optim as JO
from videotgb_tpu.training import recipes as JR

NEW = 4  # generated tokens


# ---------------------------------------------------------- conversation
def _messages(conv, image=False):
    first = ("<image>\nwhat is in the clip?", "an image", "Crop") if image \
        else "what is in the clip?"
    conv.append_message(conv.roles[0], first)
    conv.append_message(conv.roles[1], "a dog on a beach")
    conv.append_message(conv.roles[0], "and then?")
    conv.append_message(conv.roles[1], None)
    return conv


@pytest.mark.parametrize("name", sorted(JC.conv_templates))
def test_conversation_templates_match_jax(name):
    """Every template's prompt after the same turns, with a plain first
    message and with the image tuple, and the copies left untouched."""
    assert sorted(TC.conv_templates) == sorted(JC.conv_templates)
    for image in (False, True):
        want = _messages(JC.conv_templates[name].copy(), image).get_prompt()
        got = _messages(TC.conv_templates[name].copy(), image).get_prompt()
        assert got == want
    assert TC.conv_templates[name].messages == []
    assert TC.default_conversation.get_prompt() == \
        JC.default_conversation.get_prompt()
    assert [s.name for s in TC.SeparatorStyle] == \
        [s.name for s in JC.SeparatorStyle]


# ------------------------------------------------------------------ LoRA
def _flax(module, shapes_args, seed):
    shapes = jax.eval_shape(lambda k: module.init(k, *shapes_args),
                            jax.random.key(0))
    from flax import linen as nn

    return random_tree(nn.meta.unbox(shapes)["params"], seed)


def test_lora_delta_and_attention_with_adapters_match_jax():
    """``LoRADelta`` alone, then self- and cross-attention with q and v
    adapters (the cross one reads a source of another width)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 16)).astype(np.float32)
    jdelta = JL.LoRADelta(12, 8)
    tree = _flax(jdelta, (jnp.asarray(x),), 1)
    want = jdelta.apply({"params": tree}, jnp.asarray(x))
    tdelta = TL.LoRADelta(24, 12, 8)
    load_flax_params(tdelta, tree)
    close(tdelta(t(x)), want)
    assert tuple(tdelta.lora_a.shape) == (24, 8)
    assert tuple(tdelta.lora_b.shape) == (8, 12)

    for x_kv, kv_features in ((None, None), (kv, 16)):
        jmha = JM.MultiHeadAttention(num_heads=4, head_dim=6, lora_rank=8)
        args = (jnp.asarray(x),) + (() if x_kv is None
                                    else (jnp.asarray(x_kv),))
        tree = _flax(jmha, args, 2)
        assert set(tree) == {"q", "k", "v", "o", "q_lora", "v_lora"}
        want, _ = jmha.apply({"params": tree}, *args)
        tmha = TM.MultiHeadAttention(24, 4, 6, kv_features=kv_features,
                                     lora_rank=8)
        load_flax_params(tmha, tree)
        got, _ = tmha(t(x), None if x_kv is None else t(x_kv))
        close(got, want)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(backbone, lora_rank=0):
        if (backbone, lora_rank) not in cache:
            cache[backbone, lora_rank] = Pair(seed=6, backbone=backbone,
                                              lora_rank=lora_rank)
        return cache[backbone, lora_rank]

    return get


def test_t5_and_llama_with_lora_match_jax(pairs):
    """The T5 (encoder, teacher-forced decoder: adapters on encoder self,
    decoder self and cross attention) and the LLaMA logits with rank-8
    adapters."""
    rng = np.random.default_rng(4)
    pair = pairs("blip2", 8)
    d = pair.jcfg.blip2.t5.d_model
    embeds = rng.standard_normal((2, 7, d)).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 5 + [0] * 2], np.float32)
    dec = rng.integers(2, 60, (2, 5)).astype(np.int32)
    want = pair.japply(lambda m, e, a, i: m.model.language_model(e, a, i),
                       embeds, mask, dec)
    lm = pair.tmodel.model.language_model
    assert sum(n.endswith(("q_lora.lora_a", "v_lora.lora_b"))
               for n, _ in lm.named_parameters()) == 2 * 6  # 2 enc + 2x2 dec
    with torch.no_grad():
        close(lm(t(embeds), t(mask), t(dec).long()), want)

    pair = pairs("instructblip", 8)
    d = pair.jcfg.instructblip.llm.hidden_size
    embeds = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = pair.japply(lambda m, e, a: m.model.language_model(
        inputs_embeds=e, attention_mask=a)[0], embeds, mask)
    with torch.no_grad():
        got, _ = pair.tmodel.model.language_model(inputs_embeds=t(embeds),
                                                  attention_mask=t(mask))
    close(got, want)


def test_adapters_start_as_the_base_model():
    """Built with random weights, every adapter has B = 0 and A drawn
    N(0, 0.02); with B = 0 the model with adapters gives the logits of
    the model without them on the same base weights."""
    for backbone in ("blip2", "instructblip"):
        base = TV.VideoTGB(TV.VideoTGBConfig.tiny(backbone), device="cpu",
                           seed=2)
        lora = TV.VideoTGB(TV.with_lora(TV.VideoTGBConfig.tiny(backbone), 8),
                           device="cpu", seed=2)
        own = lora.state_dict()
        extra = sorted(set(own) - set(base.state_dict()))
        assert extra and all(TL.lora_param_filter(k) for k in extra)
        a = torch.cat([own[k].flatten() for k in extra
                       if k.endswith("lora_a")])
        assert all(not own[k].any() for k in extra if k.endswith("lora_b"))
        assert 0.015 < float(a.std()) < 0.025
        lora.load_state_dict({**own, **base.state_dict()})
        ids = torch.randint(4, 60, (2, 6), generator=torch.Generator()
                            .manual_seed(0))
        mask = torch.ones((2, 6))
        with torch.no_grad():
            if backbone == "blip2":
                emb = base.model.language_model.embed(ids)
                outs = [m.model.language_model(emb, mask, ids[:, :3])
                        for m in (base, lora)]
            else:
                outs = [m.model.language_model(input_ids=ids,
                                               attention_mask=mask)[0]
                        for m in (base, lora)]
        assert torch.equal(outs[0], outs[1])


# ----------------------------------------------------- the freeze filters
@pytest.mark.parametrize("backbone,lora", [("blip2", 8), ("instructblip", 8),
                                           ("instructblip_t5", 0)])
def test_stage3_filters_train_what_jax_trains(pairs, backbone, lora):
    """``filter_fn`` of IV and IVT marks exactly the parameters that the
    JAX ``trainable_mask`` marks, names mapped by ``convert``."""
    from flax.traverse_util import flatten_dict

    pair = pairs(backbone, lora)
    for jrecipe, trecipe in ((JR.IVRecipe(), TR.IVRecipe()),
                             (JR.IVTRecipe(), TR.IVTRecipe())):
        mask = flatten_dict(JO.trainable_mask(pair.params["params"],
                                              jrecipe.filter_fn))
        want = {_map_path(path)[0] for path, m in mask.items() if m}
        got = {n for n in pair.tmodel.state_dict() if trecipe.filter_fn(n)}
        assert got == want
        assert got and all(
            n.startswith(("model.qformer", "model.language_projection",
                          "model.query_tokens")) or TL.lora_param_filter(n)
            for n in got)
        if lora and isinstance(trecipe, TR.IVTRecipe):
            assert any(TL.lora_param_filter(n) for n in got)
    # the JAX package's own filter, for the names of either package
    assert TO.path_freeze_filter(("x",), train_lora_only=True)(
        "model.language_model.layers.0.attn.q_lora.lora_a")
    assert not TO.path_freeze_filter(train_prefixes=("model/qformer",))(
        "model.language_model.layers.0.attn.q_lora.lora_a")


# ---------------------------------------------------- data and collate
def test_iv_dataset_and_collate_match_jax(tmp_path, monkeypatch):
    """Image (width 1), video cropped to the span of pseudo_label.json and
    to its own ``pseudo_label`` (width nframe), text-only rows (width 0):
    the same frames, strings and widths; then ``collate_iv`` with and
    without the Q-Former's tokenizer, every array equal."""
    from videotgb_tpu.data import native

    # the port has no native host library: the JAX numpy path
    monkeypatch.setattr(native, "available", lambda: False)
    write_stage3_media(tmp_path)
    kw = dict(nframe=3, image_size=32, include_text_only=True,
              text_only_path=str(tmp_path / "nlp_tune.json"),
              pseudo_label_path=str(tmp_path / "pseudo_label.json"))
    args = (str(tmp_path / "train.json"), str(tmp_path), str(tmp_path))
    jds = JD.IVInstructDataset(*args, **kw)
    tds = TD.IVInstructDataset(*args, seed=1, **kw)
    assert len(tds) == len(jds) == 5
    samples = []
    for i in range(len(jds)):
        want = jds._get(i)
        got = tds[i]
        assert {k: got[k] for k in ("width", "question", "answer")} == \
            {k: want[k] for k in ("width", "question", "answer")}
        if want["frames"] is None:
            assert got["frames"] is None
        else:
            assert got["frames"].dtype == np.float32
            np.testing.assert_array_equal(got["frames"], want["frames"])
        samples.append(got)
    assert [s["width"] for s in samples] == [1, 3, 3, 0, 0]
    assert samples[0]["question"].endswith("ASSISTANT:")
    assert samples[0]["answer"] == "a picture </s>"
    # the two video rows differ by their spans only
    assert not np.array_equal(samples[1]["frames"], samples[2]["frames"])
    tok = (t_tokenizer("byte"), j_tokenizer("byte"))
    for qf in (False, True):
        want = JD.collate_iv(samples, tok[1], nframe=3, image_size=32,
                             max_txt_len=40, answer_len=8,
                             qformer_tokenizer=tok[1] if qf else None)
        got = TD.collate_iv(samples, tok[0], nframe=3, image_size=32,
                            max_txt_len=40, answer_len=8,
                            qformer_tokenizer=tok[0] if qf else None)
        assert sorted(got) == sorted(want)
        for k in want:
            if k.startswith("_"):
                assert got[k] == want[k]
            else:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert not got["frames"][3:].any()


def test_iv_dataset_resamples_a_broken_row_from_its_own_generator(tmp_path):
    """A row whose media fails to load is replaced by a row drawn from the
    dataset's ``random.Random(seed)``: the same seed, the same row."""
    write_stage3_media(tmp_path)
    bad = [{"image": "missing.jpg", "conversations": [
        {"from": "human", "value": "q"}, {"from": "gpt", "value": "a"}]}]
    rows = json.loads((tmp_path / "train.json").read_text())
    (tmp_path / "mixed.json").write_text(json.dumps(bad + rows))
    picks = [TD.IVInstructDataset(str(tmp_path / "mixed.json"), str(tmp_path),
                                  str(tmp_path), nframe=2, image_size=16,
                                  seed=5)[0]["question"] for _ in range(2)]
    assert picks[0] == picks[1]


# ------------------------------------------------- the loss and gradients
def iv_batch(pair, seed):
    """numpy IV batch of the tiny config: pre-selected frames with a
    text-only second row (zero frames, width 0), the T5 question and
    answer, the packed Vicuna prompt and answer with labels, and the
    instruction for the Q-Former."""
    cfg = pair.jcfg
    rng = np.random.default_rng(seed)
    img, nf = image_size(cfg), cfg.nframe
    prompt = [rng.integers(4, 60, n).tolist() for n in (6, 4)]
    answer = [rng.integers(4, 60, n).tolist() for n in (3, 5)]
    inst_ids, inst_mask, labels = pack_text_input_output(prompt, answer, 10, 0)
    answers = rng.integers(2, 60, (B, 5)).astype(np.int32)
    answers[0, 3:] = 0
    frames = rng.standard_normal((B, nf, img, img, 3)).astype(np.float32)
    frames[1] = 0.0
    return {
        "frames": frames,
        "widths": np.array([nf, 0], np.int32),
        "qformer_input_ids": rng.integers(4, 60, (B, 5)).astype(np.int32),
        "qformer_attention_mask": np.array([[1] * 5, [1] * 3 + [0] * 2],
                                           np.int32),
        "question_ids": rng.integers(4, 60, (B, 6)).astype(np.int32),
        "question_mask": np.array([[1] * 6, [1] * 4 + [0] * 2], np.int32),
        "answer_ids": answers,
        "instruction_ids": inst_ids, "instruction_mask": inst_mask,
        "labels": labels,
    }


IV_CASES = {"blip2_ivt": ("blip2", 8, "ivt"),
            "instructblip_t5_iv": ("instructblip_t5", 0, "iv"),
            "instructblip_ivt": ("instructblip", 8, "ivt")}


@pytest.mark.parametrize("case", sorted(IV_CASES))
def test_stage3_loss_and_gradients_match_jax(pairs, case):
    """The IV / IVT loss and every trainable gradient (the Q-Former, its
    projection and query tokens, and the adapters under IVT) with a
    text-only row in the batch; nothing else takes a gradient."""
    backbone, lora, name = IV_CASES[case]
    pair = pairs(backbone, lora)
    jrecipe = JR.RECIPES[name]()
    trecipe = TR.RECIPES[name]()
    x = iv_batch(pair, 8)

    def jloss(p, b):
        return jrecipe.loss_fn(pair.jmodel, p, b, jax.random.key(0),
                               deterministic=True)

    def tloss(model, b):
        return trecipe.loss_fn(model, b, None, deterministic=True)

    names, _, _ = grads_against_jax(
        pair, jloss, tloss, (jrecipe.filter_fn, trecipe.filter_fn), x)
    assert any(n.startswith("model.qformer") for n in names)
    assert any(TL.lora_param_filter(n) for n in names) == (name == "ivt")


def test_text_only_row_loss_ignores_its_frames(pairs):
    """The JAX ``test_ivt_text_only_rows_masked`` on the port: garbage in
    a width-0 row's frame slab leaves the loss as it was."""
    pair = pairs("blip2", 8)
    x = {k: t(v) for k, v in iv_batch(pair, 9).items()}
    with torch.no_grad():
        l1, _ = TR.IVRecipe().loss_fn(pair.tmodel, x)
        x["frames"][1] = 99.0
        l2, _ = TR.IVRecipe().loss_fn(pair.tmodel, x)
    assert float(l1) == float(l2)


# ---------------------------------------------------------- generate_iv
@pytest.mark.parametrize("backbone", ["blip2", "instructblip"])
def test_generate_iv_tokens_match_jax(pairs, backbone):
    """Greedy tokens of the T5 and the LLaMA branch (adapters on), the
    text-only row included."""
    pair = pairs(backbone, 8)
    x = iv_batch(pair, 10)
    llm = pair.jcfg.blip2.t5 if backbone == "blip2" else \
        pair.jcfg.instructblip.llm
    ids = dict(max_new_tokens=NEW, eos_token_id=llm.eos_token_id,
               pad_token_id=llm.pad_token_id)
    want = run_once(lambda p, b: JV.generate_iv(
        pair.jmodel, p, b, JDecode(**ids), jax.random.key(0)), pair.params,
        {k: jnp.asarray(v) for k, v in x.items()})
    tb = {k: t(v) for k, v in x.items()}
    got = TV.generate_iv(pair.tmodel, tb, TDecode(**ids))
    assert tuple(got.shape) == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
