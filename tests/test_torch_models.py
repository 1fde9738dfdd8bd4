"""videotgb_torch towers against videotgb_tpu towers on the CPU.

The tiny VideoTGB in f32: one set of numpy weights (``_torch_port_helpers``)
is the JAX model's parameter tree and, carried across with
``videotgb_torch.convert``, the port's ``state_dict``. Each tower runs on
the same inputs on both sides and is compared at the f32 tolerance of
``tests/test_parity.py`` (2e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import Pair, close, few_torch_threads, t  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch import convert
from videotgb_torch.models import raft as TRAFT
from videotgb_torch.models import t5 as TT5
from videotgb_tpu.models import raft as JRAFT
from videotgb_tpu.models import t5 as JT5


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def jax_flow(pair):
    """The JAX RAFT's consecutive flow of the tiny flow frames (one compile
    for the tests that compare against it)."""
    return pair.japply(lambda m, f: m.of_extractor.consecutive(f),
                       jnp.asarray(pair.inputs["flow_u8"], jnp.float32))


def test_convert_covers_every_parameter(pair):
    sd = convert.flax_to_state_dict(pair.tree)
    assert set(sd) == set(pair.tmodel.state_dict())
    w = pair.tree["model"]["language_model"]["encoder_0"]["wi_0"]["kernel"]
    assert torch.equal(
        pair.tmodel.model.language_model.encoder_blocks[0].wi_0.weight,
        torch.from_numpy(w.T.copy()))
    conv = pair.tree["of_extractor"]["fnet"]["conv1"]["kernel"]
    assert torch.equal(pair.tmodel.of_extractor.fnet.conv1.weight,
                       torch.from_numpy(conv.transpose(3, 2, 0, 1).copy()))
    bn = pair.tree["of_extractor"]["cnet"]["norm1"]["norm"]["var"]
    assert torch.equal(pair.tmodel.of_extractor.cnet.norm1.running_var,
                       torch.from_numpy(bn))


# ----------------------------------------------------------------- RAFT
@pytest.mark.parametrize("fused", [None, False])
def test_raft_consecutive_matches_jax(pair, jax_flow, fused):
    """The feature net runs once over the unique frames; the lookup takes
    the query-minor pyramid (None) or the dense standard one (False)."""
    flow_u8 = pair.inputs["flow_u8"]
    want = jax_flow
    raft = pair.tmodel.of_extractor
    raft.config = dataclasses.replace(raft.config, fused_lookup=fused)
    try:
        got = raft.consecutive(t(flow_u8).float())
    finally:
        raft.config = dataclasses.replace(raft.config, fused_lookup=None)
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_raft_pairwise_matches_consecutive(pair):
    frames = t(pair.inputs["flow_u8"]).float()
    raft = pair.tmodel.of_extractor
    seq = raft.consecutive(frames[:1])
    pairwise = raft(frames[:1, 1], frames[:1, 2])
    close(pairwise, seq[:, 1].numpy())


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(1)
    flow = rng.standard_normal((2, 3, 4, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 4, 576)).astype(np.float32)
    close(TRAFT.convex_upsample(t(flow), t(mask)),
          JRAFT.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))


def test_flow_features_match_jax(pair, jax_flow):
    """Consecutive flows normalized by each clip's largest flow radius."""
    rad = np.sqrt((np.asarray(jax_flow) ** 2).sum(-1))
    want = jax_flow / (rad.max(axis=(1, 2, 3))[:, None, None, None, None]
                       + 1e-5)
    close(pair.tmodel.flow_features(t(pair.inputs["flow_u8"]).float()), want)


# ------------------------------------------------------------------ TGB
@pytest.mark.parametrize("mode", ["fusion", "multi_modal", "text"])
def test_tgb_span_logits_match_jax(pair, mode):
    x = pair.inputs
    rng = np.random.default_rng(2)
    flow = rng.standard_normal((2, 3, 32, 32, 2)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 1, 0]], np.float32)
    q_mask = np.array([[1] * 5, [1, 1, 1, 0, 0]], np.float32)
    want = pair.japply(
        lambda m, *a: m.span_logits(*a, mode=mode), jnp.asarray(flow),
        jnp.asarray(mask), jnp.asarray(x["sampler_question_ids"]),
        jnp.asarray(q_mask))
    got = pair.tmodel.span_logits(t(flow), t(mask),
                                  t(x["sampler_question_ids"]).long(),
                                  t(q_mask), mode=mode)
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------- ViT / Q-Former
def test_vit_matches_jax(pair):
    img = np.random.default_rng(3).standard_normal((3, 56, 56, 3)).astype(
        np.float32)
    close(pair.tmodel.model.vision_model(t(img)),
          pair.japply(lambda m, x: m.model.vision_model(x), jnp.asarray(img)))


def test_qformer_matches_jax(pair):
    rng = np.random.default_rng(4)
    query = rng.standard_normal((2, 8, 32)).astype(np.float32)
    img = rng.standard_normal((2, 17, 64)).astype(np.float32)
    img_mask = np.ones((2, 17), np.float32)
    img_mask[1, -5:] = 0
    close(pair.tmodel.model.qformer(t(query), t(img), t(img_mask)),
          pair.japply(lambda m, *a: m.model.qformer(*a), jnp.asarray(query),
                      jnp.asarray(img), jnp.asarray(img_mask)))


def test_instruction_aware_qformer_matches_jax():
    """The InstructBLIP-style text path: instruction tokens self-attend with
    the queries and take the text half of the split FFN."""
    from flax import linen as fnn

    from _torch_port_helpers import random_tree
    from videotgb_torch.models.qformer import QFormerConfig as TQ
    from videotgb_torch.models.qformer import QFormerModel as TQModel
    from videotgb_tpu.models.qformer import QFormerConfig as JQ
    from videotgb_tpu.models.qformer import QFormerModel as JQModel

    rng = np.random.default_rng(9)
    query = rng.standard_normal((2, 8, 32)).astype(np.float32)
    img = rng.standard_normal((2, 17, 64)).astype(np.float32)
    ids = rng.integers(1, 300, (2, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.float32)
    jmodel = JQModel(dataclasses.replace(JQ.tiny(), dtype=jnp.float32,
                                         param_dtype=jnp.float32))
    args = (jnp.asarray(query), jnp.asarray(img), None, jnp.asarray(ids),
            jnp.asarray(mask))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, *args), jax.random.key(0))
    tree = random_tree(fnn.meta.unbox(shapes)["params"], seed=9)
    want = jax.jit(lambda p, *a: jmodel.apply(p, *a))(
        {"params": jax.tree.map(jnp.asarray, tree)}, *args)
    tmodel = TQModel(dataclasses.replace(TQ.tiny(), dtype=torch.float32,
                                         param_dtype=torch.float32),
                     instruction=True, device="cpu")
    convert.load_flax_params(tmodel, tree)
    got = tmodel(t(query), t(img), input_ids=t(ids).long(),
                 attention_mask=t(mask))
    close(got, want)


@pytest.mark.parametrize("groups", [None, 2])
def test_blip2_encode_frames_matches_jax(pair, groups):
    img = np.random.default_rng(5).standard_normal((4, 56, 56, 3)).astype(
        np.float32)
    close(pair.tmodel.model.encode_frames(t(img), mean_pool_groups=groups),
          pair.japply(lambda m, x: m.model.encode_frames(
              x, mean_pool_groups=groups), jnp.asarray(img)))


# ------------------------------------------------------------------- T5
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_matches_jax(bidirectional):
    rel = np.arange(-300, 300).reshape(20, 30)
    want = JT5.relative_position_bucket(jnp.asarray(rel), bidirectional, 32,
                                        128)
    got = TT5.relative_position_bucket(t(rel).long(), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _enc_inputs(seed=6):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, -2:] = 0
    return embeds, mask


def test_t5_encode_matches_jax(pair):
    embeds, mask = _enc_inputs()
    lm = pair.tmodel.model.language_model
    close(lm.encode(t(embeds), t(mask)),
          pair.japply(lambda m, *a: m.model.language_model.encode(*a),
                      jnp.asarray(embeds), jnp.asarray(mask)))


def test_t5_encoder_hands_the_flash_kernels_a_contiguous_bias(monkeypatch):
    """The encoder's bias reaches attention as one contiguous (B, H, S, S)
    f32 tensor, so the flash kernels read a row of keys per query (the
    relative-position table's permuted view has a key stride of H)."""
    from videotgb_torch.models import common

    seen = []

    def record(q, k, v, bias=None, scale=None):
        seen.append(bias)
        return common.dot_product_attention(q, k, v, bias=bias, scale=scale)

    monkeypatch.setattr(common, "flash_attention", record)
    cfg = TT5.T5Config.tiny()
    model = TT5.T5Model(cfg, device="cpu")
    s = 130  # 130 x 130 > 128 x 128: the flash path
    embeds = torch.randn((2, s, cfg.d_model))
    mask = torch.ones((2, s))
    mask[1, -5:] = 0
    model.encode(embeds, mask)
    assert len(seen) == cfg.num_encoder_layers
    for bias in seen:
        assert bias.shape == (2, cfg.num_heads, s, s)
        assert bias.dtype == torch.float32 and bias.is_contiguous()


def test_t5_cached_decode_matches_jax(pair):
    """Prefill (token 0 + cross K/V) then two cached steps: logits equal
    the JAX decoder's at every step, with the cache index a host int and,
    for the steps after the prefill, a 0-dim tensor (the graphed decode's
    device index: positions, relative-position bias and mask computed from
    it), the two routes bit for bit."""
    embeds, mask = _enc_inputs(7)
    lm = pair.tmodel.model.language_model
    enc = lm.encode(t(embeds), t(mask))
    caches_t = pair.tmodel.init_t5_caches(2, 4, 7)
    caches_d = pair.tmodel.init_t5_caches(2, 4, 7)
    enc_j = jnp.asarray(enc.numpy())
    caches_j = pair.japply(lambda m: m.init_t5_caches(2, 4, 7))
    tokens = np.array([[0, 0], [12, 40], [7, 3]], np.int32)
    for i in range(3):
        valid = (np.arange(4)[None] <= i).astype(np.float32).repeat(2, 0)
        logits_j, caches_j = pair.japply(
            lambda m, *a: m.t5_decode_step(*a, cross_prefill=i == 0),
            jnp.asarray(tokens[i][:, None]), enc_j, jnp.asarray(mask),
            caches_j, jnp.int32(i), jnp.asarray(valid))
        logits_t, caches_t = pair.tmodel.t5_decode_step(
            t(tokens[i][:, None]).long(), enc, t(mask), caches_t, i,
            t(valid), cross_prefill=i == 0)
        close(logits_t, logits_j)
        logits_d, caches_d = pair.tmodel.t5_decode_step(
            t(tokens[i][:, None]).long(), enc, t(mask), caches_d,
            torch.tensor(i) if i else 0, t(valid), cross_prefill=i == 0)
        assert torch.equal(logits_d, logits_t)


def test_t5_teacher_forced_matches_jax(pair):
    embeds, mask = _enc_inputs(8)
    dec = np.array([[0, 5, 9, 2], [0, 3, 3, 7]], np.int32)
    lm = pair.tmodel.model.language_model
    close(lm(t(embeds), t(mask), t(dec).long()),
          pair.japply(lambda m, *a: m.model.language_model(*a),
                      jnp.asarray(embeds), jnp.asarray(mask), jnp.asarray(dec)))
