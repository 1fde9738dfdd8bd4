"""The port's beam search (``videotgb_torch.ops.decode.beam_search``) and the
beam branches of both decoders against the JAX package on the CPU, token
for token: the trap and early-EOS step functions of
``tests/test_decode.py``, seeded random dynamics whose two rows finish at
different steps (k in {2, 3}, length_penalty in {0.5, 1.0, 2.0}, with a
repetition penalty, and a row that runs to the horizon), and
``t5_generate_from_encoder`` / ``llama_generate_from_embeds`` on the tiny
f32 models with ``num_beams=3`` (weights carried across with
``videotgb_torch.convert``). Batched beams equal per-row beams in the
port, and ``num_beams=1`` keeps the greedy route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import Pair, few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.models import videotgb as TV
from videotgb_torch.ops import decode as TD
from videotgb_tpu.models import videotgb as JV
from videotgb_tpu.ops import decode as JD

V = 16  # tests/test_decode.py's vocabulary


def _both(fn_jax, fn_torch, start, caches_np, **cfg):
    """(JAX tokens, port tokens) of ``beam_search`` from the same start
    tokens and numpy caches."""
    want = jax.jit(lambda: JD.beam_search(
        fn_jax, jax.tree.map(jnp.asarray, caches_np),
        jnp.asarray(start, jnp.int32), JD.DecodeConfig(**cfg)))()
    got = TD.beam_search(
        fn_torch, {k: torch.from_numpy(v) for k, v in caches_np.items()},
        torch.as_tensor(start).long(), TD.DecodeConfig(**cfg))
    return np.asarray(want), got.numpy()


# ------------------------------------------------- synthetic step functions
def test_trap_matches_jax():
    """Greedy takes token 2; the beams find (3, 4)."""
    def jax_step(tokens, caches, index):
        prev = tokens[:, 0]
        first = jnp.full((V,), -5.0).at[2].set(1.0).at[3].set(0.72)
        after3 = jnp.full((V,), -8.0).at[4].set(8.0)
        logits = jnp.where(index == 0, first[None, :],
                           jnp.where((prev == 3)[:, None], after3[None, :],
                                     jnp.zeros((1, V))))
        return jnp.broadcast_to(logits, (tokens.shape[0], V)), caches

    def torch_step(tokens, caches, index):
        prev = tokens[:, 0]
        if index == 0:
            logits = torch.full((V,), -5.0)
            logits[2], logits[3] = 1.0, 0.72
            return logits.expand(tokens.shape[0], V), caches
        after3 = torch.full((V,), -8.0)
        after3[4] = 8.0
        logits = torch.where((prev == 3)[:, None], after3[None, :],
                             torch.zeros((1, V)))
        return logits, caches

    want, got = _both(jax_step, torch_step, [0],
                      {"dummy": np.zeros((3, 1), np.float32)},
                      max_new_tokens=2, eos_token_id=1, pad_token_id=0,
                      num_beams=3)
    assert want[0].tolist() == [3, 4]
    np.testing.assert_array_equal(got, want)


def test_early_eos_hypothesis_matches_jax():
    """Both live beams retire at step 1; the sample stops before the
    horizon and returns the early hypothesis."""
    first = np.log(np.asarray([1e-6, 1e-6, 0.6, 0.3] + [1e-6] * (V - 4),
                              np.float32))
    later = np.full((V,), -8.0, np.float32)
    later[1], later[4] = 0.0, -3.0

    def jax_step(tokens, caches, index):
        logits = jnp.where(index == 0, first[None, :], later[None, :])
        return jnp.broadcast_to(logits, (tokens.shape[0], V)) * 10.0, caches

    def torch_step(tokens, caches, index):
        row = torch.from_numpy(first if index == 0 else later)
        return row.expand(tokens.shape[0], V) * 10.0, caches

    want, got = _both(jax_step, torch_step, [0],
                      {"dummy": np.zeros((2, 1), np.float32)},
                      max_new_tokens=6, eos_token_id=1, pad_token_id=0,
                      num_beams=2, length_penalty=1.0)
    assert want.tolist() == [[2, 1, 0, 0, 0, 0]]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ seeded random dynamics
D = 6
STEPS = 8


def _dynamics(seed, boost):
    """A hidden state carried in the caches, so that a beam's logits
    depend on its whole history: h' = h Q + E[token] with Q 0.9 x a random
    rotation, logits = 2 h' W, plus ``boost`` x (t - 2) on EOS (id 1), so
    rows finish at steps of their own."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((V, D)).astype(np.float32)
    mix = (0.9 * np.linalg.qr(rng.standard_normal((D, D)))[0]).astype(
        np.float32)
    out = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    eos = np.zeros(V, np.float32)
    eos[1] = boost

    def jax_step(tokens, caches, t):
        h = caches["h"] @ mix + jnp.asarray(emb)[tokens[:, 0]]
        return 2.0 * (h @ out) + eos * (t - 2.0), {"h": h}

    def torch_step(tokens, caches, t):
        h = (caches["h"] @ torch.from_numpy(mix)
             + torch.from_numpy(emb)[tokens[:, 0]])
        return (2.0 * (h @ torch.from_numpy(out))
                + torch.from_numpy(eos) * (t - 2.0)), {"h": h}

    return jax_step, torch_step


def _first_eos(row):
    row = list(row)
    return row.index(1) if 1 in row else None


@pytest.mark.parametrize("seed, boost, k, length_penalty, penalty", [
    # row 0 runs to the horizon, row 1 ends at step 5
    (1, 1.0, 2, 0.5, 1.0), (1, 1.0, 2, 1.0, 1.0), (1, 1.0, 2, 2.0, 1.0),
    (1, 1.0, 3, 0.5, 1.0), (1, 1.0, 3, 1.0, 1.0), (1, 1.0, 3, 2.0, 1.0),
    (1, 1.0, 3, 1.0, 1.5),  # the repetition penalty on the beam buffers
    (3, 0.5, 2, 2.0, 1.0),  # both rows end early, at steps 5 and 7
])
def test_random_dynamics_match_jax(seed, boost, k, length_penalty, penalty):
    jax_step, torch_step = _dynamics(seed, boost)
    want, got = _both(jax_step, torch_step, [3, 7],
                      {"h": np.zeros((2 * k, D), np.float32)},
                      max_new_tokens=STEPS, eos_token_id=1, pad_token_id=0,
                      num_beams=k, length_penalty=length_penalty,
                      repetition_penalty=penalty)
    ends = [_first_eos(r) for r in want]
    assert ends[0] != ends[1], ends  # the rows finish at different steps
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- the decoders' beam branches
@pytest.fixture(scope="module")
def t5_pair():
    return Pair()


@pytest.fixture(scope="module")
def llama_pair():
    return Pair(backbone="instructblip")


def _t5_state(pair, seed=3):
    rng = np.random.default_rng(seed)
    d = pair.tcfg.blip2.t5.d_model
    hidden = rng.standard_normal((2, 7, d)).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 5:] = 0.0
    return hidden, mask


def _eos_from_beams(run):
    """An EOS id the beams reach: the fourth token of row 0 of a first beam
    run whose EOS id lies outside the vocabulary, so that the run that
    counts retires hypotheses on the way."""
    probe = run(TD.DecodeConfig(max_new_tokens=6, eos_token_id=-1,
                                num_beams=3))
    return int(probe[0, 3])


def test_t5_beams_match_jax(t5_pair):
    pair = t5_pair
    hidden, mask = _t5_state(pair)
    th, tm = torch.from_numpy(hidden), torch.from_numpy(mask)
    eos = _eos_from_beams(lambda c: TV.t5_generate_from_encoder(
        pair.tmodel, th, tm, c))
    cfg = dict(max_new_tokens=6, eos_token_id=eos,
               pad_token_id=0, num_beams=3)
    want = jax.jit(lambda p, h, m: JV.t5_generate_from_encoder(
        pair.jmodel, p, h, m, JD.DecodeConfig(**cfg),
        jax.random.key(0)))(pair.params, jnp.asarray(hidden),
                            jnp.asarray(mask))
    got = TV.t5_generate_from_encoder(pair.tmodel, th, tm,
                                      TD.DecodeConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == cfg["eos_token_id"]).any()


def _llama_prefix(pair, seed=4):
    rng = np.random.default_rng(seed)
    d = pair.tcfg.instructblip.llm.hidden_size
    embeds = rng.standard_normal((2, 9, d)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 5:] = 0.0  # rows of 9 and 5 real tokens
    return embeds, mask


def test_llama_beams_match_jax(llama_pair):
    pair = llama_pair
    embeds, mask = _llama_prefix(pair)
    te, tm = torch.from_numpy(embeds), torch.from_numpy(mask)
    eos = _eos_from_beams(lambda c: TV.llama_generate_from_embeds(
        pair.tmodel, te, tm, c))
    cfg = dict(max_new_tokens=6, eos_token_id=eos,
               pad_token_id=0, num_beams=3)
    want = jax.jit(lambda p, e, m: JV.llama_generate_from_embeds(
        pair.jmodel, p, e, m, JD.DecodeConfig(**cfg),
        jax.random.key(0)))(pair.params, jnp.asarray(embeds),
                            jnp.asarray(mask))
    got = TV.llama_generate_from_embeds(pair.tmodel, te, tm,
                                        TD.DecodeConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == cfg["eos_token_id"]).any()


@pytest.mark.parametrize("branch", ["t5", "llama"])
def test_batched_beams_equal_per_row_beams(t5_pair, llama_pair, branch):
    """The reorder stays within a sample's rows: two samples in one batch
    give each sample's own beams (the LLaMA rows have prompts of 9 and 5
    tokens, so their masks and lengths differ)."""
    if branch == "t5":
        model, (x, mask) = t5_pair.tmodel, _t5_state(t5_pair)
        run = TV.t5_generate_from_encoder
    else:
        model, (x, mask) = llama_pair.tmodel, _llama_prefix(llama_pair)
        run = TV.llama_generate_from_embeds
    cfg = TD.DecodeConfig(max_new_tokens=6, eos_token_id=5, pad_token_id=0,
                          num_beams=3, length_penalty=0.5)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    batched = run(model, x, mask, cfg)
    for i in range(2):
        one = run(model, x[i:i + 1], mask[i:i + 1], cfg)
        np.testing.assert_array_equal(batched[i:i + 1].numpy(), one.numpy())


def test_one_beam_is_the_greedy_route(t5_pair):
    pair = t5_pair
    hidden, mask = map(torch.from_numpy, _t5_state(pair))
    cfg = TD.DecodeConfig(max_new_tokens=6, num_beams=1)
    model = pair.tmodel
    caches = model.init_t5_caches(2, 6, hidden.shape[1])
    steps = torch.arange(6)

    def step_fn(tokens, caches, index):
        valid = (steps[None] <= index).float().expand(2, 6)
        return model.t5_decode_step(tokens, hidden, mask, caches, index,
                                    valid, cross_prefill=index == 0)

    start = torch.full((2,), pair.tcfg.blip2.t5.decoder_start_token_id)
    want = TD.decode(step_fn, caches, start, cfg)
    got = TV.t5_generate_from_encoder(model, hidden, mask, cfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
