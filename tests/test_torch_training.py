"""videotgb_torch's training path against videotgb_tpu's on the CPU.

The tiny VideoTGB in f32 on both sides, one set of numpy weights carried
across by ``videotgb_torch.convert``: the span and LM losses, the schedule,
the freeze filters, the loss and the gradient of every trainable parameter
of the TG and E2E recipes (JAX: ``jax.value_and_grad`` with the JAX
trainer's stop-gradient freeze, dropout off), and two optimizer steps
against the optax chain of ``videotgb_tpu.training.optim.make_optimizer``.
Tolerance 2e-4 (tests/test_parity.py's f32 tolerance) unless a test says
otherwise.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from _torch_port_helpers import B, L_FLOW, TOL, Pair, close, few_torch_threads, t  # noqa: F401
from videotgb_torch import train as TT
from videotgb_torch.convert import _map_path, flax_to_state_dict, load_flax_params
from videotgb_torch.models import blip2 as TB
from videotgb_torch.models import videotgb as TV
from videotgb_torch.models.common import dropout
from videotgb_torch.training import optim as TO
from videotgb_torch.training import recipes as TR
from videotgb_torch.training.trainer import Trainer, TrainerConfig
from videotgb_tpu.models import blip2 as JB
from videotgb_tpu.training import optim as JO
from videotgb_tpu.training import recipes as JR

ANSWER_LEN = 5


@pytest.fixture(scope="module")
def pair():
    return Pair(seed=3)


def make_batch(pair, seed):
    """numpy training batch of the tiny config: TG (flow, spans) and E2E
    (candidate frames, question, answer with pads) entries together."""
    cfg = pair.jcfg
    rng = np.random.default_rng(seed)
    img, fs = cfg.blip2.vit.image_size, cfg.tgb.flow_size
    answers = rng.integers(2, 60, (B, ANSWER_LEN)).astype(np.int32)
    answers[0, 3:] = cfg.blip2.t5.pad_token_id
    x = pair.inputs
    return {
        "frames": rng.standard_normal((B, cfg.num_frames, img, img, 3)
                                      ).astype(np.float32),
        "flow": rng.standard_normal((B, L_FLOW, fs, fs, 2)).astype(np.float32),
        "flow_mask": x["flow_mask"],
        "video_length": x["video_length"],
        "sampler_question_ids": rng.integers(4, 60, (B, 5)).astype(np.int32),
        "sampler_question_mask": x["sampler_question_mask"],
        "question_ids": rng.integers(4, 60, (B, 6)).astype(np.int32),
        "question_mask": x["question_mask"],
        "answer_ids": answers,
        "starts": np.array([0, 1], np.int32),
        "ends": np.array([2, L_FLOW], np.int32),  # L_FLOW: the ignore index
    }


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: t(v) for k, v in batch.items()}


RECIPE_CASES = {
    "tg": (JR.TGRecipe(), TR.TGRecipe()),
    "e2e_uniform": (JR.E2ERecipe(selection="uniform"),
                    TR.E2ERecipe(selection="uniform")),
    "e2e_tgb": (JR.E2ERecipe(selection="tgb"), TR.E2ERecipe(selection="tgb")),
}


def gumbel_noise(pair):
    rng = np.random.default_rng(11)
    return rng.gumbel(size=(pair.jcfg.top_k, 2, B, L_FLOW)).astype(np.float32)


_GRAD_FNS = {}


def jax_value_and_grad(pair, case):
    """Jitted (params, batch) -> (loss, grads) of the JAX recipe with the
    JAX trainer's freeze (stop_gradient on frozen leaves), dropout off; the
    "tgb" selection reads the shared numpy Gumbel noise."""
    if case not in _GRAD_FNS:
        jrecipe = RECIPE_CASES[case][0]
        params = pair.params["params"]
        mask = JO.trainable_mask(params, jrecipe.filter_fn)
        noise = jnp.asarray(gumbel_noise(pair))

        def loss(p, batch):
            p = jax.tree.map(lambda m, x: x if m else jax.lax.stop_gradient(x),
                             mask, p)
            with mock.patch.object(jax.random, "gumbel",
                                   lambda key, shape, dtype=None: noise):
                return jrecipe.loss_fn(pair.jmodel, p, batch,
                                       jax.random.key(0),
                                       deterministic=True)[0]

        _GRAD_FNS[case] = jax.jit(jax.value_and_grad(loss))
    return _GRAD_FNS[case]


def port_loss_fn(pair, case):
    trecipe = RECIPE_CASES[case][1]
    noise = t(gumbel_noise(pair)) if case == "e2e_tgb" else None

    def loss_fn(model, batch, generator):
        kwargs = {"noise": noise} if noise is not None else {}
        return trecipe.loss_fn(model, batch, generator, deterministic=True,
                               **kwargs)

    return loss_fn


def fresh_port_model(pair):
    model = TV.VideoTGB(pair.tcfg, device="cpu")
    return load_flax_params(model, pair.tree)


# ------------------------------------------------------------------ losses
def test_span_ce_loss_matches_jax():
    rng = np.random.default_rng(1)
    start, end = (rng.standard_normal((4, 7)).astype(np.float32)
                  for _ in range(2))
    # in range, the ignore index L, beyond it (clamped to L), below 0
    st = np.array([0, 6, 7, 9], np.int32)
    en = np.array([3, -2, 7, 5], np.int32)
    want = JR.span_ce_loss(*(jnp.asarray(x) for x in (start, end, st, en)))
    close(TR.span_ce_loss(t(start), t(end), t(st), t(en)), want)
    all_ignored = JR.span_ce_loss(jnp.asarray(start), jnp.asarray(end),
                                  jnp.full((4,), 7), jnp.full((4,), 7))
    close(TR.span_ce_loss(t(start), t(end), torch.full((4,), 7),
                          torch.full((4,), 7)), all_ignored)


def test_cross_entropy_ignore_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 2:] = JB.IGNORE_INDEX
    close(TB.cross_entropy_ignore(t(logits), t(labels)),
          JB.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels)))
    labels[:] = JB.IGNORE_INDEX
    assert float(TB.cross_entropy_ignore(t(logits), t(labels))) == 0.0


@pytest.mark.parametrize("total,ratio", [(10, 0.05), (40, 0.25), (3, 0.5)])
def test_cosine_warmup_schedule_matches_optax(total, ratio):
    """Same values at every step; optax evaluates in f32, the port in f64,
    hence rtol 1e-5."""
    want = JO.cosine_warmup_schedule(1e-3, total, ratio)
    got = TO.cosine_warmup_schedule(1e-3, total, ratio)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("mean_pool", [False, True])
def test_blip2_loss_pass_matches_jax(pair, mean_pool):
    """Visual tokens per frame (or mean-pooled), teacher forcing, pad ->
    -100 labels, a text-only row through ``visual_valid``."""
    x = make_batch(pair, 5)
    frames = x["frames"][:, :pair.jcfg.nframe]
    valid = np.array([1.0, 0.0], np.float32)
    args = (frames, x["question_ids"], x["question_mask"], x["answer_ids"])
    want_loss, want_logits = pair.japply(
        lambda m, *a: m.model(*a[:4], mean_pool=mean_pool,
                              visual_valid=a[4]),
        *(jnp.asarray(a) for a in args), jnp.asarray(valid))
    with torch.no_grad():
        loss, logits = pair.tmodel.model(*(t(a) for a in args),
                                         mean_pool=mean_pool,
                                         visual_valid=t(valid))
    assert tuple(logits.shape) == (B, ANSWER_LEN, pair.jcfg.blip2.t5.vocab_size)
    close(logits, want_logits)
    close(loss, want_loss)


# ------------------------------------------------------------------ freezing
@pytest.mark.parametrize("case", ["tg", "e2e_uniform"])
def test_freeze_filter_selects_the_jax_leaves(pair, case):
    jrecipe, trecipe = RECIPE_CASES[case]
    flat = flatten_dict(pair.tree)
    want = {_map_path(path)[0] for path, leaf in flat.items()
            if jrecipe.filter_fn(tuple(jax.tree_util.DictKey(p) for p in path),
                                 leaf)}
    names = [n for n, _ in pair.tmodel.named_parameters()]
    got = {n for n in names if trecipe.filter_fn(n)}
    assert got == want
    assert 0 < len(got) < len(names)


# --------------------------------------------------- recipe losses and grads
@pytest.mark.parametrize("case", sorted(RECIPE_CASES))
def test_recipe_loss_and_gradients_match_jax(pair, case):
    """Loss and the gradient of every trainable parameter, f32, 2e-4."""
    x = make_batch(pair, 7)
    loss_j, grads_j = jax_value_and_grad(pair, case)(pair.params["params"],
                                                     to_jax(x))
    grads_j = flax_to_state_dict(jax.device_get(grads_j))
    model = fresh_port_model(pair)
    trecipe = RECIPE_CASES[case][1]
    _, names = TO.make_optimizer(model, filter_fn=trecipe.filter_fn)
    loss, _ = port_loss_fn(pair, case)(model, to_torch(x), None)
    loss.backward()
    close(loss, loss_j)
    moved = 0
    for name, p in model.named_parameters():
        if name not in names:
            assert p.grad is None, name
            continue
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), grads_j[name].numpy(),
                                   err_msg=name, **TOL)
        moved += int(p.grad is not None)
    assert moved > 0


@pytest.mark.parametrize("accum", [1, 2])
def test_two_optimizer_steps_match_optax(pair, accum):
    """Two Trainer steps (E2E, uniform selection) against the optax chain of
    the JAX package applied to the JAX gradients. Step 0 of the warmup has
    lr 0; step 1 has the peak lr 1e-3. Tolerance: the gradients agree to
    2e-4, and an Adam step divides each by its running RMS, so a parameter
    moves by up to lr whatever its gradient's size; atol 1e-5 (1% of a
    step) and rtol 2e-4 on the parameters. Entries whose gradient is zero
    up to f32 rounding (|g| < 1e-6: the attention key biases, which shift
    every score of a row alike) step by the sign of rounding noise in both
    packages; they are held to moving at most one step. Frozen parameters
    stay bit-identical."""
    case = "e2e_uniform"
    jrecipe, trecipe = RECIPE_CASES[case]
    micro = [make_batch(pair, 20 + i) for i in range(accum)]
    lr, wd, steps = 1e-3, 0.01, 10
    schedule = JO.cosine_warmup_schedule(lr, steps)
    params = pair.params["params"]
    tx, _ = JO.make_optimizer(params, schedule, wd, jrecipe.filter_fn, 1.0)
    opt_state = jax.jit(tx.init)(params)
    grad_fn = jax_value_and_grad(pair, case)

    @jax.jit
    def apply(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(2):
        grads = [grad_fn(params, to_jax(mb))[1] for mb in micro]
        grads = jax.tree.map(lambda *g: sum(g) / accum, *grads)
        params, opt_state = apply(grads, opt_state, params)
    want = flax_to_state_dict(jax.device_get(params))
    noise_floor = {k: g.abs() < 1e-6 for k, g in
                   flax_to_state_dict(jax.device_get(grads)).items()}

    model = fresh_port_model(pair)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(TrainerConfig(max_steps=steps, lr=lr, weight_decay=wd,
                                    accumulate_grad_batches=accum),
                      port_loss_fn(pair, case), trecipe.filter_fn)
    state = trainer.init_state(model)
    batch = to_torch(micro[0] if accum == 1 else
                     {k: np.stack([mb[k] for mb in micro]) for k in micro[0]})
    lrs = []
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
        assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
        lrs.append(metrics["lr"])
    assert lrs == [0.0, lr] and state.step == 2
    trainable = set(trainer.trainable)
    for name, p in model.named_parameters():
        if name in trainable:
            real = ~noise_floor[name]
            np.testing.assert_allclose(p.detach()[real].numpy(),
                                       want[name][real].numpy(),
                                       atol=1e-5, rtol=2e-4, err_msg=name)
            step = (p.detach() - before[name])[~real].abs()
            assert bool((step <= lr * 1.01 + 1e-7).all()), name
        else:
            assert torch.equal(p, before[name]), name
    assert any(not torch.equal(dict(model.named_parameters())[n], before[n])
               for n in trainable)


# ------------------------------------------------------------------ dropout
def test_dropout_keeps_about_ninety_percent():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, gen, deterministic=False)
    kept = y != 0
    assert 0.89 < float(kept.float().mean()) < 0.91
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, gen, deterministic=True), x)


def test_tgb_dropout_is_off_when_deterministic(pair):
    x = make_batch(pair, 9)
    args = [t(x[k]) for k in ("flow", "flow_mask", "sampler_question_ids",
                              "sampler_question_mask")]
    model = pair.tmodel
    with torch.no_grad():
        _, eval_start, _ = model.span_logits(*args, mode="multi_modal")
        _, det_start, _ = model.span_logits(*args, mode="multi_modal",
                                            deterministic=True)
        runs = [model.span_logits(*args, mode="multi_modal",
                                  deterministic=False,
                                  generator=torch.Generator().manual_seed(4))[1]
                for _ in range(2)]
    assert torch.equal(det_start, eval_start)
    assert torch.equal(runs[0], runs[1])  # the generator decides the masks
    assert not torch.allclose(runs[0], eval_start)


# ------------------------------------------------------------- entry point
def test_build_model_and_recipe_from_model_config_keys():
    """The keys of configs/model/LSTP_blip2_e2e.yaml, LSTP_TG_blip2.yaml,
    the SF and stage-3 (IV, IVT with ``lora_rank``) model configs, and a
    train step of the tiny preset on the CPU."""
    e2e = TT.build_recipe({"recipe": "e2e", "tgb_mode": "multi_modal",
                           "selection": "uniform"})
    assert e2e == TR.E2ERecipe(mode="multi_modal", selection="uniform")
    assert TT.build_recipe({"recipe": "tg", "tgb_mode": "fusion"}) == \
        TR.TGRecipe(mode="fusion")
    assert TT.build_recipe({"recipe": "sf", "online_flow": True}) == \
        TR.SFRecipe(online_flow=True)
    assert TT.build_recipe({"recipe": "iv", "tgb_mode": "fusion"}) == \
        TR.IVRecipe()
    assert TT.build_recipe({"recipe": "ivt"}) == TR.IVTRecipe()
    _, lora = TT.build_model({"preset": "tiny", "backbone": "instructblip",
                              "lora_rank": 8}, device="cpu")
    assert lora.instructblip.llm.lora_rank == 8
    model, cfg = TT.build_model({"preset": "tiny"}, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(0)
    img = cfg.blip2.vit.image_size
    batch = {
        "frames": torch.randn((2, cfg.num_frames, img, img, 3), generator=gen),
        "question_ids": torch.randint(4, 60, (2, 6), generator=gen),
        "question_mask": torch.ones((2, 6)),
        "answer_ids": torch.randint(2, 60, (2, 4), generator=gen),
    }
    trainer = Trainer(TrainerConfig(max_steps=4), e2e.loss_fn, e2e.filter_fn)
    state = trainer.init_state(model)
    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
    assert torch.isfinite(metrics["loss"]) and metrics["lr"] > 0
