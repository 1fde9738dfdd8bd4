"""The CUDA-graph slice of the port on the CPU, against the JAX package.

On the CPU every graphed entry point runs its eager route; these tests hold
the code a graph captures on the card to the JAX package's compiled
programs: the chunked ``decode`` (greedy, with stop sequences, EOS
mid-chunk and at a chunk's edge, for several chunk sizes),
``Trainer.train_step_multi`` and ``fit(steps_per_dispatch=K)``, and AdamW
with a tensor learning rate against optax. The T5 and LLaMA decode steps
at a device cache index are held in ``tests/test_torch_models.py`` and
``tests/test_torch_instructblip.py``, beside their host-index cases.
Tolerance 2e-4 (tests/test_parity.py's) for outputs, exact for token ids.
The captures themselves are held on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 20).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from _torch_port_helpers import close, few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles, run_once  # noqa: F401
from videotgb_torch.ops import decode as TD
from videotgb_torch.ops import kernels
from videotgb_torch.training import optim as TO
from videotgb_torch.training.trainer import Trainer, TrainerConfig
from videotgb_torch.utils import graphs
from videotgb_tpu.ops import decode as JD
from videotgb_tpu.parallel.mesh import MeshConfig
from videotgb_tpu.training import optim as JO
from videotgb_tpu.training import trainer as JTR

B, MAX_NEW = 2, 6


# ------------------------------------------------------------ chunked decode
V, EOS, PAD = 12, 1, 0


def _targets(eos_at, n):
    """(B, n) token ids the toy step emits at each index; row r ends with
    EOS at step ``eos_at[r]`` (None: never)."""
    rng = np.random.default_rng(7)
    tg = rng.integers(2, V, (len(eos_at), n)).astype(np.int64)
    for r, e in enumerate(eos_at):
        if e is not None:
            tg[r, e] = EOS
    return tg


def _toy_steps(tg):
    """The same toy model for both packages: the logits at step ``index``
    peak at ``tg[row, index]`` plus a bias from the previous token, and the
    cache keeps the tokens fed in (written in place on the port)."""
    bias = np.random.default_rng(8).standard_normal((V, V)).astype(
        np.float32) * 0.1

    def tstep(tokens, caches, index):
        idx = torch.as_tensor(index).long().view(1, 1).expand(len(tg), 1)
        peak = torch.gather(torch.from_numpy(tg), 1, idx)[:, 0]
        logits = torch.from_numpy(bias)[tokens[:, 0]]
        logits = logits + 5.0 * torch.nn.functional.one_hot(peak, V).float()
        caches["seen"].scatter_(1, idx, tokens)
        return logits, caches

    def jstep(tokens, caches, index):
        peak = jnp.asarray(tg)[:, index]
        logits = jnp.asarray(bias)[tokens[:, 0]]
        logits = logits + 5.0 * jax.nn.one_hot(peak, V)
        seen = jax.lax.dynamic_update_slice_in_dim(caches["seen"], tokens,
                                                   index, axis=1)
        return logits, {"seen": seen}

    return tstep, jstep


DECODE_CASES = {
    # EOS at step 3: mid-chunk for chunks of 4 and 8, the last step of a
    # chunk of 3 (steps 1-3); row 1 runs to the horizon
    "eos_mid_and_edge": ([3, None], ()),
    # both rows finish: the loop stops at a chunk's end, the rest pad
    "all_finish": ([2, 4], ()),
    "eos_at_step_0": ([0, 5], ()),
    # a stop sequence (tg[0, 2], tg[0, 3]) ends row 0 at step 3
    "stop_sequence": ([None, None], "row0"),
}


@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_chunked_decode_equals_jax(monkeypatch, case, chunk):
    eos_at, stops = DECODE_CASES[case]
    tg = _targets(eos_at, MAX_NEW)
    if stops == "row0":
        stops = ((int(tg[0, 2]), int(tg[0, 3])),)
    tstep, jstep = _toy_steps(tg)
    cfg = dict(max_new_tokens=MAX_NEW, eos_token_id=EOS, pad_token_id=PAD)
    start = np.array([3, 4])
    want = JD.decode(jstep, {"seen": jnp.zeros((B, MAX_NEW), jnp.int32)},
                     jnp.asarray(start), JD.DecodeConfig(**cfg),
                     stop_sequences=stops)
    monkeypatch.setattr(TD, "CHUNK", chunk)
    seen = torch.zeros((B, MAX_NEW), dtype=torch.long)
    got = TD.decode(tstep, {"seen": seen}, torch.from_numpy(start),
                    TD.DecodeConfig(**cfg), stop_sequences=stops)
    assert got.dtype == torch.int64 and got.shape == (B, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_decode_draws_alike_for_every_chunk(monkeypatch):
    """Sampling draws the same ids from the same generator state whatever
    the chunk size, and its draw is ``torch.multinomial``'s."""
    tg = _targets([None, None], MAX_NEW)
    tstep, _ = _toy_steps(tg)
    cfg = TD.DecodeConfig(max_new_tokens=MAX_NEW, eos_token_id=EOS,
                          pad_token_id=PAD, do_sample=True, temperature=2.0)
    runs = []
    for chunk in (1, 4):
        monkeypatch.setattr(TD, "CHUNK", chunk)
        gen = torch.Generator().manual_seed(11)
        runs.append(TD.decode(
            tstep, {"seen": torch.zeros((B, MAX_NEW), dtype=torch.long)},
            torch.tensor([3, 4]), cfg, generator=gen))
    assert torch.equal(*runs)
    probs = torch.softmax(torch.randn(3, V, generator=torch.Generator()
                                      .manual_seed(1)), -1)
    a = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(2))
    q = torch.empty_like(probs).exponential_(
        1, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a[:, 0], torch.argmax(probs / q, -1))


def test_decode_refuses_a_step_that_replaces_its_caches():
    tg = _targets([None, None], MAX_NEW)
    tstep, _ = _toy_steps(tg)

    def copying(tokens, caches, index):
        logits, caches = tstep(tokens, caches, index)
        return logits, {"seen": caches["seen"].clone()}

    with pytest.raises(ValueError, match="in place"):
        TD.decode(copying, {"seen": torch.zeros((B, MAX_NEW),
                                                dtype=torch.long)},
                  torch.tensor([3, 4]), TD.DecodeConfig(max_new_tokens=4))


# ------------------------------------------------------- the graphed wrapper
def test_graphed_runs_the_function_on_the_cpu():
    calls = []

    @graphs.graphed(eager_when=lambda a: a["beams"] > 1)
    def fn(x, beams=1):
        calls.append(beams)
        return {"y": x * 2}

    x = torch.arange(3.0)
    for beams in (1, 1, 3):
        assert torch.equal(fn(x, beams=beams)["y"], x * 2)
    assert calls == [1, 1, 3] and fn.eager.__name__ == "fn"


def test_replayed_tallies_add_to_the_counts():
    kernels.reset_launches()
    tally = collections.Counter({("flash_fwd", "mma"): 3,
                                 ("corr_lookup", "tile"): 2,
                                 ("select_frames", None): 1})
    for _ in range(2):
        kernels.replayed(tally)
    assert kernels.LAUNCHES["flash_fwd"] == 6
    assert kernels.MMA_LAUNCHES["flash_fwd"] == 6
    assert kernels.TILE_LAUNCHES["corr_lookup"] == 4
    assert kernels.LAUNCHES["select_frames"] == 2
    kernels.reset_launches()


# ---------------------------------------------- K steps a dispatch, and fit
def _toy_model():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.randn(4, 3, generator=gen))
    model.b = torch.nn.Parameter(torch.zeros(3))
    return model


def _toy_loss(model, batch, generator):
    """Noise-free, so the JAX loss (its own RNG) computes the same."""
    loss = torch.mean((batch["x"] @ model.w + model.b - batch["y"]) ** 2)
    return loss, {"loss": loss, "mae": torch.mean(torch.abs(
        batch["x"] @ model.w + model.b - batch["y"]))}


def _jax_loss(params, batch, key):
    err = batch["x"] @ params["w"] + params["b"] - batch["y"]
    loss = jnp.mean(err ** 2)
    return loss, {"loss": loss, "mae": jnp.mean(jnp.abs(err))}


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((8, 4)).astype(np.float32),
             "y": rng.standard_normal((8, 3)).astype(np.float32)}
            for _ in range(n)]


def _port(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def _jax_trainer(**cfg):
    tr = JTR.Trainer(JTR.TrainerConfig(**cfg, mesh=MeshConfig(dp=1)),
                     _jax_loss)
    w = _toy_model()
    state = tr.init_state({"w": jnp.asarray(w.w.detach().numpy()),
                           "b": jnp.asarray(w.b.detach().numpy())})
    rep = NamedSharding(tr.mesh, PartitionSpec())
    return tr, JTR.TrainState(*(jax.device_put(x, rep) for x in (
        state.params, state.opt_state, state.step)))


TOY = dict(max_steps=10, lr=1e-2, weight_decay=0.01, seed=7)


def test_train_step_multi_equals_k_steps_and_jax():
    """A window of K = 4 against four ``train_step`` calls (bit for bit)
    and against the JAX trainer's ``train_step_multi`` (2e-4)."""
    batches = _batches(4)
    t1 = Trainer(TrainerConfig(**TOY), _toy_loss)
    s1 = t1.init_state(_toy_model())
    singles = []
    for b in _port(batches):
        s1, m = t1.train_step(s1, b)
        singles.append(m)

    t2 = Trainer(TrainerConfig(**TOY), _toy_loss)
    s2 = t2.init_state(_toy_model())
    window = {k: torch.stack([b[k] for b in _port(batches)])
              for k in batches[0]}
    s2, stacked = t2.train_step_multi(s2, window)
    assert s1.step == s2.step == 4
    for k in ("loss", "grad_norm", "mae", "lr"):
        assert stacked[k].shape == (4,)
        assert [float(v) for v in stacked[k]] == [float(m[k])
                                                   for m in singles], k
    for name, p in s1.model.named_parameters():
        assert torch.equal(p, dict(s2.model.named_parameters())[name]), name

    jt, js = _jax_trainer(**TOY)
    js, jstacked = jt.train_step_multi(
        js, {k: jnp.stack([b[k] for b in batches]) for k in batches[0]})
    for k in ("loss", "grad_norm", "mae", "lr"):
        close(stacked[k], np.asarray(jstacked[k]))
    close(s2.model.w, np.asarray(js.params["w"]))
    close(s2.model.b, np.asarray(js.params["b"]))


def test_fit_windows_stop_at_the_horizon():
    """K = 4 does not divide max_steps = 10: two windows and two single
    steps, ending at step 10 with the K = 1 run's parameters bit for bit."""
    batches = _port(_batches(20))
    runs = []
    for k in (1, 4):
        tr = Trainer(TrainerConfig(**TOY, steps_per_dispatch=k), _toy_loss)
        sizes = []
        multi = tr.train_step_multi
        tr.train_step_multi = lambda s, w: (sizes.append(len(w["x"])),
                                            multi(s, w))[1]
        state = tr.fit(tr.init_state(_toy_model()), iter(batches))
        assert state.step == 10
        runs.append((state, sizes))
    assert runs[0][1] == [] and runs[1][1] == [4, 4]
    for name, p in runs[0][0].model.named_parameters():
        assert torch.equal(p, dict(runs[1][0].model.named_parameters())[name])


def test_fit_takes_one_step_a_dispatch_under_a_batch_transform():
    seen = []

    def transform(state, batch):
        seen.append(state.step)
        return batch

    tr = Trainer(TrainerConfig(**dict(TOY, max_steps=6),
                               steps_per_dispatch=4), _toy_loss)
    state = tr.fit(tr.init_state(_toy_model()), iter(_port(_batches(6))),
                   batch_transform=transform)
    assert state.step == 6 and seen == [0, 1, 2, 3, 4, 5]


class _Record:
    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, tuple(sorted(metrics))))


@pytest.mark.parametrize("k,n_batches", [(3, 12), (3, 7)])
def test_windowed_fit_cadence_equals_jax(k, n_batches):
    """Logs, evals and saves of a K-step fit (the ``crossed`` test across
    windows, the periodic save on the window's last step), the JAX fit's
    with the same K, also when the stream ends inside a window."""
    cfg = dict(max_steps=10, log_every=2, eval_every=4, checkpoint_every=3,
               lr=1e-2, seed=7, steps_per_dispatch=k)
    batches = _batches(n_batches)
    runs = {}
    for name in ("port", "jax"):
        rec, evals, saves = _Record(), [], []

        def eval_fn(state, evals=evals):
            evals.append(int(state.step))
            return {"val/score": 0.1 * int(state.step)}

        def ckpt_fn(state, metrics, saves=saves):
            saves.append((int(state.step), metrics is None))

        if name == "port":
            tr = Trainer(TrainerConfig(**cfg), _toy_loss)
            state, feed = tr.init_state(_toy_model()), iter(_port(batches))
        else:
            tr, state = _jax_trainer(**cfg)
            feed = iter([{k_: jnp.asarray(v) for k_, v in b.items()}
                         for b in batches])
        tr.writers = rec
        state = tr.fit(state, feed, eval_fn=eval_fn, checkpoint_fn=ckpt_fn)
        runs[name] = (rec.logged, evals, saves, int(state.step))
    assert runs["port"] == runs["jax"]


# --------------------------------------------- AdamW at a tensor learning rate
def test_adamw_at_a_tensor_lr_equals_optax():
    """Two clipped AdamW steps with the learning rate given as a 0-dim f32
    tensor (as the graphed step hands it) against the JAX package's optax
    chain, gradients from a seed; on the CPU the optimizer is not
    ``capturable`` (that flag is for parameters on the card)."""
    rng = np.random.default_rng(9)
    model = _toy_model()
    opt, names = TO.make_optimizer(model, weight_decay=0.01)
    assert names == ["w", "b"] and not opt.param_groups[0]["capturable"]
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in model.named_parameters()}
    schedule = JO.cosine_warmup_schedule(1e-2, 10)
    tx, _ = JO.make_optimizer(params, schedule, 0.01, None, 0.5)
    state = tx.init(params)

    def apply(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    lrs = TO.cosine_warmup_schedule(1e-2, 10)
    for step in range(2):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) * 3
                 for n, p in params.items()}
        params, state = run_once(apply, {n: jnp.asarray(g) for n, g in
                                         grads.items()}, state, params)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())  # clipped in place
        norm = TO.optimizer_step(opt, torch.full((), lrs(step)), 0.5)
        close(norm, np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                for g in grads.values())))
    for n, p in model.named_parameters():
        close(p, np.asarray(params[n]))
    assert float(opt.state[model.w]["step"]) == 2.0


def test_unused_parameters_step_on_zeros_made_once():
    """A trainable parameter without a gradient steps on zeros (JAX's
    gradient of an unused leaf), made at the first step and zeroed again
    at each later one, so a graph captures no allocation for them."""
    model = _toy_model()
    opt, _ = TO.make_optimizer(model)
    model.w.grad = torch.ones_like(model.w)
    TO.optimizer_step(opt, 1e-2)
    zeros = opt._unused_grads[model.b]
    zeros.fill_(7.0)  # a poisoned buffer is zeroed before its next use
    model.w.grad = torch.ones_like(model.w)
    b_before = model.b.detach().clone()
    TO.optimizer_step(opt, 1e-2)
    assert opt._unused_grads[model.b] is zeros and not bool(zeros.any())
    assert torch.equal(model.b, b_before)  # zero moments, zero decay
