"""videotgb_torch's training and evaluation CLIs against videotgb_tpu's, on
the CPU: the synthetic and VideoInstruct data, the prefetch loader, the
metrics, the checkpoint manager and resume, ``Trainer.fit``'s cadence, the
tiny TG recipe through ``fit`` and ``evaluate_tg`` with the JAX package's
seeded weights carried across, and ``train.main`` / ``evaluate.main`` end
to end. Tolerance 2e-4 in f32 (tests/test_parity.py's) where one applies;
everything else is exact. The JAX ``train()`` and flax ``init`` are never
run (tens of seconds of compiles at tiny); the weights come from
``tests/_torch_port_helpers.py``.
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from _torch_port_helpers import TOL, Pair, close, few_torch_threads  # noqa: F401
from videotgb_torch import evaluate as TE
from videotgb_torch import train as TT
from videotgb_torch.config import compose
from videotgb_torch.convert import flax_to_state_dict
from videotgb_torch.data import datasets as TD
from videotgb_torch.data import loader as TLD
from videotgb_torch.data.tokenizer import load_tokenizer as t_tokenizer
from videotgb_torch.training import checkpoint as TCK
from videotgb_torch.training import metrics as TM
from videotgb_torch.training import recipes as TR
from videotgb_torch.training.optim import cosine_warmup_schedule
from videotgb_torch.training.trainer import Trainer, TrainerConfig
from videotgb_tpu import train as JT
from videotgb_tpu.data import datasets as JD
from videotgb_tpu.data import loader as JLD
from videotgb_tpu.data.tokenizer import load_tokenizer as j_tokenizer
from videotgb_tpu.parallel.mesh import MeshConfig
from videotgb_tpu.training import checkpoint as JCK
from videotgb_tpu.training import metrics as JM
from videotgb_tpu.training import recipes as JR
from videotgb_tpu.training import trainer as JTR

CPU = ["trainer=cpu", "extras.print_config=false"]


def same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# --------------------------------------------------------------------- data
SYN = dict(length=6, num_frames=4, max_flow_len=5, flow_len_range=(3, 5),
           image_size=28, flow_size=16, nframe=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_items_and_collate_equal_jax(seed):
    tds, jds = TD.SyntheticVideoQA(seed=seed, **SYN), JD.SyntheticVideoQA(
        seed=seed, **SYN)
    for i in range(len(tds)):
        same_batch(tds[i], jds[i])
    samples = [tds[i] for i in (0, 3, 5)]
    kw = dict(max_flow_len=5, max_txt_len=12, nframe=2, answer_len=6)
    same_batch(
        TD.collate_videoinstruct(samples, t_tokenizer("byte"),
                                 t_tokenizer("byte"), **kw),
        JD.collate_videoinstruct(samples, j_tokenizer("byte"),
                                 j_tokenizer("byte"), **kw))


def test_videoinstruct_dataset_reads_the_files_as_jax(tmp_path, monkeypatch):
    """The JAX dataset on its numpy transform path: the C++ host library of
    ``clip_transform`` is not ported (ROADMAP.md queue 1 item 3)."""
    cv2 = pytest.importorskip("cv2")
    from videotgb_tpu.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(0)
    for d in ("text", "video", "flow"):
        (tmp_path / d).mkdir()
    rows = {"0": {"q": "what moves?", "a": "a red car", "video_id": "clip"},
            "1": {"q": "who sings?", "a": "nobody", "video_id": "clip"}}
    (tmp_path / "text" / "train.json").write_text(json.dumps(rows))
    (tmp_path / "text" / "pseudo_label.json").write_text(
        json.dumps({"0": [4, 20]}))
    np.save(tmp_path / "flow" / "clip_raft.npy",
            rng.standard_normal((9, 2, 12, 12)).astype(np.float32))
    writer = cv2.VideoWriter(str(tmp_path / "video" / "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (40, 32))
    for _ in range(14):
        writer.write(rng.integers(0, 255, (32, 40, 3), np.uint8))
    writer.release()
    args = (str(tmp_path / "text"), str(tmp_path / "video"),
            str(tmp_path / "flow"))
    kw = dict(num_frames=6, max_flow_len=5, nframe=2, image_size=24)
    tds, jds = TD.VideoInstructDataset(*args, **kw), JD.VideoInstructDataset(
        *args, **kw)
    assert len(tds) == len(jds) == 2
    for i in range(2):
        same_batch(tds[i], jds[i])
    assert tds[0]["frames"].shape == (6, 24, 24, 3)
    assert tds[0]["flow"].shape == (5, 12, 12, 2)
    assert (tds[0]["start"], tds[0]["end"]) == (int(4 / 31 * 4),
                                                int(20 / 31 * 4))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, True)])
def test_prefetch_loader_order_equals_jax(shuffle, drop_last):
    kw = dict(batch_size=3, collate_fn=list, shuffle=shuffle, num_workers=2,
              seed=5, drop_last=drop_last)
    tl, jl = TLD.PrefetchLoader(list(range(11)), **kw), JLD.PrefetchLoader(
        list(range(11)), **kw)
    assert len(tl) == len(jl)
    for _ in range(3):  # epochs shuffle from seed + epoch
        assert list(tl) == list(jl)


def test_prefetch_loader_stops_its_producer_on_an_early_break():
    started = threading.Event()

    def slow(i):
        started.set()
        time.sleep(0.01)
        return i

    class Slow(list):
        def __getitem__(self, i):
            return slow(super().__getitem__(i))

    before = set(threading.enumerate())
    loader = TLD.PrefetchLoader(Slow(range(200)), batch_size=2,
                                collate_fn=list, num_workers=2, prefetch=2)
    it = iter(loader)
    assert len(next(it)) == 2
    it.close()  # the consumer goes away mid-epoch
    deadline = time.time() + 15
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert started.is_set()
    assert not (set(threading.enumerate()) - before), "producer still alive"


def test_device_batch_strips_host_keys():
    batch = {"a": np.ones((2, 3), np.int32), "_text_answer": ["x", "y"],
             "b": np.zeros(2, np.float32)}
    out = TLD.device_batch(batch, "cpu")
    assert set(out) == {"a", "b"} == set(JLD.device_batch(batch))
    assert out["a"].dtype == torch.int32 and out["b"].dtype == torch.float32


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    b, l, c = 16, 9, 7
    sl, el = rng.standard_normal((2, b, l)).astype(np.float32)
    st = rng.integers(0, l, b).astype(np.int32)
    en = np.minimum(st + rng.integers(0, 4, b), l - 1).astype(np.int32)
    st[:2] = -100
    ts, js = TM.iou_init(), JM.iou_init()
    for _ in range(2):
        ts = TM.iou_update(ts, torch.from_numpy(sl), torch.from_numpy(el),
                           torch.from_numpy(st), torch.from_numpy(en))
        js = JM.iou_update(js, jnp.asarray(sl), jnp.asarray(el),
                           jnp.asarray(st), jnp.asarray(en))
    for k in ("correct_3", "correct_5", "total"):
        assert float(ts[k]) == float(js[k]), k
    close(ts["correct"], js["correct"])
    for got, want in zip(TM.iou_compute(ts), JM.iou_compute(js)):
        close(got, want)
    sp, ep = rng.integers(0, l, (2, 64)).astype(np.int32)
    close(TM.span_iou(*map(torch.from_numpy, (sp, ep, st[:1].repeat(64),
                                              en[:1].repeat(64)))),
          JM.span_iou(*map(jnp.asarray, (sp, ep, st[:1].repeat(64),
                                         en[:1].repeat(64)))))

    logits = rng.standard_normal((b, c)).astype(np.float32)
    target = rng.integers(0, c, b).astype(np.int32)
    target[3] = -100
    for topk in (1, 3):
        ta = TM.accuracy_update(TM.accuracy_init(), torch.from_numpy(logits),
                                torch.from_numpy(target), topk)
        ja = JM.accuracy_update(JM.accuracy_init(), jnp.asarray(logits),
                                jnp.asarray(target), topk)
        assert float(ta["correct"]) == float(ja["correct"])
        assert float(ta["total"]) == float(ja["total"])
        close(TM.accuracy_compute(ta), JM.accuracy_compute(ja))
    preds = rng.integers(0, c, b).astype(np.int32)
    ta = TM.accuracy_update(TM.accuracy_init(), torch.from_numpy(preds),
                            torch.from_numpy(target))
    ja = JM.accuracy_update(JM.accuracy_init(), jnp.asarray(preds),
                            jnp.asarray(target))
    assert float(ta["correct"]) == float(ja["correct"])

    tm, jm = TM.mean_init(), JM.mean_init()
    for v, w in zip(rng.standard_normal(5), rng.uniform(0.5, 2, 5)):
        tm = TM.mean_update(tm, torch.tensor(v, dtype=torch.float32), w)
        jm = JM.mean_update(jm, jnp.float32(v), w)
    close(TM.mean_compute(tm), JM.mean_compute(jm))

    words = ["a", "red", "car", "moves", "fast", "the", "dog"]
    preds = [" ".join(rng.choice(words, rng.integers(0, 6))) for _ in range(8)]
    golds = [" ".join(rng.choice(words, rng.integers(1, 6))) for _ in range(8)]
    assert TM.bleu1(preds, golds) == JM.bleu1(preds, golds)
    assert TM.rouge_n(golds, preds) == JM.rouge_n(golds, preds)

    spec = {"loss": "mean", "acc": "accuracy", "iou": "iou"}
    tb, jb = TM.MetricBag(spec), JM.MetricBag(spec)
    tb.states.update(loss=tm, acc=ta, iou=ts)
    jb.states.update(loss=jm, acc=ja, iou=js)
    got, want = tb.compute(), jb.compute()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL)


# --------------------------------------------------------------- checkpoint
PATHS = ["/r/run/checkpoints", "/r/run/checkpoints/", "/r/run/checkpoints/best",
         "/r/run/checkpoints/last/500", "/r/run/checkpoints/best/12/",
         "rel/checkpoints/last", "/r/7", "/r/best"]


@pytest.mark.parametrize("path", PATHS)
def test_resolve_ckpt_path_equals_jax(path):
    assert TCK.resolve_ckpt_path(path) == JCK.resolve_ckpt_path(path)


SEQUENCES = {
    # tests/test_resume.py::test_best_and_last_retention
    "retention": ([(1, 0.5), (2, None), (3, 0.9), (4, 0.2)], {}),
    "same_step_twice": ([(3, 0.5), (3, 0.7)], {"save_last": False}),
    "resume_better": ([(3, 0.5), (4, 0.7)], {"save_last": False}),
    "resume_worse": ([(3, 0.5), (4, 0.1)], {"save_last": False}),
    "lower_after": ([(5, 0.5), (3, 0.9)], {"max_to_keep": 2}),
    "top2": ([(1, 0.5), (2, 0.9), (3, 0.1), (4, 0.7)], {"max_to_keep": 2}),
    "min_mode": ([(1, 0.5), (2, 0.9), (3, 0.1)], {"mode": "min"}),
    "ties": ([(1, 0.5), (2, 0.5)], {}),
    "periodic_only": ([(1, None), (2, None)], {"save_last": False}),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_retention_equals_the_jax_manager(tmp_path, case):
    seq, kw = SEQUENCES[case]
    out = {}
    for name, mod, state in (
            ("port", TCK, {"params": {"w": torch.ones(2)}, "step": 0}),
            ("jax", JCK, {"params": {"w": jnp.ones(2)},
                          "step": jnp.asarray(0)})):
        mgr = mod.CheckpointManager(mod.CheckpointConfig(
            directory=str(tmp_path / name), monitor="val/score", **kw))
        for step, score in seq:
            mgr.save(step, state, None if score is None else
                     {"val/score": score, "val/loss": 1.0})
        mgr.wait()
        mgr.close()
        reopened = mod.CheckpointManager(mod.CheckpointConfig(
            directory=str(tmp_path / name), monitor="val/score", **kw))
        out[name] = (
            {p: sorted(os.listdir(tmp_path / name / p))
             for p in ("best", "last")},
            mgr.best_step(), mgr.latest_step(), reopened.best_step(),
            reopened.latest_step())
        reopened.close()
    assert out["port"] == out["jax"]


def test_params_only_restore_and_item_names(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    mgr = TCK.CheckpointManager(TCK.CheckpointConfig(directory=str(tmp_path)))
    mgr.save(3, {"params": model.state_dict(), "opt_state": opt.state_dict(),
                 "step": 3})
    assert mgr.item_names(3) == {"params", "opt_state", "step"}
    out = mgr.restore(3, items=["params"])
    assert set(out) == {"params"}
    fresh = torch.nn.Linear(3, 2)
    assert TCK.restore_into(out, fresh) is None
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    # a step directory appears only complete: no temporary is left behind
    assert sorted(os.listdir(tmp_path / "last")) == ["3"]


def test_opening_a_root_leaves_saves_in_flight_alone(tmp_path):
    """A reader (an eval, a resume from another run's root) neither writes
    nor sweeps: a live process's save in flight survives it, and so does a
    save by a second manager. Only a dead saver's temporary is swept."""
    missing = tmp_path / "typo"
    with pytest.raises(FileNotFoundError):
        TCK.CheckpointManager(TCK.CheckpointConfig(str(missing))).restore()
    assert not missing.exists()

    writer = TCK.CheckpointManager(TCK.CheckpointConfig(str(tmp_path)))
    writer.save(1, {"step": 1})
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    live = tmp_path / "last" / f".2.tmp-{os.getppid()}"
    gone = tmp_path / "last" / f".2.tmp-{dead.pid}"
    for tmp in (live, gone):
        tmp.mkdir()
        (tmp / "params.pt").write_bytes(b"partial")
    reader = TCK.CheckpointManager(TCK.CheckpointConfig(str(tmp_path)))
    assert reader.restore(items=["step"]) == {"step": 1}
    assert live.exists() and gone.exists()
    reader.save(3, {"step": 3})
    assert live.exists() and not gone.exists()
    assert sorted(os.listdir(tmp_path / "last")) == [live.name, "3"]


def _toy_model():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.randn(4, 3, generator=gen))
    model.b = torch.nn.Parameter(torch.zeros(3))
    return model


def _toy_loss(model, batch, generator):
    pred = batch["x"] @ model.w + model.b
    noise = torch.randn(pred.shape, generator=generator) * 0.01
    loss = torch.mean((pred + noise - batch["y"]) ** 2)
    return loss, {"loss": loss}


def _toy_batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((8, 4)).astype(np.float32),
             "y": rng.standard_normal((8, 3)).astype(np.float32)}
            for _ in range(n)]


def _torch_batches(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def test_kill_and_resume_through_fit_is_bit_identical(tmp_path):
    batches = _torch_batches(_toy_batches(10))
    tcfg = TrainerConfig(max_steps=10, lr=1e-2, eval_every=10_000,
                         checkpoint_every=5, log_every=100, seed=7)

    t1 = Trainer(tcfg, _toy_loss)
    s1 = t1.fit(t1.init_state(_toy_model()), iter(batches))
    assert s1.step == 10

    # run 5 steps (the periodic save at step 5 lands in last/), "die"
    mgr = TCK.CheckpointManager(TCK.CheckpointConfig(directory=str(tmp_path)))
    t2 = Trainer(dataclasses.replace(tcfg), _toy_loss)
    s2 = t2.init_state(_toy_model())
    t2.fit(s2, iter(batches[:5]), checkpoint_fn=lambda st, m: mgr.save(
        st.step, TCK.train_state_items(st), m))
    assert sorted(os.listdir(tmp_path / "last")) == ["5"]

    # a fresh process: restore everything, continue on batches[5:]
    t3 = Trainer(tcfg, _toy_loss)
    s3 = t3.init_state(_toy_model())
    s3.step = TCK.restore_into(TCK.CheckpointManager(TCK.CheckpointConfig(
        directory=str(tmp_path))).restore(), s3.model, s3.optimizer)
    assert s3.step == 5
    s3 = t3.fit(s3, iter(batches[5:]))
    assert s3.step == 10
    for name, p in s1.model.named_parameters():
        assert torch.equal(p, dict(s3.model.named_parameters())[name]), name


# ------------------------------------------------------------ fit's cadence
class _Record:
    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, tuple(sorted(metrics))))


def _on_the_mesh(trainer, state):
    """``state`` replicated on ``trainer``'s one-device mesh, where its step
    puts its outputs: the first step's inputs then match the later ones',
    and the step compiles once instead of twice."""
    rep = NamedSharding(trainer.mesh, PartitionSpec())
    return JTR.TrainState(*(jax.device_put(x, rep) for x in (
        state.params, state.opt_state, state.step)))


def _jax_trainer(cfg):
    def loss_fn(params, batch, key):
        pred = batch["x"] @ params["w"] + params["b"]
        noise = jax.random.normal(key, pred.shape) * 0.01
        loss = jnp.mean((pred + noise - batch["y"]) ** 2)
        return loss, {"loss": loss}

    return JTR.Trainer(JTR.TrainerConfig(**cfg, mesh=MeshConfig(dp=1)),
                       loss_fn)


CADENCES = {
    "log2_eval3_ckpt4": (dict(max_steps=10, log_every=2, eval_every=3,
                              checkpoint_every=4), 10, None),
    "early_stop": (dict(max_steps=12, log_every=1, eval_every=2,
                        checkpoint_every=0, early_stop_patience=2), 12,
                   [0.5, 0.6, 0.55, 0.54, 0.9]),
    "min_mode": (dict(max_steps=12, log_every=3, eval_every=2,
                      checkpoint_every=3, early_stop_patience=1,
                      monitor="val/loss", monitor_mode="min"), 12,
                 [0.5, 0.4, 0.45, 0.3]),
    "short_iterator": (dict(max_steps=8, log_every=2, eval_every=2,
                            checkpoint_every=3), 3, None),
}


@pytest.mark.parametrize("case", sorted(CADENCES))
def test_fit_cadence_equals_jax(case):
    cfg, n_batches, scores = CADENCES[case]
    cfg = dict(cfg, lr=1e-2, seed=7)
    batches = _toy_batches(n_batches)
    runs = {}
    for name in ("port", "jax"):
        rec, evals, saves = _Record(), [], []

        def eval_fn(state, evals=evals):
            step = int(state.step)
            evals.append(step)
            v = (scores or [0.1 * step])[min(len(evals), len(scores or [0]))
                                         - 1]
            key = cfg.get("monitor", "val/score")
            return {key: v}

        def ckpt_fn(state, metrics, saves=saves):
            saves.append((int(state.step), metrics is None))

        if name == "port":
            tr = Trainer(TrainerConfig(**cfg), _toy_loss)
            state = tr.init_state(_toy_model())
            feed = iter(_torch_batches(batches))
        else:
            tr = _jax_trainer(cfg)
            state = _on_the_mesh(tr, tr.init_state(
                {"w": jnp.zeros((4, 3)), "b": jnp.zeros((3,))}))
            feed = iter([{k: jnp.asarray(v) for k, v in b.items()}
                         for b in batches])
        tr.writers = rec
        state = tr.fit(state, feed, eval_fn=eval_fn, checkpoint_fn=ckpt_fn)
        runs[name] = (rec.logged, evals, saves, int(state.step))
    assert runs["port"] == runs["jax"]


def test_fit_returns_at_once_when_resumed_at_the_horizon():
    tr = Trainer(TrainerConfig(max_steps=4), _toy_loss)
    state = tr.init_state(_toy_model())
    state.step = 4
    called = []
    out = tr.fit(state, iter(_torch_batches(_toy_batches(2))),
                 eval_fn=lambda s: called.append(s) or {})
    assert out.step == 4 and not called


# --------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def pair():
    return Pair(seed=4)


def _tg_batches(pair, n, seed):
    ds = TD.SyntheticVideoQA(
        length=2 * n, num_frames=pair.tcfg.num_frames, max_flow_len=3,
        flow_len_range=(2, 4), image_size=pair.tcfg.blip2.vit.image_size,
        flow_size=pair.tcfg.tgb.flow_size, nframe=pair.tcfg.nframe, seed=seed)
    tok = t_tokenizer("byte")
    return [TD.collate_videoinstruct([ds[2 * i], ds[2 * i + 1]], tok, tok,
                                     max_flow_len=3, max_txt_len=5,
                                     nframe=pair.tcfg.nframe, answer_len=4)
            for i in range(n)]


def test_tiny_tg_fit_and_eval_match_jax(pair):
    """3 TG steps through both trainers' ``fit`` on the same synthetic
    batches from the same weights, dropout off: per-step losses and the
    trainable parameters at 2e-4, then ``evaluate_tg`` on a val split.
    Entries whose gradient is zero up to f32 rounding (|g| < 1e-6: biases
    that shift every logit or key of a row alike, or feed a LayerNorm)
    step by the sign of rounding noise in both packages, as in
    ``tests/test_torch_training.py``; they are held to moving at most the
    sum of the steps' learning rates."""
    train, val = _tg_batches(pair, 3, 0), _tg_batches(pair, 2, 1)
    kw = dict(max_steps=3, lr=5e-3, warmup_ratio=0.05, log_every=1,
              eval_every=10, seed=42)
    jrecipe, trecipe = JR.TGRecipe(), TR.TGRecipe()

    jtr = JTR.Trainer(JTR.TrainerConfig(**kw, mesh=MeshConfig(dp=1)),
                      lambda p, b, k: jrecipe.loss_fn(pair.jmodel, p, b, k,
                                                      deterministic=True),
                      filter_fn=jrecipe.filter_fn)
    jtr.writers = jrec = _Metrics()
    # the JAX step donates its inputs: hand it a copy of the fixture's
    params = jax.tree.map(lambda x: jnp.array(x, copy=True),
                          pair.params["params"])
    jstate = jtr.fit(_on_the_mesh(jtr, jtr.init_state(params)),
                     iter([JLD.device_batch(b) for b in train]))

    ttr = Trainer(TrainerConfig(**kw),
                  lambda m, b, g: trecipe.loss_fn(m, b, g, deterministic=True),
                  trecipe.filter_fn)
    ttr.writers = trec = _Metrics()
    tstate = ttr.init_state(pair.tmodel)
    before = {n: p.detach().clone()
              for n, p in pair.tmodel.named_parameters()}
    ttr.loss_fn(pair.tmodel, TLD.device_batch(train[0], "cpu"),
                None)[0].backward()
    noise_floor = {  # a parameter off the loss's path gets no gradient
        n: (torch.zeros_like(p) if p.grad is None else p.grad).abs() < 1e-6
        for n, p in pair.tmodel.named_parameters() if n in ttr.trainable}
    pair.tmodel.zero_grad(set_to_none=True)
    tstate = ttr.fit(tstate, iter([TLD.device_batch(b, "cpu") for b in train]))

    assert [s for s, _ in trec.rows] == [s for s, _ in jrec.rows] == [1, 2, 3]
    for (_, got), (_, want) in zip(trec.rows, jrec.rows):
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    want_p = flax_to_state_dict(jax.tree.map(np.array, jstate.params))
    got_p = dict(tstate.model.named_parameters())
    assert ttr.trainable and all(n.startswith("temporal_encoder")
                                 for n in ttr.trainable)
    budget = sum(r["lr"] for _, r in trec.rows) * 1.01 + 1e-7
    for name, p in got_p.items():
        if name not in ttr.trainable:
            assert torch.equal(p, before[name]), name
            continue
        real = ~noise_floor[name]
        close(p.detach()[real], want_p[name][real])
        assert bool(((p.detach() - before[name])[~real].abs()
                     <= budget).all()), name

    got = TT.evaluate_tg(tstate.model, trecipe, val)
    want = JT.evaluate_tg(pair.jmodel, jrecipe, jstate, val, None)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **TOL)


class _Metrics:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))


# ------------------------------------------------------- the CLIs, end to end
def _rows(out):
    with open(os.path.join(out, "csv", "metrics.csv")) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("experiment,keys", [
    ("smoke_tg_synthetic", ("val/loss", "val/iou_score", "val/iou_3",
                            "val/iou_5")),
    ("smoke_e2e_synthetic", ("val/loss", "val/score"))])
def test_train_then_evaluate_cli(tmp_path, monkeypatch, experiment, keys):
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "run")
    final = TT.main([f"experiment={experiment}", f"paths.root_dir={root}"]
                    + CPU)
    assert set(keys) <= set(final)
    try:
        runs = os.path.join(root, "logs", "train", "runs")
        (run_dir,) = [os.path.join(runs, d) for d in os.listdir(runs)]
        assert os.path.exists(os.path.join(run_dir, ".hydra", "config.yaml"))
        assert os.path.exists(os.path.join(run_dir, "train.log"))
        ckpt = os.path.join(run_dir, "checkpoints")
        assert os.listdir(os.path.join(ckpt, "best")) == ["2"]
        rows = _rows(run_dir)
        assert [r["step"] for r in rows if r["loss"]] == ["1", "2"]
        metrics = TE.main([f"experiment={experiment}",
                           f"paths.output_dir={run_dir}",
                           f"ckpt_path={ckpt}"] + CPU)
    finally:
        from videotgb_torch.utils.logging import remove_file_handler
        from videotgb_torch.utils.task import setup_run_dir

        remove_file_handler(setup_run_dir._handler)
    assert set(metrics) == {"test" + k[3:] for k in final}
    # the restored best step evaluates to the final eval of its run
    for k in keys:
        np.testing.assert_allclose(metrics["test" + k[3:]], final[k],
                                   rtol=1e-6)


@pytest.mark.parametrize("overrides,keys", [
    (["experiment=smoke_sf_synthetic"], ("val/score",)),
    (["experiment=smoke_sf_vicuna_synthetic"], ("val/score",)),
    (["experiment=smoke_e2e_it5_synthetic"], ("val/loss", "val/score")),
    (["model=LSTP_instructblip_e2e", "model.preset=tiny",
      "trainer.max_steps=2", "trainer.log_every=1"],
     ("val/loss", "val/score")),
])
def test_sf_and_instructblip_train_cli(tmp_path, overrides, keys):
    """The SF recipe (a pseudo-label pass before each step) and the
    InstructBLIP backbones through ``train.main`` at tiny size on the CPU:
    the JAX CLI's metric keys, SF without ``val/loss`` (a validation batch
    has no pseudo scores), the joint loss's parts logged per step; an SF
    checkpoint evaluates to ``test/score`` alone."""
    out = str(tmp_path / "out")
    final = TT.main(overrides + [f"paths.output_dir={out}"] + CPU)
    assert set(final) == set(keys)
    assert all(np.isfinite(v) for v in final.values())
    rows = [r for r in _rows(out) if r["loss"]]
    assert [r["step"] for r in rows] == ["1", "2"]
    sf = "sf" in overrides[0]
    if sf:
        for r in rows:
            np.testing.assert_allclose(
                float(r["loss"]), float(r["lm_loss"]) + float(r["mrc_loss"]),
                rtol=1e-6)
    if overrides[0] == "experiment=smoke_sf_synthetic":
        metrics = TE.main(overrides + [f"paths.output_dir={out}",
                                       f"ckpt_path={out}/checkpoints"] + CPU)
        assert set(metrics) == {"test/score"}
        np.testing.assert_allclose(metrics["test/score"], final["val/score"])


# stage 3 (IV, IVT) and LoRA through the CLI: the JAX CLI's runs of
# tests/test_entries.py:297-325 on a text_dir written with cv2
STAGE3_CLI = {
    "blip2_iv": ["experiment=LSTP_blip2flant5xl_ivinstruct"],
    # batch 1, 4 loader batches a step (the experiment's accumulation)
    "blip2_ivt": ["experiment=LSTP_blip2flant5xl_ivtinstruct"],
    "vicuna_iv": ["experiment=LSTP_instructblipvicuna7b_ivinstruct",
                  "data.batch_size=2", "trainer.accumulate_grad_batches=1"],
    "vicuna_ivt": ["experiment=LSTP_instructblipvicuna7b_ivtinstruct"],
    "e2e_lora": ["experiment=smoke_e2e_synthetic", "+model.lora_rank=8"],
}


@pytest.mark.parametrize("case", list(STAGE3_CLI))
def test_stage3_and_lora_train_cli(tmp_path, case):
    """``train.main`` of the four stage-3 experiments at tiny size on the
    CPU (image, video and text-only rows; IVT's text-only rows from
    nlp_tune.json), and E2E with frozen rank-8 adapters: finite metrics,
    a checkpoint of step 2 whose adapters moved under IVT only; the Vicuna
    IV checkpoint scored by the eval overlay to the run's val/score."""
    from _torch_port_helpers import write_stage3_media

    write_stage3_media(tmp_path / "data" / "ivinstruct")
    out = str(tmp_path / "out")
    args = STAGE3_CLI[case] + [
        f"paths.root_dir={tmp_path}", f"paths.output_dir={out}",
        "data.num_workers=0", "data.tokenizer=byte", "trainer.max_steps=2",
        "trainer.eval_every=10"] + CPU
    if case != "e2e_lora":
        args.append("model.preset=tiny")
    final = TT.main(args)
    assert {"val/loss", "val/score"} <= set(final)
    assert all(np.isfinite(v) for v in final.values())
    saved = TCK.CheckpointManager(TCK.CheckpointConfig(
        directory=f"{out}/checkpoints")).restore(items=["params", "step"])
    assert saved["step"] == 2
    params = saved["params"]
    lora_b = [v for k, v in params.items() if k.endswith("lora_b")]
    assert bool(lora_b) == (case.endswith("ivt") or case == "e2e_lora")
    # step 0 has lr 0; step 1 moves IVT's adapters, E2E's stay frozen at 0
    assert all(bool(v.any()) == case.endswith("ivt") for v in lora_b)
    if case == "vicuna_iv":
        metrics = TE.main([
            "experiment=eval_LSTP_instructblipvicuna7b_ivinstruct",
            "model.preset=tiny", "data.tokenizer=byte", "data.batch_size=2",
            "data.num_workers=0", f"paths.root_dir={tmp_path}",
            f"paths.output_dir={out}", f"ckpt_path={out}/checkpoints"] + CPU)
        assert set(metrics) == {"test/loss", "test/score"}
        assert metrics["test/score"] == final["val/score"]
        np.testing.assert_allclose(metrics["test/loss"], final["val/loss"],
                                   rtol=1e-6)


def test_cli_resume_takes_the_remaining_steps_on_the_schedule(tmp_path):
    out = str(tmp_path / "out")
    args = ["experiment=smoke_e2e_synthetic", f"paths.output_dir={out}",
            "model.selection=tgb"] + CPU
    TT.main(args)
    before = _rows(out)
    TT.main(args + [f"ckpt_path={out}/checkpoints", "trainer.max_steps=3"])
    new = _rows(out)[len(before):]
    train_rows = [r for r in new if r["loss"]]
    assert [r["step"] for r in train_rows] == ["3"]
    assert float(train_rows[0]["lr"]) == cosine_warmup_schedule(5e-5, 3,
                                                                0.05)(2)
    mgr = TCK.CheckpointManager(TCK.CheckpointConfig(directory=f"{out}/checkpoints"))
    assert mgr.latest_step() == 3
    opt = mgr.restore(3, items=["opt_state"])["opt_state"]
    assert {float(s["step"]) for s in opt["state"].values()} == {3.0}


def test_profiler_overlay_writes_a_trace(tmp_path):
    out = str(tmp_path / "out")
    TT.main(["experiment=smoke_tg_synthetic", "debug=profiler",
             f"paths.output_dir={out}"] + CPU)
    trace = os.path.join(out, "trace", "fit.pt.trace.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    # the experiment's trainer overlay lands after debug=profiler's, as in
    # the JAX compose: 2 steps
    assert [r["step"] for r in _rows(out) if r["loss"]] == ["1", "2"]


# ---------------------------------------------------------------- refusals
def test_without_trainer_cpu_the_cli_wants_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would take it")
    with pytest.raises(RuntimeError, match="trainer.platform=cpu"):
        TT.main(["experiment=smoke_tg_synthetic",
                 f"paths.output_dir={tmp_path}", "extras.print_config=false"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.main(["experiment=smoke_tg_synthetic", f"ckpt_path={tmp_path}",
                 f"paths.output_dir={tmp_path}", "extras.print_config=false"])


@pytest.mark.parametrize("overrides,match", [
    pytest.param(["experiment=smoke_tg_synthetic", "trainer.tp=2"],
                 "queue 1 item 7", id="overrides5-queue 1 item 7"),
    pytest.param(["experiment=smoke_tg_synthetic", "trainer=ddp_sim"],
                 "queue 1 item 7", id="overrides6-queue 1 item 7"),
    pytest.param(["experiment=smoke_tg_synthetic",
                  "+trainer.steps_per_dispatch=2"],
                 "queue 1 item 2", id="overrides7-queue 1 item 2"),
])
def test_unported_recipes_layouts_and_options_raise(tmp_path, overrides,
                                                    match):
    cpu = [] if "trainer=ddp_sim" in overrides else CPU  # ddp_sim is on cpu
    cfg = compose(TT.CONFIG_DIR, "train", overrides + cpu + [
        f"paths.output_dir={tmp_path}", "extras.print_config=false"])
    assert cfg.trainer.platform == "cpu"
    with pytest.raises(NotImplementedError, match=match):
        TT.train(cfg)


def test_sf_refuses_accumulated_micro_batches(tmp_path):
    """The SF pseudo-label pass scores one loader batch a step, so SF with
    ``accumulate_grad_batches`` > 1 raises before the model is built."""
    cfg = compose(TT.CONFIG_DIR, "train", [
        "experiment=smoke_sf_synthetic", "trainer.accumulate_grad_batches=2",
        f"paths.output_dir={tmp_path}"] + CPU)
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        TT.train(cfg)


def test_eval_cli_requires_ckpt_path():
    with pytest.raises(ValueError, match="ckpt_path"):
        TE.evaluate(compose(TT.CONFIG_DIR, "eval", CPU))
