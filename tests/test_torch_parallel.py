"""videotgb_torch's data-parallel and fully sharded training against
videotgb_tpu's ``parallel/`` and its trainer on a 2-device CPU mesh.

Pure parts: ``MeshConfig.resolve``, ``parse_mesh_spec`` (its errors
too), ``logical_to_mesh`` and ``process_chunk`` against the JAX functions;
the loader's rank rows against its world-1 batches; ``shard_batch``.

One 2-process gloo run (``tests/_torch_dist_worker.py``, at most
``TIMEOUT_S``, every process killed on expiry) holds tiny f32 TG and E2E
steps at dp=2 and at fsdp=2 against the JAX ``Trainer`` on a 2-device mesh
with the same global batch: a batch whose two rows hold 3 and 5 answer
tokens (a mean of the ranks' means is not the loss), the E2E "tgb"
selection on noise handed to both packages; loss and grad norm of both
steps and the trainable parameters after them at 2e-4 (the
tests/test_parity.py tolerance), ranks bit-identical, frozen parameters
untouched. The JAX references compile in
processes of their own while the ranks run. The same run checks the global
random draws against one process, a world-2 checkpoint restored at world 1 and the reverse; beside
it, ``python -m videotgb_torch.train ... trainer=ddp_sim trainer.dp=2``
against the world-1 run's logged losses.
"""

from __future__ import annotations

import csv
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from jax.sharding import PartitionSpec

from _torch_port_helpers import B, L_FLOW, TOL, Pair, few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from _torch_port_helpers import (handed_gumbel, jax_two_steps,
                                 unequal_answer_batch)
from videotgb_torch.convert import flax_to_state_dict
from videotgb_torch.data.loader import PrefetchLoader
from videotgb_torch.models import videotgb as TV
from videotgb_torch.parallel import distributed as TDI
from videotgb_torch.parallel import mesh as TM
from videotgb_torch.parallel import sharding as TS
from videotgb_torch.training import checkpoint as TCK
from videotgb_torch.training import recipes as TR
from videotgb_torch.training.optim import make_optimizer
from videotgb_torch.training.trainer import Trainer, TrainerConfig
from videotgb_tpu.parallel import distributed as JDI
from videotgb_tpu.parallel import mesh as JM
from videotgb_tpu.parallel import sharding as JS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
TIMEOUT_S = 120
SEED = 3
CASES = ("tg", "e2e_tgb")
KW = dict(max_steps=10, lr=1e-3, weight_decay=0.01, warmup_ratio=0.05)
SMOKE = ["experiment=smoke_tg_synthetic", "trainer.log_every=1",
         "data.num_workers=1", "extras.print_config=false"]


# ------------------------------------------------------------ pure parts
@pytest.mark.parametrize("axes,n", [
    ({}, 8), ({"dp": 2, "fsdp": -1}, 8), ({"dp": -1, "fsdp": 4}, 8),
    ({"dp": 3}, 8), ({"dp": -1, "fsdp": 3}, 8), ({"dp": -1, "tp": -1}, 4),
    ({"dp": 2, "fsdp": 2}, 4), ({"dp": 1}, 1)])
def test_mesh_config_resolve_matches_jax(axes, n):
    def outcome(cls):
        try:
            return cls(**axes).resolve(n)
        except ValueError as e:
            return str(e)

    assert outcome(TM.MeshConfig) == outcome(JM.MeshConfig)


@pytest.mark.parametrize("spec,allow_pp", [
    ("dp=2,tp=4", True), ("fsdp=4", True), (" dp = 2 , ", True),
    ("pp=2", True), ("pp=2", False), ("ps=2", True), ("dp", True),
    ("dp=two", True), ("", True)])
def test_parse_mesh_spec_matches_jax(spec, allow_pp):
    def outcome(fn):
        try:
            return fn(spec, allow_pp=allow_pp)
        except ValueError as e:
            return str(e)

    got, want = (outcome(TM.parse_mesh_spec), outcome(JM.parse_mesh_spec))
    if isinstance(want, str):
        assert got == want
    else:
        assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("spec", [
    ("batch", None), ("embed", "mlp"), (("batch", "seq"), "heads"),
    ("layers", "embed", "vocab"), (("kv", "conv_in"),), ("unknown",)])
def test_logical_to_mesh_matches_jax(spec):
    assert TS.logical_to_mesh(spec) == tuple(
        JS.logical_to_mesh(PartitionSpec(*spec)))


@pytest.mark.parametrize("n_items,count", [(10, 3), (7, 7), (3, 4), (0, 2)])
def test_process_chunk_matches_jax(n_items, count):
    items = list(range(n_items))
    for index in range(count):
        assert TDI.process_chunk(items, index, count) == \
            JDI.process_chunk(items, index, count)
    assert TDI.process_chunk(items) == items  # one process: everything


def test_unported_axes_raise_naming_their_items():
    """Training refuses ``tp`` (item 4), ``sp`` beside ``fsdp`` (item 4)
    and ``pp`` beside ``fsdp`` (item 12); ``sp`` and ``pp`` alone pass the
    refusals, and lay out their ranks after ``tp``, ``sp`` innermost."""
    for axes, item in ((dict(tp=2), "item 4"), (dict(fsdp=2, pp=2), "item 12"),
                       (dict(fsdp=2, sp=2), "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            TM.create_mesh(TM.MeshConfig(**axes))
    TM.check_ported(TM.MeshConfig(dp=2, sp=2))
    TM.check_ported(TM.MeshConfig(dp=2, pp=2))
    assert TM.mesh_layout(TM.MeshConfig(dp=2, sp=2), 4).tolist() == [
        [[[[0, 1]]]], [[[[2, 3]]]]]
    assert TM.mesh_layout(TM.MeshConfig(dp=2, pp=2), 4).tolist() == [
        [[[[0], [1]]]], [[[[2], [3]]]]]
    assert TM.create_mesh(TM.MeshConfig()) is None  # one process, no group
    with pytest.raises(ValueError, match="device count"):
        TM.create_mesh(TM.MeshConfig(dp=2))


class _Rows:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("world", [2, 4])
def test_loader_rank_rows_concatenate_to_the_world1_batches(world):
    """Every step of two epochs: the ranks' rows, in rank order, are the
    world-1 batch; the length is the same on every rank."""
    def batches(rank, size):
        loader = PrefetchLoader(_Rows(), batch_size=4, collate_fn=list,
                                num_workers=1, seed=3, rank=rank, world=size)
        return [list(loader) for _ in range(2)], len(loader)

    want, n = batches(0, 1)
    ranks = [batches(r, world) for r in range(world)]
    assert {length for _, length in ranks} == {n}
    for epoch in range(2):
        for step in range(n):
            assert [row for epochs, _ in ranks
                    for row in epochs[epoch][step]] == want[epoch][step]
    with pytest.raises(ValueError, match="split"):
        PrefetchLoader(_Rows(), batch_size=3, collate_fn=list, world=2)


class _Mesh:
    """The coordinate interface of a (dp, fsdp) DeviceMesh."""

    def __init__(self, coord, shape):
        self.coord, self.shape = coord, shape

    def get_coordinate(self):
        return self.coord

    def size(self, dim=None):
        return self.shape[dim] if dim is not None else int(np.prod(self.shape))


def test_shard_batch_takes_the_jax_placement():
    """Rank (i, j) of a dp 2 x fsdp 2 mesh holds rows 2i + j of axis 0 (or
    1, a steps-per-dispatch window); a leaf whose axis does not divide
    goes whole to every rank."""
    x = torch.arange(24).reshape(8, 3)
    window = np.arange(40).reshape(2, 4, 5)
    for i in range(2):
        for j in range(2):
            mesh = _Mesh((i, j), (2, 2))
            r = 2 * i + j
            got = TS.shard_batch({"x": x, "odd": torch.ones(3), "s": 1.0},
                                 mesh)
            assert torch.equal(got["x"], x[2 * r:2 * r + 2])
            assert got["odd"].shape == (3,) and got["s"] == 1.0
            got = TS.shard_batch({"w": window}, mesh, axis=1)
            np.testing.assert_array_equal(got["w"], window[:, r:r + 1])


# ----------------------------------------------- the two-process gloo run
@pytest.fixture(scope="module")
def pair():
    return Pair(seed=SEED)


def global_batch(pair):
    return unequal_answer_batch(pair.jcfg, pair.inputs)


def noise_floor(pair, case, batch, noise):
    """Entries whose gradient at the start is zero up to f32 rounding
    (|g| < 1e-6) step by the sign of rounding noise in both packages
    (tests/test_torch_training.py); step 0 has lr 0, so step 1's gradient
    is this one."""
    model = TV.VideoTGB(pair.tcfg, device="cpu")
    model.load_state_dict(pair.tmodel.state_dict())
    recipe = (TR.TGRecipe() if case == "tg" else
              TR.E2ERecipe(selection="tgb"))
    kwargs = {"noise": noise} if case == "e2e_tgb" else {}
    _, names = make_optimizer(model, filter_fn=recipe.filter_fn)
    loss, _ = recipe.loss_fn(model, batch, None, deterministic=True, **kwargs)
    loss.backward()
    params = dict(model.named_parameters())
    return {n: (params[n].grad if params[n].grad is not None
                else torch.zeros_like(params[n])).abs() < 1e-6
            for n in names}


def world1_checkpoint(pair, root, batch, noise):
    """A world-1 E2E train state after one step, saved under ``root``."""
    model = TV.VideoTGB(pair.tcfg, device="cpu")
    model.load_state_dict(pair.tmodel.state_dict())
    recipe = TR.E2ERecipe(selection="tgb")
    trainer = Trainer(TrainerConfig(**KW), lambda m, b, g: recipe.loss_fn(
        m, b, g, deterministic=True, noise=noise), recipe.filter_fn)
    state = trainer.init_state(model)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    items = TCK.train_state_items(state)
    TCK.CheckpointManager(TCK.CheckpointConfig(directory=root)).save(
        state.step, items)
    return items


def csv_rows(path):
    with open(os.path.join(path, "csv", "metrics.csv")) as f:
        return [r for r in csv.DictReader(f) if r["loss"]]


@pytest.fixture(scope="module")
def gloo_run(request, tmp_path_factory):
    """Starts the ``ddp_sim`` CLI, its world-1 run and TG's JAX reference
    (which builds the seed's weights and batch itself), then the two ranks,
    computes E2E's JAX reference and the world-1 references meanwhile, and
    waits for them all at most TIMEOUT_S."""
    d = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "videotgb_torch.train", *SMOKE, *layout,
         f"paths.output_dir={d / name}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
        for name, layout in (("ddp", ["trainer=ddp_sim", "trainer.dp=2"]),
                             ("w1cli", ["trainer=cpu"]))]
    procs.append(subprocess.Popen(  # TG's JAX reference compiles meanwhile
        [sys.executable, WORKER, "--jax", "tg", str(SEED), json.dumps(KW),
         str(d / "jax_tg.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        return _gloo_run(request.getfixturevalue("pair"), d, env, procs,
                         deadline)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _gloo_run(pair, d, env, procs, deadline):
    batch_np = global_batch(pair)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}
    noise = torch.from_numpy(handed_gumbel(pair.jcfg))
    w1_items = world1_checkpoint(pair, str(d / "w1"), batch, noise)
    torch.save({"cfg": pair.tcfg, "state": pair.tmodel.state_dict(),
                "batch": batch, "noise": noise, "trainer": KW,
                "ckpt_in": str(d / "w1"), "ckpt_out": str(d / "w2")},
               d / "in.pt")
    port = TDI.free_port()
    procs += [subprocess.Popen(
        [sys.executable, WORKER, str(d / "in.pt"), str(d / "out.pt")],
        env=dict(env, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
        for r in range(2)]
    refs = {"e2e_tgb": jax_two_steps(pair.jmodel, pair.params["params"],
                                     "e2e_tgb", batch_np, noise.numpy(), KW)}
    floors = {case: noise_floor(pair, case, batch, noise) for case in CASES}
    outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
            for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode()[-3000:]
    with open(d / "jax_tg.pkl", "rb") as f:
        refs.update(pickle.load(f))
    refs = {case: (steps, flax_to_state_dict(unflatten_dict(params)))
            for case, (steps, params) in refs.items()}
    return {"out": torch.load(d / "out.pt", weights_only=False),
            "refs": refs, "floors": floors, "w1_items": w1_items,
            "w2": str(d / "w2"), "ddp": csv_rows(str(d / "ddp")),
            "w1cli": csv_rows(str(d / "w1cli")), "start": pair.tmodel}


@pytest.mark.parametrize("layout", ["dp", "fsdp"])
@pytest.mark.parametrize("case", ["tg", "e2e_tgb"])
def test_two_steps_at_world2_match_the_jax_trainer(gloo_run, layout, case):
    """Loss and grad norm of both steps at 2e-4; trainable parameters at
    atol 1e-5 / rtol 2e-4 (1% of an Adam step), the noise-floor entries
    held to one step; every rank's trainable parameters bit-identical;
    frozen ones untouched. The E2E batch's rows hold 3 and 5 answer
    tokens, so the ranks' mean of means is off by ten times the
    tolerance (the next test)."""
    got = gloo_run["out"][layout, case]
    want_steps, want_params = gloo_run["refs"][case]
    assert got["route"] == layout
    for g, w in zip(got["steps"], want_steps):
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], **TOL)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    start = dict(gloo_run["start"].named_parameters())
    floor = gloo_run["floors"][case]
    assert got["trainable"].keys() == floor.keys()
    for name, p in got["trainable"].items():
        real = ~floor[name]
        np.testing.assert_allclose(p[real].numpy(),
                                   want_params[name][real].numpy(),
                                   atol=1e-5, rtol=2e-4, err_msg=name)
        step = (p - start[name].detach())[~real].abs()
        assert bool((step <= KW["lr"] * 1.01 + 1e-7).all()), name
    assert got["ranks_identical"] and got["frozen_unchanged"]


def test_the_unequal_token_batch_defeats_a_mean_of_means(pair):
    """The batch of the world-2 steps: each row's own mean CE, averaged,
    is not the loss of the global batch (what the ranks would log
    without ``global_count``)."""
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in global_batch(pair).items()}
    model, noise = pair.tmodel, torch.zeros((pair.jcfg.top_k, 2, B, L_FLOW))
    recipe = TR.E2ERecipe(selection="tgb")
    with torch.no_grad():
        whole = recipe.loss_fn(model, batch, None, True, noise=noise)[0]
        rows = [recipe.loss_fn(model, {k: v[i:i + 1] for k, v in
                                       batch.items()}, None, True,
                               noise=noise[:, :, i:i + 1])[0]
                for i in range(B)]
    # off by ten times the tolerance of the world-2 steps
    assert abs(float(sum(rows) / B) - float(whole)) > \
        10 * TOL["rtol"] * float(whole)


def test_random_draws_at_world2_are_the_global_batchs(gloo_run):
    """Dropout on and the selection's own noise: a world-2 loss (summed
    over the ranks) and the frames selected equal one process's on the
    global batch from the same generator."""
    draws = gloo_run["out"]["draws"]
    for case in ("tg", "e2e_tgb"):
        np.testing.assert_allclose(draws[case]["world2"],
                                   draws[case]["world1"], rtol=1e-5)
    assert torch.equal(draws["cand"]["world2"], draws["cand"]["world1"])


def test_evals_of_a_sharded_model_are_the_world1_evals(gloo_run):
    """``evaluate_tg`` and ``evaluate_generative`` (the tgb selection's own
    noise, decodes stopping together on both ranks) at fsdp=2, each rank
    on its row: every rank gets one process's metrics."""
    for name, ev in gloo_run["out"]["evals"].items():
        got, want = ev["world2"], ev["world1"]
        assert got.keys() == want.keys() and got, name
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{name} {k}")


def test_a_world2_checkpoint_resumes_at_world1_and_the_reverse(gloo_run,
                                                               pair):
    """The world-2 FSDP save is the single-device format: a world-1 model
    and optimizer restore it with the trained parameters and Adam moments
    the ranks held; a world-1 save restores into the FSDP model."""
    out = gloo_run["out"]
    trained = out["fsdp", "e2e_tgb"]["trainable"]
    model = TV.VideoTGB(pair.tcfg, device="cpu")
    recipe = TR.E2ERecipe(selection="tgb")
    trainer = Trainer(TrainerConfig(**KW), recipe.loss_fn, recipe.filter_fn)
    state = trainer.init_state(model)
    mgr = TCK.CheckpointManager(TCK.CheckpointConfig(directory=gloo_run["w2"]))
    assert TCK.restore_into(mgr.restore(), model, state.optimizer) == 2
    params = dict(model.named_parameters())
    for name, p in trained.items():
        assert torch.equal(params[name].detach(), p), name
    saved = out["saved_moments"]["state"]
    for i, name in enumerate(trainer.trainable):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[params[name]][key],
                               saved[i][key]), (name, key)
    restored = out["restored"]
    w1 = gloo_run["w1_items"]
    assert restored["step"] == w1["step"] == 2
    for name, p in restored["params"].items():
        assert torch.equal(p, w1["params"][name]), name
    for i, name in enumerate(trainer.trainable):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(restored["moments"][name][key],
                               w1["opt_state"]["state"][i][key]), (name, key)


def test_ddp_sim_cli_trains_two_ranks_with_the_world1_losses(gloo_run):
    """``python -m videotgb_torch.train ... trainer=ddp_sim trainer.dp=2``
    spawns 2 gloo ranks and logs the world-1 run's losses (the tiny
    preset's bf16 parameters: gradient sums in another order round
    differently, hence the grad norm's 1e-3)."""
    ddp, w1 = gloo_run["ddp"], gloo_run["w1cli"]
    assert [r["step"] for r in ddp] == [r["step"] for r in w1] == ["1", "2"]
    for a, b in zip(ddp, w1):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), **TOL)
        np.testing.assert_allclose(float(a["grad_norm"]),
                                   float(b["grad_norm"]), rtol=1e-3)
