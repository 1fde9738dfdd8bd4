"""videotgb_torch's pipeline parallelism (``parallel/pipeline.py``, the
``pp`` axis of training) against videotgb_tpu's ``parallel/pipeline.py``
and its pipelined towers, tiny f32, every tower 4 layers a stack so that a
stage holds 2.

Pure parts: the ``("dp", "fsdp", "tp", "pp", "sp")`` rank layout against
JAX's ``create_mesh``; each stage's layers against ``place_pipeline_params``'
shards on the 8-device CPU mesh; the layouts that still raise.

One 4-process gloo run at ``dp=2, pp=2`` (``tests/_torch_pp_worker.py``,
at most ``TIMEOUT_S``, every process killed on expiry): the MLP stack
through ``pipeline_apply`` at M = 2 and 4 and the LLaMA and T5 towers
against the JAX pipeline on its dp=2 x pp=2 mesh; two E2E steps and two
IV steps of InstructBLIP-Vicuna against the JAX trainer at world 1, leaf
by leaf, and each E2E step's gradients against the port's at world 1; an
eval, checkpoints across world sizes and ``train.main ... trainer.pp=2``
against the port's world-1 CLI. The references
run while the ranks run, among them JAX's ``nn.remat`` towers, which the
same test holds the port's ``remat`` towers against. One test, because
under ``--dist load`` every xdist worker that takes a test of a
module-scoped multi-process fixture starts it again.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_port_helpers import TOL, few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.parallel import distributed as TDI
from videotgb_torch.parallel import mesh as TM
from videotgb_torch.parallel.pipeline import PPGroup, place_pipeline_params
from videotgb_tpu.parallel import mesh as JM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_pp_worker.py")
TIMEOUT_S = 150
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)  # tests/test_pipeline_parallel.py's


# ------------------------------------------------------------ pure parts
@pytest.mark.parametrize("axes", [dict(dp=2, pp=2), dict(dp=1, pp=4),
                                  dict(dp=2, pp=2, sp=1)])
def test_mesh_layout_with_pp_is_the_jax_mesh(axes):
    """The ranks of the port's 5-D mesh sit where JAX's ``create_mesh``
    puts the devices: the pp ranks of one dp position are consecutive."""
    import jax

    want = JM.create_mesh(JM.MeshConfig(**axes), jax.devices()[:4]).devices
    got = TM.mesh_layout(TM.MeshConfig(**axes), 4)
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want))
    assert TM.AXIS_NAMES == JM.AXIS_NAMES


@pytest.mark.parametrize("pp", [2, 4])
def test_each_stage_holds_the_jax_placements_layers(pp):
    """Stage s's layers are the rows of the stacked layer axis that JAX's
    ``place_pipeline_params`` puts on the devices of pp index s of the
    8-device CPU mesh; the others' tensors are freed on that rank; a stack
    that does not divide raises JAX's message."""
    import jax.numpy as jnp

    from videotgb_tpu.parallel.pipeline import (pipeline_apply as jax_apply,
                                                place_pipeline_params as
                                                jax_place)

    mesh = JM.create_mesh(JM.MeshConfig(dp=8 // pp, pp=pp))
    stacked = jax_place({"w": jnp.arange(8.0)}, mesh)["w"]
    coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
    for shard in stacked.addressable_shards:
        stage = coords[shard.device.id][3]
        layers = torch.nn.ModuleList(torch.nn.Linear(2, 2) for _ in range(8))
        mine = place_pipeline_params(layers, PPGroup(stage, pp, None))
        assert list(mine) == np.asarray(shard.data).astype(int).tolist()
        assert [layers[i].weight.numel() > 0 for i in range(8)] == [
            i in mine for i in range(8)]
        assert all(p.pp_stage == i // (8 // pp) and p.pp_held == (i in mine)
                   for i in range(8) for p in layers[i].parameters())
    odd = torch.nn.ModuleList(torch.nn.Linear(2, 2) for _ in range(6))
    with pytest.raises(ValueError, match="6 layers not divisible by pp=4"):
        place_pipeline_params(odd, PPGroup(0, 4, None))
    with pytest.raises(ValueError, match="6 layers not divisible by pp=4"):
        jax_apply(lambda p, h: h, {"w": jnp.zeros((6, 2))}, jnp.zeros((4, 2)),
                  JM.create_mesh(JM.MeshConfig(dp=2, pp=4)))


def test_pp_layouts_that_still_raise_name_their_items():
    """``pp`` trains, alone and beside ``dp``; beside ``tp``, ``fsdp`` or
    ``sp`` it raises naming ROADMAP.md items 11-13, and serving refuses it
    (``parse_mesh_spec(allow_pp=False)`` as the JAX function does)."""
    TM.check_ported(TM.MeshConfig(dp=2, pp=2))
    for axes, item in ((dict(tp=2), "item 11"), (dict(fsdp=2), "item 12"),
                       (dict(sp=2), "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            TM.check_ported(TM.MeshConfig(dp=1, pp=2, **axes))
    with pytest.raises(NotImplementedError, match="trains only"):
        TM.create_mesh(TM.MeshConfig(dp=1, pp=2), serving=True)
    for parse in (TM.parse_mesh_spec, JM.parse_mesh_spec):
        with pytest.raises(ValueError, match="only available in the trainer"):
            parse("dp=2,pp=2", allow_pp=False)
    assert TM.parse_mesh_spec("dp=2,pp=2") == TM.MeshConfig(dp=2, pp=2)
    with pytest.raises(ValueError, match="device count"):
        TM.create_mesh(TM.MeshConfig(dp=1, pp=2))  # past the refusals


def _tower_grads(model, kind, batch):
    model.requires_grad_(True)
    if kind == "llama":
        logits, _ = model(input_ids=batch["ids"],
                          attention_mask=batch["mask"])
    else:
        hidden = model.encode(model.embed(batch["enc_ids"]),
                              batch["enc_mask"])
        logits, _ = model.decode(batch["dec_ids"], hidden, batch["enc_mask"])
    loss = logits.square().mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


# --------------------------------------------------- the four-process run
@pytest.fixture(scope="module")
def pp_inputs():
    from _torch_pp_worker import pp_inputs as make

    return make()


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory, pp_inputs):
    """Writes the inputs, starts the four ranks and the three reference
    processes (``--jax e2e``, ``--jax iv``, ``--cli``), writes the JAX
    weights they wait for and computes the JAX pipelines here meanwhile,
    and waits for them all at most TIMEOUT_S."""
    from _torch_pp_worker import pipeline_references, write_weights
    from videotgb_torch.convert import flax_to_state_dict

    d = tmp_path_factory.mktemp("pp")
    ckpt = d / "ckpt"
    ckpt.mkdir()
    towers = pp_inputs["towers"]
    with open(d / "pp_in.pkl", "wb") as f:  # what the ranks read: no JAX
        pickle.dump({k: v for k, v in pp_inputs.items()
                     if k not in ("jax_cfg", "jax_iv_cfg")} | {
            "towers": {k: {n: t[n] for n in ("cfg", "state", "batch")}
                       for k, t in towers.items()}}, f)
    with open(d / "jax_in.pkl", "wb") as f:
        pickle.dump({k: pp_inputs[k] for k in (
            "jax_cfg", "jax_iv_cfg", "e2e_batch", "iv_batch", "noise")}, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = TDI.free_port()
    cmds = [([str(d / "pp_in.pkl"), str(ckpt), str(d / "out.pt")],
             dict(RANK=str(r), WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=str(port))) for r in range(4)]
    cmds += [(["--jax", case, str(d / "jax_in.pkl"), str(ckpt),
               str(d / f"{case}.pkl")], {}) for case in ("e2e", "iv")]
    cmds += [(["--cli", str(d / "pp_in.pkl"), str(d / "w1"),
               str(d / "cli.pkl")], {})]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, *args], env=dict(env, **extra), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for args, extra in cmds]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        write_weights(pp_inputs, str(ckpt))
        ref = pipeline_references(pp_inputs)
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode()[-3000:]
    for name in ("e2e", "iv", "cli"):
        with open(d / f"{name}.pkl", "rb") as f:
            ref[name] = pickle.load(f)
    for case in ("e2e", "iv"):
        steps, params = ref.pop(case)
        ref[case, "jax"] = (steps, {k: v.numpy() for k, v in
                                    flax_to_state_dict(params).items()})
    ref["train_cli"] = ref.pop("cli")
    return {"ranks": torch.load(d / "out.pt", weights_only=False),
            "ref": ref}


def _check_remat(pp_inputs, kind, want):
    from _torch_pp_worker import tower_of

    batch = {k: torch.from_numpy(v) for k, v in pp_inputs["towers"][kind][
        "batch"].items()}
    got = {}
    for remat in (False, True):
        model = tower_of(pp_inputs, kind, False)
        model.config = dataclasses.replace(model.config, remat=remat)
        got[remat] = _tower_grads(model, kind, batch)
    assert got[True][0] == got[False][0], kind
    np.testing.assert_allclose(got[True][0], want["loss"], rtol=2e-4)
    assert got[True][1].keys() == want["grads"].keys()
    for name, g in got[True][1].items():
        assert torch.equal(g, got[False][1][name]), (kind, name)
        np.testing.assert_allclose(g.numpy(), want["grads"][name],
                                   err_msg=(kind, name), **TOL)


def _by_coord(ranks):
    return {r["coord"]: r for r in ranks}


def _floor(grads):
    """Entries whose first-step gradient is zero up to f32 rounding step
    by the sign of rounding noise (``tests/test_torch_parallel.py``)."""
    return {n: (g if g is not None else torch.zeros(1)).abs() < 1e-6
            for n, g in grads.items()}


def test_pipeline_parallel_runs_match_the_jax_pipeline_and_world_1(
        pp_run, pp_inputs):
    """The four ranks' work (one test: under ``--dist load`` every worker
    that takes a test of the run would start its processes).

    * The MLP stack at M = 2 and 4: the output, the input's gradient and
      every layer's gradient within 1e-5 of the JAX ``pipeline_apply``'s
      on its dp=2 x pp=2 mesh; each rank held only its stage's layers.
    * The staged LLaMA (with ``remat``) and T5 towers through the
      ``Trainer``'s pp route: the logits within 2e-4 and every gradient
      the update reads within JAX's 2e-3 / 2e-5 of the JAX towers
      pipelined on its dp=2 x pp=2 mesh; each rank holds, and its
      optimizer and Adam moments cover, only its stage's layers and the
      replicated parameters; the route is "pp", eager, and the stacks
      took the staged route (2 microbatches of 2 rows); LLaMA on 3 rows
      (one microbatch through the stages, where JAX goes sequential) gives
      the JAX logits of those rows.
    * A T5 checkpoint of the pp run resumed at world 1, and a world-1
      checkpoint resumed at pp: one more step on each equals the other
      world's second step (loss and every parameter at 2e-4).
    * Two E2E ("tgb") and two IV steps of InstructBLIP-Vicuna at pp:
      losses and grad norms within 2e-4 of the JAX trainer's at world 1,
      the trained tensors leaf by leaf at atol 1e-5 / rtol 2e-4
      (noise-floor entries within one Adam step); each E2E step's every
      gradient within 2e-4 of the port's at world 1; the trainable
      tensors equal on every rank.
    * The staged E2E model's eval (its stages gathered) equals world 1's.
    * ``train.main ... trainer.dp=2 trainer.pp=2`` (no ``scan_layers``
      tower: the pp ranks hold the whole model) gives the world-1 CLI's
      final metrics within 2e-4.
    * Here, at world 1: a ``remat=True`` LLaMA and T5 (each block
      recomputed in the backward) give the plain tower's loss and
      gradients exactly, and JAX's ``scan_layers`` + ``nn.remat`` tower's
      (computed beside the ranks) at 2e-4."""
    ranks, ref = pp_run["ranks"], pp_run["ref"]
    for kind in ("llama", "t5"):
        _check_remat(pp_inputs, kind, ref["remat"][kind])
    by = _by_coord(ranks)
    assert set(by) == {(0, 0), (0, 1), (1, 0), (1, 1)}

    for m in (2, 4):
        want = ref["mlp"][m]
        y = torch.cat([by[dp, 0]["mlp"][m]["y"] for dp in (0, 1)]).numpy()
        dx = torch.cat([by[dp, 0]["mlp"][m]["dx"] for dp in (0, 1)]).numpy()
        np.testing.assert_allclose(y, want["y"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dx, want["dx"], atol=1e-5, rtol=1e-5)
        for (dp, stage), r in by.items():
            grads = r["mlp"][m]["grads"]
            assert sorted({i for i, _ in grads}) == list(range(
                4 * stage, 4 * stage + 4))
            for (i, name), g in grads.items():
                np.testing.assert_allclose(g.numpy(), want[name][i],
                                           atol=1e-5, rtol=1e-4)

    for kind in ("llama", "t5"):
        want = ref[kind]
        logits = torch.cat([by[dp, 0][kind]["logits"] for dp in (0, 1)])
        np.testing.assert_allclose(logits.numpy(), want["logits"],
                                   rtol=2e-4, atol=2e-4, err_msg=kind)
        seen = set()
        for (dp, stage), r in by.items():
            rec = r[kind]
            assert rec["route"] == "pp" and "staged over pp" in rec[
                "step_route"], kind
            assert rec["calls"] == ({"staged": 1, "staged, one microbatch": 1}
                                    if kind == "llama" else {"staged": 2}), (
                kind, rec["calls"])
            for name, g in rec["grads"].items():
                np.testing.assert_allclose(g.numpy(), want["grads"][name],
                                           err_msg=(kind, name), **GRAD_TOL)
                seen.add(name)
            stacks = ("layers",) if kind == "llama" else ("encoder_blocks",
                                                          "decoder_blocks")
            mine = {f"{s}.{i}." for s in stacks
                    for i in (2 * stage, 2 * stage + 1)}
            staged = [n for n in want["grads"] if n.split(".")[0] in stacks]
            held = [n for n in staged if any(n.startswith(p) for p in mine)]
            replicated = [n for n in want["grads"] if n not in staged]
            assert sorted(rec["held"]) == sorted(held + replicated), kind
            assert sorted(rec["optimizer_names"]) == sorted(
                held + replicated), kind
            sizes = {n: int(np.prod(want["grads"][n].shape))
                     for n in want["grads"]}
            assert rec["moments"] == 2 * sum(sizes[n] for n in held
                                             + replicated), kind
        assert seen == set(want["grads"]), kind
    for dp in (0, 1):  # one microbatch: 3 rows at lr 0's unchanged weights
        np.testing.assert_allclose(by[dp, 0]["llama"]["odd"].numpy(),
                                   ref["llama"]["logits"][4 * dp:4 * dp + 3],
                                   rtol=2e-4, atol=2e-4)

    resume = by[0, 0]["resume"]
    second = by[0, 0]["t5"]["second"]
    for got, want in ((resume["pp_at_world1"], second),
                      (resume["world1_at_pp"], resume["world1"])):
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        assert got["params"].keys() == want["params"].keys()
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name]
                                       .numpy(), err_msg=name, **TOL)

    steps = by[0, 0]["steps"]
    for case in ("e2e", "iv"):
        got = steps[case, "pp"]
        assert got["route"] == "pp" and set(got["calls"]) == {
            "staged"}, case
        assert all(r["steps"][case, "pp"]["trained"].keys()
                   == got["trained"].keys() for r in ranks)
        for r in ranks:
            for name, p in r["steps"][case, "pp"]["trained"].items():
                assert torch.equal(p, got["trained"][name]), (case, name)
    for case in ("iv", "e2e"):
        want_steps, want_params = ref[case, "jax"]
        got = steps[case, "pp"]
        for g, w in zip(got["steps"], want_steps):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g["metrics"][k], w[k],
                                           err_msg=(case, k), **TOL)
        floor = _floor(got["steps"][0]["grads"])
        for name, p in got["trained"].items():
            real = ~floor[name].expand_as(p)
            w = torch.from_numpy(np.asarray(want_params[name]))
            np.testing.assert_allclose(p[real].numpy(), w[real].numpy(),
                                       atol=1e-5, rtol=2e-4,
                                       err_msg=(case, name))
            assert bool(((p - w)[~real].abs() <= 1.01e-3 + 1e-7).all())
    e2e_w1 = steps["e2e", "world1"]
    for step, (g, w) in enumerate(zip(steps["e2e", "pp"]["steps"],
                                      e2e_w1["steps"])):
        assert g["grads"].keys() == w["grads"].keys()
        for name, grad in g["grads"].items():
            want = w["grads"][name]
            if want is None:  # a leaf the loss does not read
                assert grad is None or not grad.any(), name
                continue
            np.testing.assert_allclose(grad.numpy(), want.numpy(),
                                       err_msg=(step, name), **TOL)

    evals = by[0, 0]["eval"]
    assert evals["pp"].keys() == evals["world1"].keys() == {"val/loss",
                                                            "val/score"}
    for k, v in evals["world1"].items():
        np.testing.assert_allclose(evals["pp"][k], v, err_msg=k, **TOL)

    got, want = by[0, 0]["train_cli"], ref["train_cli"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
