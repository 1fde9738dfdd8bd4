"""One rank of the port's two-process gloo run on the CPU, or the JAX
trainer's reference steps beside it. Started by
``tests/test_torch_parallel.py`` (not collected by pytest)::

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dist_worker.py <inputs.pt> <results.pt>
    python tests/_torch_dist_worker.py --jax <case,...> <seed> <trainer settings
        as JSON> <out.pkl>

The inputs (``torch.save`` by the test) hold the tiny f32 config, the
weights the JAX model also has, a global batch of 2 rows whose halves hold
different numbers of answer tokens, the Gumbel noise handed to both
packages, the trainer's settings and a world-1 checkpoint. Each rank runs
the TG and E2E ("tgb" selection, handed noise) recipes two steps at dp=2
and at fsdp=2 on its row, the global random draws against one process's,
the TG and E2E evals of an FSDP model against one process's, a world-2
save and a world-1 restore; rank 0 writes what the test checks.
A rank imports neither JAX nor the JAX package.

``--jax <case,...>`` runs the JAX trainer's first two steps of each case
(tg on a dp=2 mesh, e2e_tgb on an fsdp=2 mesh, of two CPU devices) on the
weights, batch and noise the test makes from the same seed
(``tests/_torch_port_helpers.py``), in a process of its own so that the
test's references compile while the ranks run.
"""

from __future__ import annotations

import sys

import torch


def main() -> None:
    from videotgb_torch.models.videotgb import VideoTGB
    from videotgb_torch.parallel.distributed import (
        barrier, gather_objects, initialize, is_coordinator)
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.parallel.sharding import (
        batch_split, full_tensor, shard_batch, shard_params)
    from videotgb_torch.training import recipes as TR
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, restore_into, train_state_items)
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    initialize(device_type="cpu")
    inp = torch.load(sys.argv[1], weights_only=False)
    batch, noise = inp["batch"], inp["noise"]
    recipes = {"tg": TR.TGRecipe(),
               "e2e_tgb": TR.E2ERecipe(selection="tgb")}
    out: dict = {}

    def model_of():
        model = VideoTGB(inp["cfg"], device="cpu")
        model.load_state_dict(inp["state"])
        return model

    def trainer_of(case, mesh):
        recipe = recipes[case]
        kwargs = {"noise": noise} if case == "e2e_tgb" else {}
        return Trainer(TrainerConfig(**inp["trainer"]),
                       lambda m, b, g: recipe.loss_fn(
                           m, b, g, deterministic=True, **kwargs),
                       recipe.filter_fn, mesh=mesh)

    meshes = {"dp": create_mesh(MeshConfig(dp=2)),
              "fsdp": create_mesh(MeshConfig(dp=1, fsdp=2))}
    for layout, mesh in meshes.items():
        for case in recipes:
            model = model_of()
            trainer = trainer_of(case, mesh)
            state = trainer.init_state(model)
            rows = shard_batch(batch, mesh)
            steps = []
            for _ in range(2):
                state, metrics = trainer.train_step(state, rows)
                steps.append({k: float(v) for k, v in metrics.items()})
            params = {n: full_tensor(p).detach() for n, p in model.named_parameters()}
            trainable = {n: params[n] for n in trainer.trainable}
            ranks = gather_objects(trainable)
            out[layout, case] = {
                "steps": steps, "trainable": trainable,
                "route": trainer.route, "step_route": trainer.step_route,
                "ranks_identical": all(
                    torch.equal(r[n], trainable[n])
                    for r in ranks for n in trainable),
                "frozen_unchanged": all(
                    torch.equal(p, inp["state"][n])
                    for n, p in params.items() if n not in trainable)}
            if layout == "fsdp" and case == "e2e_tgb":
                # a world-2 save in the single-device format, by rank 0
                items = train_state_items(state)
                if is_coordinator():
                    CheckpointManager(CheckpointConfig(
                        directory=inp["ckpt_out"])).save(state.step, items)
                barrier()
                out["saved_moments"] = items and items["opt_state"]

    # random draws: dropout masks and the plain selection's noise at world 2
    # are the global batch's, cut to this rank's row
    model = model_of()
    mesh = meshes["dp"]
    rows = shard_batch(batch, mesh)
    draws = {}
    with torch.no_grad():
        for case, recipe in recipes.items():
            gen = torch.Generator().manual_seed(7)
            with batch_split(mesh):
                loss, aux = recipe.loss_fn(model, rows, gen)
            torch.distributed.all_reduce(loss)
            gen = torch.Generator().manual_seed(7)
            want, want_aux = recipe.loss_fn(model, batch, gen)
            draws[case] = {"world2": float(loss), "world1": float(want)}
            if case == "e2e_tgb":
                draws["cand"] = {"world2": torch.cat(gather_objects(
                    aux["cand"])), "world1": want_aux["cand"]}
    out["draws"] = draws

    # the evals at fsdp=2 (decodes in lockstep, losses summed, answers
    # gathered in the global order) against one process's
    from videotgb_torch.data.tokenizer import load_tokenizer
    from videotgb_torch.train import (evaluate_generative, evaluate_tg,
                                      outside_the_step)

    mesh = meshes["fsdp"]
    tok = load_tokenizer("byte")
    text = {"_text_answer": ["a cat </s>", "two dogs </s>"]}
    rank = torch.distributed.get_rank()
    rows = {**shard_batch(batch, mesh), "_text_answer": text[
        "_text_answer"][rank:rank + 1]}
    evals = {}
    for name, run in (("tg", lambda m, b: evaluate_tg(m, recipes["tg"], b)),
                      ("e2e_tgb", lambda m, b: evaluate_generative(
                          m, recipes["e2e_tgb"], b, tok, max_new_tokens=4))):
        sharded = shard_params(model_of(), mesh)
        with outside_the_step(mesh, sharded):
            got = run(sharded, [rows])
        evals[name] = {"world2": got,
                       "world1": run(model_of(), [{**batch, **text}])}
    out["evals"] = evals

    # a world-1 checkpoint restored into the FSDP model and its optimizer
    model = model_of()
    trainer = trainer_of("e2e_tgb", meshes["fsdp"])
    state = trainer.init_state(model)
    src = CheckpointManager(CheckpointConfig(directory=inp["ckpt_in"]))
    step = restore_into(src.restore(), model, state.optimizer)
    out["restored"] = {"step": step, "params": {
        n: full_tensor(p).detach() for n, p in model.named_parameters()},
        "moments": {n: {k: full_tensor(v) for k, v in state.optimizer.state[p].items()}
                    for n, p in model.named_parameters()
                    if p in state.optimizer.state}}
    if is_coordinator():
        torch.save(out, sys.argv[2])
    barrier()
    torch.distributed.destroy_process_group()


def jax_reference() -> None:
    import json
    import pickle

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_threefry_partitionable", True)
    jax.config.update("jax_disable_most_optimizations", True)
    from _torch_port_helpers import (handed_gumbel, jax_params, jax_tiny_f32,
                                     jax_two_steps, make_inputs,
                                     unequal_answer_batch)
    from videotgb_tpu.models.videotgb import VideoTGB

    cases, seed, settings, dst = sys.argv[2:6]
    jcfg = jax_tiny_f32()
    jmodel = VideoTGB(jcfg)
    tree = jax_params(jmodel, jcfg, int(seed))["params"]
    batch = unequal_answer_batch(jcfg, make_inputs(jcfg, int(seed)))
    out = {case: jax_two_steps(jmodel, tree, case, batch,
                               handed_gumbel(jcfg), json.loads(settings))
           for case in cases.split(",")}
    with open(dst, "wb") as f:
        pickle.dump(out, f)

if __name__ == "__main__":
    jax_reference() if sys.argv[1] == "--jax" else main()
