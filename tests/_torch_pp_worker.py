"""The port's pipeline-parallel run on the CPU: four gloo ranks at ``dp=2,
pp=2``, and the references beside them (not collected by pytest). Started
by ``tests/test_torch_pipeline_parallel.py``, which first writes the
inputs (``pp_inputs``)::

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/_torch_pp_worker.py <pp_in.pkl> <ckpt dir> <out.pt>
    python tests/_torch_pp_worker.py --jax e2e|iv <jax_in.pkl> <ckpt dir> \
        <out.pkl>
    python tests/_torch_pp_worker.py --cli <pp_in.pkl> <run dir> <out.pkl>

Each rank (``rank_checks``; it imports neither JAX nor the JAX package)
runs, every tower with 4 layers a stack, so that a stage holds 2:

* an 8-layer MLP stack through ``pipeline_apply`` at M = 2 and 4;
* the tiny LLaMA (with ``remat``) and T5 (encode, then the teacher-forced
  decode) staged by ``Trainer.init_state``, one step of ``mean(logits **
  2)`` with every parameter training (at lr 0: the warmup's first step):
  the logits and each gradient as the update reads it, the route counts
  and the held layers; then LLaMA's forward on 3 of the rank's rows, which
  do not split into 2 microbatches (one microbatch through the stages);
* a resume at world 1 of the T5 tower's pp checkpoint and a resume at pp
  of its world-1 checkpoint, each one more step, against the other
  world's second step;
* two E2E ("tgb" selection, handed noise, dropout off; rank 0 also at
  world 1, for the gradients of each step) and two InstructBLIP-Vicuna IV
  ``Trainer`` steps of the tiny f32 model with ``scan_layers`` towers, and
  an eval of the staged E2E model against rank 0's at world 1;
* ``train.main`` at ``experiment=smoke_tg_synthetic trainer.dp=2
  trainer.pp=2``, as under ``torchrun``.

The tiny BLIP2 and Vicuna weights are the JAX package's seeded ones,
which the test writes once the processes have started (``write_weights``;
the ranks and ``--jax`` wait for them). The references run meanwhile:
``--jax e2e`` and ``--jax iv`` (``jax_main``) the JAX trainer's two E2E
and two IV steps at world 1; ``--cli`` the port's training CLI at world 1; in
the test's process (``pipeline_references``) the JAX ``pipeline_apply`` of
the MLP stack, the JAX LLaMA and T5 towers pipelined on a dp=2 x pp=2 mesh
of CPU devices, and JAX's ``scan_layers`` + ``nn.remat`` towers.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import sys

import numpy as np

LAYERS = 4
ROWS = 4  # the E2E and IV global batch: 2 rows a dp rank, 1 a microbatch
TOWER_ROWS, ENC_LEN, DEC_LEN = 8, 10, 6
MLP_LAYERS, MLP_WIDTH = 8, 16
SETTINGS = dict(max_steps=10, lr=1e-3, warmup_ratio=0.1)
TRAIN_CLI = ["experiment=smoke_tg_synthetic", "trainer.platform=cpu",
             "data.num_workers=0"]
BLIP2_SEED = 3
WAIT_S = 120  # for the Vicuna weights, which the test writes


def with_layers(cfg, scan: bool, remat: bool = False):
    """``cfg`` (either package's VideoTGBConfig, or a T5 / LLaMA config)
    with LAYERS layers a stack and the flags set."""
    if hasattr(cfg, "backbone"):
        if cfg.backbone == "blip2":
            t5 = with_layers(cfg.blip2.t5, scan, remat)
            return dataclasses.replace(
                cfg, blip2=dataclasses.replace(cfg.blip2, t5=t5))
        llm = with_layers(cfg.instructblip.llm, scan, remat)
        return dataclasses.replace(cfg, instructblip=dataclasses.replace(
            cfg.instructblip, llm=llm))
    if hasattr(cfg, "num_encoder_layers"):
        return dataclasses.replace(cfg, num_encoder_layers=LAYERS,
                                   num_decoder_layers=LAYERS,
                                   scan_layers=scan, remat=remat)
    return dataclasses.replace(cfg, num_layers=LAYERS, scan_layers=scan,
                               remat=remat)


# ------------------------------------------------------------- the ranks
def rank_checks(inp: dict, ckpt: str) -> dict:
    import torch

    from videotgb_torch.parallel.distributed import gather_objects
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(dp=2, pp=2))
    out = {"coord": (mesh.get_local_rank("dp"), mesh.get_local_rank("pp")),
           "mlp": mlp_runs(inp, mesh)}
    for kind in ("llama", "t5"):
        out[kind] = tower_step(inp, mesh, kind, ckpt)
    out["resume"] = resume_runs(inp, mesh, ckpt)
    out["steps"], out["eval"] = recipe_steps(inp, mesh, ckpt)
    from videotgb_torch import train as TTR
    from videotgb_torch.models import videotgb as TV

    tiny = TV.VideoTGBConfig.tiny
    TV.VideoTGBConfig.tiny = classmethod(
        lambda cls, backbone="blip2": inp["cli_cfg"])
    try:
        out["train_cli"] = TTR.main(TRAIN_CLI + [
            "trainer.dp=2", "trainer.pp=2",
            f"paths.output_dir={os.path.join(ckpt, 'train_pp')}"])
    finally:
        TV.VideoTGBConfig.tiny = tiny
    torch.distributed.barrier()
    return gather_objects(out)


def mlp_stack(inp):
    import torch
    from torch import nn

    class Layer(nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.w = nn.Parameter(torch.from_numpy(w).clone())
            self.b = nn.Parameter(torch.from_numpy(b).clone())

    return nn.ModuleList(Layer(w, b) for w, b in zip(inp["mlp"]["w"],
                                                     inp["mlp"]["b"]))


def mlp_layer(layer, tree):
    import torch

    return (torch.tanh(tree[0] @ layer.w + layer.b), *tree[1:])


def mlp_runs(inp: dict, mesh) -> dict:
    """``pipeline_apply`` of the MLP stack on this rank's rows at M = 2 and
    4, backpropagating its share of ``sum(y ** 2)``: the output rows, the
    input's gradient summed over the pp ranks, and the held layers'
    gradients summed over the dp ranks."""
    import torch
    import torch.distributed as dist

    from videotgb_torch.parallel.mesh import pp_rank
    from videotgb_torch.parallel.pipeline import (PPGroup, pipeline_apply,
                                                  place_pipeline_params)
    from videotgb_torch.parallel.sharding import shard_batch

    pp = PPGroup(*pp_rank(mesh), mesh.get_group("pp"))
    out = {}
    for m in (2, 4):
        layers = mlp_stack(inp)
        mine = place_pipeline_params(layers, pp)
        x = shard_batch(torch.from_numpy(inp["mlp"]["x"]), mesh).clone()
        x.requires_grad_()
        y = pipeline_apply(mlp_layer, layers, x, pp, m)
        (y.square().sum() / pp.size).backward()
        dx = x.grad.clone()
        dist.all_reduce(dx, group=pp.group)
        grads = {}
        for i in mine:
            for name in ("w", "b"):
                g = getattr(layers[i], name).grad.clone()
                dist.all_reduce(g, group=mesh.get_group("dp"))
                grads[i, name] = g
        out[m] = {"y": y.detach(), "dx": dx, "grads": grads,
                  "sizes": {i: layers[i].w.numel() for i in range(len(
                      layers))}}
    return out


def _read_grads(TT, grads: dict):
    """An ``optimizer_step`` that first keeps every gradient it updates
    with (after the trainer's reductions, before the clip)."""
    update = TT.optimizer_step

    def read(optimizer, lr, max_grad_norm):
        for group in optimizer.param_groups:
            for p in group["params"]:
                grads[id(p)] = None if p.grad is None else p.grad.clone()
        return update(optimizer, lr, max_grad_norm)

    return update, read


def tower_of(inp, kind, staged: bool):
    """The tiny f32 LLaMA or T5 of the tower references, ``scan_layers``
    (and ``remat`` on LLaMA) where ``staged``, with their weights."""
    import torch

    from videotgb_torch.models.llama import LlamaModel
    from videotgb_torch.models.t5 import T5Model

    cfg = inp["towers"][kind]["cfg"]
    cfg = dataclasses.replace(cfg, scan_layers=staged)
    model = (LlamaModel if kind == "llama" else T5Model)(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp[
        "towers"][kind]["state"].items()})
    return model


def tower_loss(kind, seen: list):
    """``mean(logits ** 2)`` over the global batch as this rank's share;
    keeps the logits."""
    import torch

    from videotgb_torch.parallel.sharding import global_count

    def loss_fn(model, batch, gen):
        if kind == "llama":
            logits, _ = model(input_ids=batch["ids"],
                              attention_mask=batch["mask"])
        else:
            hidden = model.encode(model.embed(batch["enc_ids"]),
                                  batch["enc_mask"])
            logits, _ = model.decode(batch["dec_ids"], hidden,
                                     batch["enc_mask"])
        seen.append(logits.detach())
        count = global_count(torch.tensor(float(logits.numel())))
        loss = logits.square().sum() / count
        return loss, {"loss": loss}

    return loss_fn


def tower_batch(inp, kind):
    import torch

    return {k: torch.from_numpy(v) for k, v in inp["towers"][kind][
        "batch"].items()}


def tower_step(inp: dict, mesh, kind: str, ckpt: str) -> dict:
    """One ``Trainer`` step of the staged tower at ``dp=2, pp=2``: the
    rank's logits, each gradient the update reads, the route, the staged
    calls and the held layers. Saves the T5 tower's state after the step
    (``train_state_items``) for the resume at world 1."""
    import torch

    from videotgb_torch.parallel.distributed import is_coordinator
    from videotgb_torch.parallel.sharding import shard_batch
    from videotgb_torch.training import trainer as TT
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, train_state_items)

    seen: list = []
    trainer = TT.Trainer(TT.TrainerConfig(**SETTINGS), tower_loss(kind, seen),
                         mesh=mesh)
    model = tower_of(inp, kind, True)
    state = trainer.init_state(model)
    grads: dict = {}
    update, read = _read_grads(TT, grads)
    TT.optimizer_step = read
    try:
        state, metrics = trainer.train_step(
            state, shard_batch(tower_batch(inp, kind), mesh))
    finally:
        TT.optimizer_step = update
    if kind == "llama":  # 3 rows do not split into 2 microbatches
        with torch.no_grad():
            rows = shard_batch(tower_batch(inp, kind), mesh)
            odd, _ = model(input_ids=rows["ids"][:3],
                           attention_mask=rows["mask"][:3])
    named = dict(model.named_parameters())
    rec = {"logits": seen[-1], "route": trainer.route,
           "step_route": trainer.step_route,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: grads[id(p)] for n, p in named.items()
                     if id(p) in grads},
           "held": sorted(n for n, p in named.items() if p.numel()),
           "optimizer_names": list(trainer.trainable),
           "moments": sum(t.numel() for s in state.optimizer.state.values()
                          for k, t in s.items() if k != "step"),
           "calls": dict(model.pp.calls)}
    if kind == "llama":
        rec["odd"] = odd
    if kind == "t5":
        items = train_state_items(state)
        if is_coordinator():
            CheckpointManager(CheckpointConfig(directory=os.path.join(
                ckpt, "t5_pp"))).save(state.step, items)
        torch.distributed.barrier()
        _, m2 = trainer.train_step(state, shard_batch(tower_batch(
            inp, kind), mesh))
        rec["second"] = _whole_params(state.model, float(m2["loss"]))
    return rec


def _whole_params(model, loss) -> dict:
    """Every parameter whole on every rank (a collective: the staged
    layers from their stages) and the step's loss."""
    import torch

    from videotgb_torch.parallel.pipeline import whole_stages

    with torch.no_grad(), whole_stages(model, "a test's read"):
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"params": params, "loss": loss}


def resume_runs(inp: dict, mesh, ckpt: str) -> dict:
    """The T5 tower's pp checkpoint resumed at world 1 on rank 0, and a
    world-1 checkpoint (rank 0's first step) resumed at pp on every rank;
    each takes one more step."""
    import torch

    from videotgb_torch.parallel.distributed import is_coordinator
    from videotgb_torch.parallel.sharding import shard_batch
    from videotgb_torch.training import trainer as TT
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, restore_into, train_state_items)

    batch = tower_batch(inp, "t5")
    root = os.path.join(ckpt, "t5_w1")
    out = {}
    if is_coordinator():
        for what in ("world1", "pp_at_world1"):
            trainer = TT.Trainer(TT.TrainerConfig(**SETTINGS),
                                 tower_loss("t5", []))
            state = trainer.init_state(tower_of(inp, "t5", False))
            if what == "world1":
                state, _ = trainer.train_step(state, batch)
                CheckpointManager(CheckpointConfig(directory=root)).save(
                    state.step, train_state_items(state))
            else:
                src = CheckpointManager(CheckpointConfig(
                    directory=os.path.join(ckpt, "t5_pp")))
                state.step = restore_into(src.restore(), state.model,
                                          state.optimizer)
            state, m = trainer.train_step(state, batch)
            out[what] = _whole_params(state.model, float(m["loss"]))
    torch.distributed.barrier()
    trainer = TT.Trainer(TT.TrainerConfig(**SETTINGS), tower_loss("t5", []),
                         mesh=mesh)
    state = trainer.init_state(tower_of(inp, "t5", True))
    state.step = restore_into(CheckpointManager(CheckpointConfig(
        directory=root)).restore(), state.model, state.optimizer)
    state, m = trainer.train_step(state, shard_batch(batch, mesh))
    out["world1_at_pp"] = _whole_params(state.model, float(m["loss"]))
    return out


def _model(ckpt: str, cfg):
    """The tiny model of ``cfg``'s backbone with the JAX weights the test
    writes under ``ckpt`` (waited for)."""
    from videotgb_torch.models.videotgb import VideoTGB
    from videotgb_torch.training.checkpoint import restore_params

    wait_for(os.path.join(ckpt, f"{cfg.backbone}.done"))
    model = VideoTGB(cfg, device="cpu")
    restore_params(model, os.path.join(ckpt, cfg.backbone))
    return model


def recipe_steps(inp: dict, mesh, ckpt: str) -> tuple[dict, dict]:
    """Two ``Trainer`` steps of E2E ("tgb", handed noise, dropout off) and
    of IV at ``dp=2, pp=2``: each step's metrics and gradients, the
    trained tensors after them; then the staged E2E model's eval against
    rank 0's at world 1."""
    import torch

    from videotgb_torch import train as TTR
    from videotgb_torch.data.tokenizer import load_tokenizer
    from videotgb_torch.parallel.distributed import is_coordinator
    from videotgb_torch.parallel.sharding import shard_batch
    from videotgb_torch.training import trainer as TT
    from videotgb_torch.training.recipes import E2ERecipe, IVRecipe

    e2e, iv = E2ERecipe(selection="tgb"), IVRecipe()
    noise = torch.from_numpy(inp["noise"])
    cases = {"e2e": (functools.partial(e2e.loss_fn, deterministic=True,
                                       noise=noise), e2e.filter_fn,
                     inp["torch_cfg"], inp["e2e_batch"]),
             "iv": (iv.loss_fn, iv.filter_fn, inp["iv_cfg"],
                    inp["iv_batch"])}
    out, models = {}, {}
    for name, (loss_fn, filter_fn, cfg, rows) in cases.items():
        rows = {k: torch.from_numpy(v) for k, v in rows.items()}
        worlds = [("pp", mesh)] + ([("world1", None)] if is_coordinator()
                                   and name == "e2e" else [])
        for world, m in worlds:
            trainer = TT.Trainer(TT.TrainerConfig(**SETTINGS), loss_fn,
                                 filter_fn, mesh=m)
            state = trainer.init_state(_model(ckpt, cfg))
            batch = rows if m is None else shard_batch(rows, mesh)
            steps = []
            for _ in range(2):
                grads: dict = {}
                update, read = _read_grads(TT, grads)
                TT.optimizer_step = read
                try:
                    state, metrics = trainer.train_step(state, batch)
                finally:
                    TT.optimizer_step = update
                params = {n: p for n, p in state.model.named_parameters()
                          if n in trainer.trainable}
                steps.append({"metrics": {k: float(v) for k, v in
                                          metrics.items()},
                              "grads": {n: grads[id(p)]
                                        for n, p in params.items()}})
            pp = getattr(state.model, "pp", None)
            out[name, world] = {
                "steps": steps, "route": trainer.route,
                "step_route": trainer.step_route,
                "calls": None if pp is None else dict(pp.calls),
                "trained": {n: p.detach().clone()
                            for n, p in state.model.named_parameters()
                            if n in trainer.trainable}}
            if world == "pp":
                models[name] = state.model
    # the eval of the staged E2E model (its stages gathered) and rank 0's
    # of the same weights at world 1
    tok = load_tokenizer("byte")
    rows = dict(inp["e2e_batch"], _text_answer=inp["answers"])
    local = shard_batch({k: v for k, v in rows.items()
                         if k != "_text_answer"}, mesh)
    per = ROWS // mesh["dp"].size()
    first = mesh.get_local_rank("dp") * per
    local["_text_answer"] = inp["answers"][first:first + per]
    recipe = E2ERecipe(selection="tgb")
    model = models["e2e"]
    with TTR.outside_the_step(mesh, model):
        evals = {"pp": TTR.evaluate_generative(model, recipe, [local], tok,
                                               max_new_tokens=4)}
    if is_coordinator():
        whole = _model(ckpt, inp["torch_cfg"])
        with torch.no_grad():
            held = _whole_params(model, 0.0)["params"]
            whole.load_state_dict(held)
        evals["world1"] = TTR.evaluate_generative(whole, recipe, [rows], tok,
                                                  max_new_tokens=4)
    else:
        _whole_params(model, 0.0)  # the collective rank 0 joins above
    return out, evals


# ------------------------------------------- the references in the test
def pp_inputs() -> dict:
    """The run's inputs, from seeds: the MLP stack and its input; the tiny
    f32 LLaMA and T5 towers (4 layers a stack), their weights and batches;
    a global E2E batch of 4 rows with unequal answers and its handed
    Gumbel noise; an IV batch of 4 rows; both packages' configs."""
    import jax

    from _torch_port_helpers import (jax_tiny_f32, random_tree,
                                     torch_tiny_f32)
    from videotgb_torch.data.datasets import pack_text_input_output
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_tpu.models.llama import LlamaModel
    from videotgb_tpu.models.t5 import T5Model

    rng = np.random.default_rng(22)
    jcfg = with_layers(jax_tiny_f32(), True)
    icfg = with_layers(jax_tiny_f32("instructblip"), True)
    img, fs, b, flow = jcfg.blip2.vit.image_size, jcfg.tgb.flow_size, ROWS, 4

    def ids(n, rows=b):
        return rng.integers(4, 60, (rows, n)).astype(np.int32)

    answers = ids(6)
    answers[0, 3:] = 0
    answers[2, 5:] = 0
    e2e = {"frames": rng.standard_normal(
               (b, jcfg.num_frames, img, img, 3)).astype(np.float32),
           "flow": rng.standard_normal((b, flow, fs, fs, 2)).astype(
               np.float32),
           "flow_mask": np.ones((b, flow + 2), np.float32),
           "video_length": np.full((b,), flow, np.int32),
           "sampler_question_ids": ids(8),
           "sampler_question_mask": np.ones((b, 8), np.float32),
           "question_ids": ids(6),
           "question_mask": np.array([[1.0] * 6, [1.0] * 4 + [0.0] * 2] * 2,
                                     np.float32),
           "answer_ids": answers}
    inst_ids, inst_mask, labels = pack_text_input_output(
        [ids(6)[0, :n].tolist() for n in (6, 4, 5, 6)],
        [ids(5)[0, :n].tolist() for n in (3, 5, 2, 4)], 10, 0)
    iv = {"frames": rng.standard_normal(
              (b, icfg.nframe, img, img, 3)).astype(np.float32),
          "qformer_input_ids": ids(5),
          "qformer_attention_mask": np.array([[1] * 5, [1] * 3 + [0] * 2]
                                             * 2, np.int32),
          "instruction_ids": inst_ids, "instruction_mask": inst_mask,
          "labels": labels}
    towers = {}
    for kind, cls, cfg in (("llama", LlamaModel, icfg.instructblip.llm),
                           ("t5", T5Model, jcfg.blip2.t5)):
        cfg = dataclasses.replace(cfg, scan_layers=True)
        mask = (rng.random((TOWER_ROWS, ENC_LEN)) > 0.2).astype(np.float32)
        mask[:, 0] = 1.0
        if kind == "llama":
            batch = {"ids": ids(DEC_LEN, TOWER_ROWS), "mask": mask[:, :DEC_LEN]}
            args = (batch["ids"],)
        else:
            batch = {"enc_ids": ids(ENC_LEN, TOWER_ROWS), "enc_mask": mask,
                     "dec_ids": ids(DEC_LEN, TOWER_ROWS)}
            args = (np.zeros((TOWER_ROWS, ENC_LEN, cfg.d_model), np.float32),
                    mask, batch["dec_ids"])
        model = cls(cfg)
        shapes = jax.eval_shape(lambda k: model.init(k, *args),
                                jax.random.key(0))
        tree = random_tree(nn_unbox(shapes)["params"], seed=len(kind))
        state = {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}
        towers[kind] = {"jax_cfg": cfg, "tree": tree, "state": state,
                        "boxed": shapes["params"], "batch": batch}
    for kind, tcfg in (("llama", torch_tiny_f32("instructblip")
                        .instructblip.llm),
                       ("t5", torch_tiny_f32().blip2.t5)):
        towers[kind]["cfg"] = with_layers(tcfg, True, remat=kind == "llama")
    return {
        "mlp": {"w": (rng.standard_normal((MLP_LAYERS, MLP_WIDTH, MLP_WIDTH))
                      * 0.3).astype(np.float32),
                "b": (rng.standard_normal((MLP_LAYERS, MLP_WIDTH))
                      * 0.1).astype(np.float32),
                "x": rng.standard_normal((8, 4, MLP_WIDTH)).astype(
                    np.float32)},
        "towers": towers, "e2e_batch": e2e, "iv_batch": iv,
        "answers": [f"answer {i}" for i in range(b)],
        "noise": rng.gumbel(size=(jcfg.top_k, 2, b, flow)).astype(
            np.float32),
        "jax_cfg": jcfg, "jax_iv_cfg": icfg, "cli_cfg": torch_tiny_f32(),
        "torch_cfg": with_layers(torch_tiny_f32(), True),
        "iv_cfg": with_layers(torch_tiny_f32("instructblip"), True)}


def nn_unbox(tree):
    from flax import linen as nn

    return nn.meta.unbox(tree)


def mlp_reference(inp: dict) -> dict:
    """The JAX ``pipeline_apply`` of the MLP stack on a dp=2 x pp=2 mesh at
    M = 2 and 4: the output, and the gradients of ``sum(y ** 2)`` of the
    stacked weights and of the input."""
    import jax
    import jax.numpy as jnp

    from _torch_port_helpers import run_once
    from videotgb_tpu.parallel.mesh import MeshConfig, create_mesh
    from videotgb_tpu.parallel.pipeline import (pipeline_apply,
                                                place_pipeline_params)

    mesh = create_mesh(MeshConfig(dp=2, pp=2), jax.devices()[:4])
    params = {k: jnp.asarray(inp["mlp"][k]) for k in ("w", "b")}
    x = jnp.asarray(inp["mlp"]["x"])

    def layer(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    out = {}
    for m in (2, 4):
        def loss(p, h):
            y = pipeline_apply(layer, p, h, mesh, "pp", m)
            return jnp.sum(y ** 2), y

        (_, y), (gp, gx) = run_once(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
            place_pipeline_params(params, mesh, "pp"), x)
        out[m] = {"y": np.asarray(y), "dx": np.asarray(gx),
                  "w": np.asarray(gp["w"]), "b": np.asarray(gp["b"])}
    return out


def tower_reference(inp: dict, kind: str) -> dict:
    """The JAX scanned tower pipelined on a dp=2 x pp=2 mesh (as
    ``tests/test_pipeline_parallel.py``): its logits and the gradients of
    ``mean(logits ** 2)`` under the port's parameter names."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from _torch_port_helpers import run_once
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_tpu.models.llama import LlamaModel
    from videotgb_tpu.models.t5 import T5Model
    from videotgb_tpu.parallel.mesh import MeshConfig, create_mesh
    from videotgb_tpu.parallel.sharding import param_partition_spec

    t = inp["towers"][kind]
    mesh = create_mesh(MeshConfig(dp=2, pp=2), jax.devices()[:4])
    model = (LlamaModel if kind == "llama" else T5Model)(t["jax_cfg"])
    batch = {k: jnp.asarray(v) for k, v in t["batch"].items()}

    def fwd(p):
        if kind == "llama":
            logits, _ = model.apply({"params": p}, batch["ids"],
                                    attention_mask=batch["mask"])
            return logits
        hidden = model.apply({"params": p}, model.apply(
            {"params": p}, batch["enc_ids"], method=model.embed),
            batch["enc_mask"], method=model.encode)
        logits, _ = model.apply({"params": p}, batch["dec_ids"], hidden,
                                batch["enc_mask"], method=model.decode)
        return logits

    def loss(p):
        logits = fwd(p)
        return jnp.mean(logits ** 2), logits

    specs = param_partition_spec(t["boxed"])
    params = jax.tree.map(
        lambda x_, s_: jax.device_put(jnp.asarray(x_),
                                      NamedSharding(mesh, s_)),
        t["tree"], specs)
    with mesh:
        (value, logits), grads = run_once(
            jax.value_and_grad(loss, has_aux=True), params)
    return {"logits": np.asarray(logits), "loss": float(value),
            "grads": {k: v.numpy() for k, v in flax_to_state_dict(
                jax.device_get(grads)).items()}}


def jax_steps(jmodel, tree, batch: dict, jrecipe, noise=None) -> tuple:
    """The JAX trainer's first two steps of ``jrecipe`` at world 1, dropout
    off, a "tgb" selection reading the handed ``noise``: (per-step
    metrics, the parameter tree after them). Only the subtrees the loss
    reads are given to it (RAFT's never: the batches hold the flow; the
    temporal encoder's only where the recipe selects)."""
    import unittest.mock as mock

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from videotgb_tpu.parallel.mesh import MeshConfig
    from videotgb_tpu.training import trainer as JTR

    def loss_fn(p, b, k):
        with mock.patch.object(jax.random, "gumbel",
                               lambda key, shape, dtype=None: noise):
            return jrecipe.loss_fn(jmodel, p, b, k, deterministic=True)

    unread = ("of_extractor",) + (("temporal_encoder",) if noise is None
                                  else ())
    trainer = JTR.Trainer(JTR.TrainerConfig(**SETTINGS,
                                            mesh=MeshConfig(dp=1)),
                          loss_fn, filter_fn=jrecipe.filter_fn)
    state = trainer.init_state({k: jax.tree.map(jnp.array, v)
                                for k, v in tree.items() if k not in unread})
    rep = NamedSharding(trainer.mesh, PartitionSpec())
    state = JTR.TrainState(*(jax.device_put(x, rep) for x in (
        state.params, state.opt_state, state.step)))
    steps = []
    for _ in range(2):
        state, metrics = trainer.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        steps.append({k: float(v) for k, v in metrics.items()})
    return steps, jax.device_get(state.params)


def pipeline_references(inp: dict) -> dict:
    """The JAX pipelines the ranks are held against (the test's process
    has the 8-device CPU mesh), and JAX's remat towers."""
    return {"mlp": mlp_reference(inp),
            **{kind: tower_reference(inp, kind) for kind in ("llama", "t5")},
            "remat": {kind: remat_reference(t, kind)
                      for kind, t in inp["towers"].items()}}


def remat_reference(t: dict, kind: str) -> dict:
    """JAX's ``scan_layers`` + ``nn.remat`` tower at world 1: the loss
    ``mean(logits ** 2)`` and its gradients under the port's names."""
    import jax
    import jax.numpy as jnp

    from _torch_port_helpers import run_once
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_tpu.models.llama import LlamaModel
    from videotgb_tpu.models.t5 import T5Model

    cfg = dataclasses.replace(t["jax_cfg"], remat=True)
    model = (LlamaModel if kind == "llama" else T5Model)(cfg)
    b = {k: jnp.asarray(v) for k, v in t["batch"].items()}

    def loss(p):
        if kind == "llama":
            logits, _ = model.apply({"params": p}, b["ids"],
                                    attention_mask=b["mask"])
        else:
            hidden = model.apply({"params": p}, model.apply(
                {"params": p}, b["enc_ids"], method=model.embed),
                b["enc_mask"], method=model.encode)
            logits, _ = model.apply({"params": p}, b["dec_ids"], hidden,
                                    b["enc_mask"], method=model.decode)
        return jnp.mean(logits ** 2)

    value, grads = run_once(jax.value_and_grad(loss),
                            jax.tree.map(jnp.asarray, t["tree"]))
    return {"loss": float(value),
            "grads": {k: v.numpy() for k, v in flax_to_state_dict(
                jax.device_get(grads)).items()}}


def wait_for(path: str) -> None:
    """Until the file at ``path`` exists (at most WAIT_S)."""
    import time

    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {WAIT_S} s")
        time.sleep(0.1)


def write_weights(inp: dict, ckpt: str) -> None:
    """The seeded JAX weights (``jax_params``) of the tiny BLIP2-Flan-T5
    and InstructBLIP-Vicuna as port checkpoints under ``ckpt``/<backbone>
    for the ranks, and as numpy trees for ``--jax``; after each, the
    marker both wait for."""
    import jax

    from _torch_port_helpers import jax_params
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_torch.training.checkpoint import (CheckpointConfig,
                                                    CheckpointManager)
    from videotgb_tpu.models.videotgb import VideoTGB

    for jcfg, seed in ((inp["jax_cfg"], BLIP2_SEED), (inp["jax_iv_cfg"], 0)):
        tree = jax.device_get(jax_params(VideoTGB(jcfg), jcfg, seed)[
            "params"])
        CheckpointManager(CheckpointConfig(directory=os.path.join(
            ckpt, jcfg.backbone))).save(
                1, {"params": flax_to_state_dict(tree), "step": 1})
        with open(os.path.join(ckpt, f"{jcfg.backbone}_tree.pkl"), "wb") as f:
            pickle.dump(tree, f)
        open(os.path.join(ckpt, f"{jcfg.backbone}.done"), "w").close()


def jax_main() -> None:
    """``--jax <case>``: the JAX trainer's two E2E ("e2e") or IV ("iv")
    steps at world 1 on the weights ``write_weights`` writes (waited for),
    in a process of its own that imports neither torch nor the port."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    jax.config.update("jax_disable_most_optimizations", True)
    from videotgb_tpu.models.videotgb import VideoTGB
    from videotgb_tpu.training import recipes as JR

    case, src, ckpt, dst = sys.argv[2:6]
    with open(src, "rb") as f:
        inp = pickle.load(f)
    jcfg, batch, jrecipe, noise = {
        "e2e": (inp["jax_cfg"], inp["e2e_batch"],
                JR.E2ERecipe(selection="tgb"), inp["noise"]),
        "iv": (inp["jax_iv_cfg"], inp["iv_batch"], JR.IVRecipe(), None),
    }[case]
    wait_for(os.path.join(ckpt, f"{jcfg.backbone}.done"))
    with open(os.path.join(ckpt, f"{jcfg.backbone}_tree.pkl"), "rb") as f:
        tree = pickle.load(f)
    out = jax_steps(VideoTGB(jcfg), tree, batch, jrecipe,
                    None if noise is None else jax.numpy.asarray(noise))
    with open(dst, "wb") as f:
        pickle.dump(out, f)


def cli_main() -> None:
    """``--cli``: the port's training CLI at world 1 (``trainer=cpu``) on
    the tiny f32 preset, the ranks' run's reference."""
    import torch

    from videotgb_torch import train as TTR
    from videotgb_torch.models import videotgb as TV

    torch.set_num_threads(1)
    src, run_dir, dst = sys.argv[2:5]
    with open(src, "rb") as f:
        cfg = pickle.load(f)["cli_cfg"]
    TV.VideoTGBConfig.tiny = classmethod(lambda cls, backbone="blip2": cfg)
    out = TTR.main(TRAIN_CLI + ["trainer=cpu", f"paths.output_dir={run_dir}"])
    with open(dst, "wb") as f:
        pickle.dump(out, f)


def rank_main() -> None:
    import torch

    from videotgb_torch.parallel.distributed import (barrier, initialize,
                                                     is_coordinator)

    torch.set_num_threads(1)
    initialize(device_type="cpu")
    src, ckpt, dst = sys.argv[1:4]
    with open(src, "rb") as f:
        inp = pickle.load(f)
    out = rank_checks(inp, ckpt)
    if is_coordinator():
        torch.save(out, dst)
    barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    {"--jax": jax_main, "--cli": cli_main}.get(sys.argv[1], rank_main)()
