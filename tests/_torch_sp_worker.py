"""The port's sequence-parallel run on the CPU: four gloo ranks, and the JAX
package's world-1 references beside them (not collected by pytest).
Started by ``tests/test_torch_sequence_parallel.py``, which first writes
the seeded weights (``write_checkpoint``)::

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/_torch_sp_worker.py --rank <sp_in.pkl> <ckpt dir> \
        <out.pt>

Each rank (``rank_checks``; it imports neither JAX nor the JAX package)
runs, every model restored from that checkpoint:

* at ``dp=2, sp=2``, through ``Trainer``: an SF step (dropout off, the
  handed Gumbel noise), an E2E step ("tgb" selection) and a TG step, both
  with dropout on, rank 0 also taking the world-1 steps of the last two,
  and an IV step of InstructBLIP-Vicuna (no dropout, no draw: Vicuna's
  forward without caches, split);
* ``generate_blip2`` with handed noise at ``tp=2, sp=2`` and at ``dp=2,
  sp=2`` (tokens, frames, the first decode step's logits), and the flash
  route of a T5 encoder pass at 160 tokens, split or whole;
* ``ServingEngine`` at ``mesh="tp=2,sp=2"`` and ``"dp=2,sp=2"``, request
  by request, against rank 0's world-1 engine, and one request through
  rank 0's HTTP server (``serve --mesh``) at ``tp=2,sp=2``;
* ``run_inference --mesh`` at both meshes;
* ``train.main`` (``experiment=smoke_tg_synthetic trainer=sp
  trainer.dp=2``): the CLI in the ranks, as under ``torchrun``.

Every run counts the stream splits and gathers of each tower method
(``SPCalls``), so that the test sees which streams were split.

The references at world 1 run in the test's process meanwhile: the JAX
SF and IV steps (``step_reference``), the JAX ``generate_blip2``
(``generate_reference``), the JAX QA CLI and the port's training CLI
(``cli_references``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import pickle
import sys

import numpy as np

from _torch_tp_worker import http_generate

ENGINE = dict(preset="tiny", batch_size=2, flow_frames=4, max_new_tokens=4,
              max_delay_ms=200.0, bf16_params=False)
CLI_FLAGS = ["--batch_size", "2", "--flow_frames", "4", "--max_new_tokens",
             "4", "--do_sample", "0", "--bf16_params", "0", "--flow_mode",
             "fixed", "--preset", "tiny", "--backbone", "blip2"]
MESHES = ("tp=2,sp=2", "dp=2,sp=2")
TRAIN_CLI = ["experiment=smoke_tg_synthetic", "trainer.platform=cpu",
             "data.num_workers=0"]
WAIT_S = 90  # for an engine's reply
TOWERS = ("TGBModel", "T5Model", "LlamaModel")  # parallel.sequence's


def cli_argv(sp_in: dict, model_path: str, out_dir: str) -> list:
    cli = sp_in["cli"]
    return ["--model_path", model_path, "--video_dir", cli["video_dir"],
            "--gt_file_question", cli["questions"],
            "--gt_file_answers", cli["answers"], "--output_dir", out_dir,
            "--output_name", "preds", *CLI_FLAGS]


# ------------------------------------------------------------- the ranks
class SPCalls:
    """Counts, while installed, each tower method's stream splits (the
    ``SPGroup.split`` calls the tower itself makes, not a layer's split of
    a rotary table) and the ``SPGroup.gather`` calls under it (each
    self-attention's and the one at the end), keyed "TGBModel.forward",
    "T5Model.encode" and so on. :meth:`take` returns and resets them."""

    def __init__(self):
        self.split, self.gather = collections.Counter(), collections.Counter()

    def __enter__(self):
        from videotgb_torch.parallel.sequence import SPGroup

        self._orig = split, gather = SPGroup.split, SPGroup.gather

        def counted_split(sp, x):
            frame = sys._getframe(1)
            kind = type(frame.f_locals.get("self")).__name__
            if kind in TOWERS:
                self.split[f"{kind}.{frame.f_code.co_name}"] += 1
            return split(sp, x)

        def counted_gather(sp, x):
            frame = sys._getframe(1)
            while type(frame.f_locals.get("self")).__name__ not in TOWERS:
                frame = frame.f_back
            kind = type(frame.f_locals["self"]).__name__
            self.gather[f"{kind}.{frame.f_code.co_name}"] += 1
            return gather(sp, x)

        SPGroup.split, SPGroup.gather = counted_split, counted_gather
        return self

    def __exit__(self, *exc):
        from videotgb_torch.parallel.sequence import SPGroup

        SPGroup.split, SPGroup.gather = self._orig

    def take(self) -> dict:
        out = {"split": dict(self.split), "gather": dict(self.gather)}
        self.split.clear()
        self.gather.clear()
        return out


def rank_checks(sp_in: dict, ckpt: str) -> dict:
    """This rank's sequence-parallel results (rank 0's are the ones the
    test reads; what must agree across the ranks rides along)."""
    import torch

    from videotgb_torch.evalsuite import inference as TI
    from videotgb_torch.models import videotgb as TV
    from videotgb_torch.parallel.distributed import gather_objects
    from videotgb_torch.serve import ServingEngine

    cfg = sp_in["torch_cfg"]
    tiny, choose = TV.VideoTGBConfig.tiny, TV.VideoTGB.select_frames
    TV.VideoTGBConfig.tiny = classmethod(lambda cls, backbone="blip2": cfg)
    handed: list = []

    def select_handed(self, start_logits, end_logits, video_length,
                      generator=None, **kw):
        if handed:
            kw["noise"] = torch.from_numpy(handed.pop(0))
        return choose(self, start_logits, end_logits, video_length,
                      generator, **kw)

    TV.VideoTGB.select_frames = select_handed
    rank = torch.distributed.get_rank()
    out: dict = {}
    calls = SPCalls().__enter__()
    try:
        out["steps"] = train_steps(sp_in, ckpt, rank, calls)
        out["generate"] = {}
        for mesh in MESHES:
            out["generate"][mesh] = generate(sp_in, ckpt, mesh)
            out["generate"][mesh]["calls"] = calls.take()
        out["routes"] = encoder_routes(cfg)
        calls.take()

        engine_path = os.path.join(ckpt, "blip2")
        if rank == 0:  # the world-1 engine, on rank 0 alone
            handed[:] = list(sp_in["engine_noise"])
            engine = ServingEngine(engine_path, device="cpu", **ENGINE)
            out["engine", "world1"] = {"replies": _replies(engine, sp_in),
                                       "calls": calls.take()}
            engine.close()
        for mesh in MESHES:
            handed[:] = list(sp_in["engine_noise"])
            engine = ServingEngine(engine_path, mesh=mesh, device="cpu",
                                   **ENGINE)
            # each worker issues its model's collectives on groups of its
            # own: (the world, tp, sp), tp None at tp=1
            select, answer = (engine._groups[w][1:] for w in
                              ("select", "answer"))
            assert select[1] is not None and answer[1] is not None, mesh
            assert select[1] is not answer[1], mesh
            assert (select[0] is None) == ("tp=2" not in mesh), mesh
            assert select[0] is None or select[0] is not answer[0], mesh
            replies = None
            if engine.leader:
                replies = _replies(engine, sp_in)
                if mesh == MESHES[0]:
                    out["http"] = http_generate(engine, os.path.join(
                        sp_in["cli"]["video_dir"], "vid_a.mp4"))
                engine.close()
            else:
                engine.join(timeout=WAIT_S)
            out["engine", mesh] = {"replies": replies, "route": engine.route,
                                   "calls": calls.take()}

        starts = []
        step_generator = TI.step_generator
        TI.step_generator = lambda s, k, d: (
            starts.append(k) or step_generator(s, k, d))
        handed[:] = []
        cli_noise = sp_in["cli"]["noise"]

        def select_by_start(self, start_logits, end_logits, video_length,
                            generator=None, **kw):
            kw["noise"] = torch.from_numpy(cli_noise[starts[-1]])
            return choose(self, start_logits, end_logits, video_length,
                          generator, **kw)

        TV.VideoTGB.select_frames = select_by_start
        try:
            for mesh in MESHES:
                starts.clear()
                path = TI.run_inference(TI.parse_args(cli_argv(
                    sp_in, engine_path, os.path.join(ckpt, f"cli_{mesh}"))
                    + ["--mesh", mesh, "--device", "cpu"]))
                if rank == 0:
                    with open(path) as f:
                        out["cli", mesh] = {"rows": f.read(),
                                            "starts": list(starts),
                                            "calls": calls.take()}
        finally:
            TI.step_generator = step_generator
        TV.VideoTGB.select_frames = choose

        from videotgb_torch import train as TTR

        calls.take()
        out["train_cli"] = TTR.main(TRAIN_CLI + [
            "trainer=sp", "trainer.dp=2",
            f"paths.output_dir={os.path.join(ckpt, 'train_sp')}"])
        out["train_cli_calls"] = calls.take()
        out["ranks"] = gather_objects(
            {k: v for k, v in out.items() if k in ("steps", "generate")})
    finally:
        calls.__exit__()
        TV.VideoTGBConfig.tiny, TV.VideoTGB.select_frames = tiny, choose
    return out


def _replies(engine, sp_in) -> list:
    replies = [engine.submit(*r).result(timeout=WAIT_S)
               for r in sp_in["requests"]]
    return [(r.answer, list(r.selected_frames)) for r in replies]


def _model(ckpt: str, cfg):
    from videotgb_torch.models.videotgb import VideoTGB
    from videotgb_torch.training.checkpoint import restore_params

    model = VideoTGB(cfg, device="cpu")
    restore_params(model, os.path.join(ckpt, cfg.backbone))
    return model


def train_steps(sp_in: dict, ckpt: str, rank: int, calls: SPCalls) -> dict:
    """One ``Trainer`` step of SF, E2E, TG and IV (InstructBLIP-Vicuna) at
    ``dp=2, sp=2`` (and, on rank 0, the E2E and TG steps at world 1), each
    from the checkpoint: the step's loss, grad norm and aux, its routes,
    its splits and gathers (``calls``), each trainable gradient's sum of
    squares as the update reads it (summed over the ranks, before the
    clip), and each trainable tensor's sum of squares after the step."""
    import torch

    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.parallel.sharding import shard_batch
    from videotgb_torch.training import trainer as TT
    from videotgb_torch.training.recipes import (E2ERecipe, IVRecipe,
                                                 SFRecipe, TGRecipe)
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    grads: dict = {}
    update = TT.optimizer_step

    def read_grads(optimizer, lr, max_grad_norm):
        for group in optimizer.param_groups:
            for p in group["params"]:  # no gradient: a leaf the loss skips
                grads[id(p)] = (0.0 if p.grad is None
                                else float((p.grad.double() ** 2).sum()))
        return update(optimizer, lr, max_grad_norm)

    def tensors(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    noise = torch.from_numpy(sp_in["train_noise"])
    sf = SFRecipe()
    blip2 = (sp_in["torch_cfg"], tensors(sp_in["train_batch"]))
    cases = {"sf": (functools.partial(sf.loss_fn, deterministic=True,
                                      noise=noise), sf.filter_fn, *blip2),
             "e2e": (E2ERecipe().loss_fn, E2ERecipe().filter_fn, *blip2),
             "tg": (TGRecipe().loss_fn, TGRecipe().filter_fn, *blip2),
             "iv": (IVRecipe().loss_fn, IVRecipe().filter_fn,
                    sp_in["iv_cfg"], tensors(sp_in["iv_batch"]))}
    mesh = create_mesh(MeshConfig(dp=2, sp=2))
    out = {}
    for name, (loss_fn, filter_fn, cfg, batch) in cases.items():
        worlds = [("sp", mesh)] + ([("world1", None)]
                                   if rank == 0 and name in ("e2e", "tg")
                                   else [])
        for world, m in worlds:
            # step 1: step 0 of the warmup has lr 0
            trainer = Trainer(TrainerConfig(max_steps=10, lr=1e-3,
                                            warmup_ratio=0.0), loss_fn,
                              filter_fn, mesh=m)
            state = trainer.init_state(_model(ckpt, cfg))
            state.step = 1
            calls.take()
            grads.clear()
            TT.optimizer_step = read_grads
            try:
                _, metrics = trainer.train_step(
                    state, batch if m is None else shard_batch(batch, m))
            finally:
                TT.optimizer_step = update
            params = {n: p for n, p in state.model.named_parameters()
                      if n in trainer.trainable}
            out[name, world] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: grads[id(p)] for n, p in params.items()},
                "trained": {n: float((p.detach().double() ** 2).sum())
                            for n, p in params.items()},
                "route": trainer.route, "step_route": trainer.step_route,
                "calls": calls.take()}
    return out


def generate(sp_in: dict, ckpt: str, spec: str) -> dict:
    """``generate_blip2`` on this rank's rows at ``spec``: tokens, frames
    and the first decode step's logits."""
    import torch

    from _torch_tp_worker import _first_logits
    from videotgb_torch.evalsuite import inference as TI
    from videotgb_torch.models.videotgb import generate_blip2
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.parallel.sharding import batch_split, shard_batch
    from types import SimpleNamespace

    mesh = TI.serving_mesh(spec, sp_in["torch_cfg"])
    model, _ = TI.load_model(SimpleNamespace(
        model_path=os.path.join(ckpt, "blip2"), preset="tiny",
        backbone="blip2", bf16_params=0), device="cpu", mesh=mesh)
    batch = shard_batch({k: torch.from_numpy(v)
                         for k, v in sp_in["batch"].items()}, mesh)
    noise = torch.from_numpy(sp_in["noise"])
    with torch.no_grad(), batch_split(mesh):
        tokens, cand = generate_blip2(
            model, batch, DecodeConfig(**sp_in["decode"]), noise=noise)
        logits = _first_logits(model, "blip2", batch, noise)
    return {"tokens": tokens, "cand": cand, "logits": logits}


def encoder_routes(cfg) -> dict:
    """The attention route of a T5 encoder pass at 160 tokens (E2E's
    flagship count) and at 96, split over ``sp=2`` by ``shard_sp`` and
    whole (the same weights unsplit): the shapes handed to
    ``flash_attention`` (kernel A on the card), the plain version's
    count."""
    import torch

    from videotgb_torch.models import common
    from videotgb_torch.models.t5 import T5Model
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.parallel.sequence import is_split, shard_sp

    towers = {}
    for name in ("whole", "split"):
        towers[name] = T5Model(cfg.blip2.t5, device="cpu")
        common.init_params(towers[name], 0)
    shard_sp(towers["split"], create_mesh(MeshConfig(dp=2, sp=2)))
    assert is_split(towers["split"]) and not is_split(towers["whole"])
    flash, plain = common.flash_attention, common.dot_product_attention
    seen: list = []
    common.flash_attention = lambda q, k, *a, **kw: (
        seen.append(("flash", q.shape[2], k.shape[2])) or flash(q, k, *a,
                                                                **kw))
    common.dot_product_attention = lambda q, k, *a, **kw: (
        seen.append(("plain", q.shape[2], k.shape[2])) or plain(q, k, *a,
                                                                **kw))
    out = {}
    try:
        for tokens in (160, 96):
            x = torch.randn((1, tokens, cfg.blip2.t5.d_model),
                            generator=torch.Generator().manual_seed(tokens))
            mask = torch.ones((1, tokens))
            for name, t5 in towers.items():
                seen.clear()
                with torch.no_grad():
                    enc = t5.encode(x, mask)
                out[tokens, name] = {"routes": list(seen), "enc": enc}
    finally:
        common.flash_attention, common.dot_product_attention = flash, plain
    return out


# ------------------------------------------- the references at world 1
def write_checkpoint(jmodel, jcfg, ckpt: str) -> dict:
    """The seeded JAX weights (``jax_params``) as a port checkpoint under
    ``ckpt``/<backbone>, for the ranks; returns the parameter tree."""
    import jax

    from _torch_port_helpers import jax_params
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_torch.training.checkpoint import (CheckpointConfig,
                                                    CheckpointManager)

    tree = jax_params(jmodel, jcfg)["params"]
    CheckpointManager(CheckpointConfig(
        directory=os.path.join(ckpt, jcfg.backbone))).save(
        1, {"params": flax_to_state_dict(jax.device_get(tree)), "step": 1})
    return tree


def step_reference(jmodel, tree, name: str, batch: dict,
                   noise=None) -> dict:
    """The JAX step of recipe ``name`` at world 1 (dropout off; for SF the
    handed Gumbel ``noise``): its loss, the aux's mrc loss where it has one,
    the trainable grad norm, and each gradient's sum of squares under the
    port's parameter names. The LLM-only recipes leave out the subtrees
    their loss does not read."""
    import unittest.mock as mock

    import jax
    import jax.numpy as jnp

    from _torch_port_helpers import run_once
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_tpu.training import optim as JO
    from videotgb_tpu.training.recipes import RECIPES

    recipe = RECIPES[name]()
    unread = {"of_extractor"} | ({"temporal_encoder"} if name == "iv"
                                 else set())
    params = {k: v for k, v in tree.items() if k not in unread}
    mask = JO.trainable_mask(params, recipe.filter_fn)

    def gumbel(key, shape, dtype=None):
        return jnp.asarray(noise)

    def loss_fn(p, b):
        p = jax.tree.map(lambda m, x: x if m else jax.lax.stop_gradient(x),
                         mask, p)
        draws = (contextlib.nullcontext() if noise is None
                 else mock.patch.object(jax.random, "gumbel", gumbel))
        with draws:
            loss, aux = recipe.loss_fn(jmodel, p, b, jax.random.key(0),
                                       deterministic=True)
        return loss, aux.get("mrc_loss", loss)

    def step(p, b):
        (loss, mrc), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        grads = jax.tree.map(lambda m, g: g if m else jnp.zeros_like(g),
                             mask, grads)
        leaves = jax.tree.leaves(jax.tree.map(jnp.sum, jax.tree.map(
            jnp.square, grads)))
        return loss, mrc, jnp.sqrt(sum(leaves)), grads

    loss, mrc, gnorm, grads = run_once(step, params, {
        k: jnp.asarray(v) for k, v in batch.items()})
    grads = flax_to_state_dict(jax.device_get(grads))
    return {"loss": float(loss), "mrc_loss": float(mrc),
            "grad_norm": float(gnorm),
            "grads": {n: float((g.double() ** 2).sum())
                      for n, g in grads.items()}}


def generate_reference(jmodel, jcfg, tree, sp_in: dict) -> dict:
    """``generate_blip2`` at world 1 with the handed noise: tokens, frames
    and the first decode step's logits."""
    import unittest.mock as mock

    import jax
    import jax.numpy as jnp

    from _torch_port_helpers import run_once
    from videotgb_tpu.models import videotgb as JV
    from videotgb_tpu.ops.decode import DecodeConfig

    names = ("frames", "flow", "flow_mask", "video_length",
             "sampler_question_ids", "sampler_question_mask",
             "question_ids", "question_mask")
    noise = jnp.asarray(sp_in["noise"])
    dcfg = DecodeConfig(**sp_in["decode"])

    def run(p, bt):
        sel_key, decode_key = jax.random.split(jax.random.key(0))
        v = {"params": p}
        with mock.patch.object(jax.random, "gumbel",
                               lambda k, shape, dtype=None: noise):
            enc, enc_mask, cand = jmodel.apply(
                v, *(bt[n] for n in names), sel_key,
                method=jmodel.prepare_t5_inference)
        tokens = JV.t5_generate_from_encoder(jmodel, v, enc, enc_mask, dcfg,
                                             decode_key)
        start = jnp.full((enc_mask.shape[0], 1),
                         jcfg.blip2.t5.decoder_start_token_id, jnp.int32)
        logits, _ = jmodel.apply(
            v, start, enc, enc_mask,
            method=lambda m, *a: m.model.language_model.decode(*a))
        return tokens, cand, logits[:, 0]

    batch = {k: jnp.asarray(v) for k, v in sp_in["batch"].items()}
    tokens, cand, logits = run_once(run, tree, batch)
    return {"tokens": np.asarray(tokens), "cand": np.asarray(cand),
            "logits": np.asarray(logits)}


def cli_references(sp_in: dict, ckpt: str) -> dict:
    """The JAX QA CLI at world 1 (the ranks hand its draws for each batch
    to the port) and the port's training CLI at world 1 (``trainer=cpu``),
    both on the tiny f32 configs."""
    import pytest

    from _torch_port_helpers import f32_tiny_presets, jax_load_model_seeded
    from videotgb_torch import train as TTR
    from videotgb_tpu.evalsuite import inference as JI

    with pytest.MonkeyPatch.context() as mp:
        f32_tiny_presets(mp)
        mp.setattr(JI, "load_model", jax_load_model_seeded)
        path = JI.run_inference(JI.parse_args(cli_argv(
            sp_in, "random:tiny", os.path.join(ckpt, "cli_jax"))))
        with open(path) as f:
            out = {"cli": f.read()}
        out["train_cli"] = TTR.main(TRAIN_CLI + [
            "trainer=cpu",
            f"paths.output_dir={os.path.join(ckpt, 'train_1')}"])
    return out


def rank_main() -> None:
    import torch

    from videotgb_torch.parallel.distributed import (barrier, initialize,
                                                     is_coordinator)

    torch.set_num_threads(1)
    initialize(device_type="cpu")
    src, ckpt, dst = sys.argv[2:5]
    with open(src, "rb") as f:
        sp_in = pickle.load(f)
    out = rank_checks(sp_in, ckpt)
    if is_coordinator():
        torch.save(out, dst)
    barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rank_main()
