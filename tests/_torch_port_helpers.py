"""Shared set-up of the port's CPU tests: the tiny VideoTGB in f32 on both
sides, with one set of numpy weights made from a seed, given to the JAX
model as its parameter tree and carried across to the port with
``videotgb_torch.convert``."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from videotgb_torch.convert import load_flax_params
from videotgb_torch.models import videotgb as TV
from videotgb_tpu.models import videotgb as JV
from videotgb_tpu.parallel.sharding import param_partition_spec

# the HF models of these tests are PyTorch modules: transformers need not
# import TensorFlow, which is installed here and takes seconds to import
os.environ.setdefault("USE_TF", "0")

TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_parity.py's f32 tolerance
L_FLOW = 3  # flow pairs per clip in the tiny pipeline
B = 2


def _f32(cfg, f32):
    def rep(sub):
        return dataclasses.replace(sub, **f32)

    blip2, iblip = cfg.blip2, cfg.instructblip
    if blip2 is not None:
        blip2 = dataclasses.replace(blip2, vit=rep(blip2.vit),
                                    qformer=rep(blip2.qformer),
                                    t5=rep(blip2.t5))
    if iblip is not None:
        iblip = dataclasses.replace(iblip, vit=rep(iblip.vit),
                                    qformer=rep(iblip.qformer),
                                    llm=rep(iblip.llm))
    return dataclasses.replace(cfg, blip2=blip2, instructblip=iblip,
                               tgb=rep(cfg.tgb))


def jax_tiny_f32(backbone="blip2") -> JV.VideoTGBConfig:
    return _f32(JV.VideoTGBConfig.tiny(backbone),
                dict(dtype=jnp.float32, param_dtype=jnp.float32))


def torch_tiny_f32(backbone="blip2") -> TV.VideoTGBConfig:
    return _f32(TV.VideoTGBConfig.tiny(backbone),
                dict(dtype=torch.float32, param_dtype=torch.float32))


def image_size(cfg) -> int:
    """The ViT input size of either package's config, either backbone."""
    return (cfg.blip2 or cfg.instructblip).vit.image_size


def make_inputs(cfg, seed=0):
    """numpy inputs of the tiny pipeline, made from ``seed``."""
    rng = np.random.default_rng(seed)
    img = image_size(cfg)
    fs = cfg.tgb.flow_size
    return {
        "frames_u8": rng.integers(0, 255, (B, cfg.num_frames, img, img, 3),
                                  np.uint8),
        "flow_u8": rng.integers(0, 255, (B, L_FLOW + 1, fs, fs, 3), np.uint8),
        "flow_mask": np.ones((B, L_FLOW + 2), np.float32),
        "video_length": np.full((B,), L_FLOW, np.int32),
        "sampler_question_ids": rng.integers(4, 60, (B, 5)).astype(np.int32),
        "sampler_question_mask": np.ones((B, 5), np.float32),
        "question_ids": rng.integers(4, 60, (B, 6)).astype(np.int32),
        "question_mask": np.concatenate(
            [np.ones((B, 5), np.float32), np.zeros((B, 1), np.float32)], 1),
    }


def unequal_answer_batch(cfg, inputs, seed=5):
    """A numpy training batch of ``B`` = 2 rows with TG and E2E entries,
    whose answers hold 3 and 5 tokens (``cfg`` either package's tiny
    config, ``inputs`` its :func:`make_inputs`)."""
    rng = np.random.default_rng(seed)
    img, fs = cfg.blip2.vit.image_size, cfg.tgb.flow_size
    answers = rng.integers(2, 60, (B, 5)).astype(np.int32)
    answers[0, 3:] = cfg.blip2.t5.pad_token_id
    return {
        "frames": rng.standard_normal((B, cfg.num_frames, img, img, 3)
                                      ).astype(np.float32),
        "flow": rng.standard_normal((B, L_FLOW, fs, fs, 2)).astype(np.float32),
        "flow_mask": inputs["flow_mask"],
        "video_length": inputs["video_length"],
        "sampler_question_ids": rng.integers(4, 60, (B, 5)).astype(np.int32),
        "sampler_question_mask": inputs["sampler_question_mask"],
        "question_ids": rng.integers(4, 60, (B, 6)).astype(np.int32),
        "question_mask": inputs["question_mask"],
        "answer_ids": answers,
        "starts": np.array([0, 1], np.int32),
        "ends": np.array([2, L_FLOW], np.int32),  # L_FLOW: the ignore index
    }


def handed_gumbel(cfg, seed=11):
    """Gumbel noise (top_k, 2, B, L_FLOW) that a test hands both packages'
    selections."""
    rng = np.random.default_rng(seed)
    return rng.gumbel(size=(cfg.top_k, 2, B, L_FLOW)).astype(np.float32)


def jax_two_steps(jmodel, tree, case, batch, noise, settings):
    """The JAX trainer's first two steps of ``case`` ("tg" on a dp=2 mesh,
    "e2e_tgb" on an fsdp=2 mesh, over the first two CPU devices) on the
    global ``batch``, dropout off, the "tgb" selection reading the handed
    ``noise``. Returns (per-step metrics, the flat parameter tree after
    them). Only the subtrees the recipe's loss reads are given to the
    trainer (flax applies a method on the parameters it uses): TG reads
    the TGB alone, E2E with precomputed flow all but RAFT; the others
    would only pass through the optimizer's frozen mask."""
    import unittest.mock as mock

    from flax.traverse_util import flatten_dict
    from jax.sharding import NamedSharding, PartitionSpec

    from videotgb_tpu.parallel.mesh import MeshConfig
    from videotgb_tpu.training import recipes as JR
    from videotgb_tpu.training import trainer as JTR

    jrecipe = (JR.TGRecipe() if case == "tg" else
               JR.E2ERecipe(selection="tgb"))
    mesh = MeshConfig(dp=2) if case == "tg" else MeshConfig(dp=1, fsdp=2)
    noise = jnp.asarray(noise)

    def loss_fn(p, b, k):
        with mock.patch.object(jax.random, "gumbel",
                               lambda key, shape, dtype=None: noise):
            return jrecipe.loss_fn(jmodel, p, b, k, deterministic=True)

    trainer = JTR.Trainer(JTR.TrainerConfig(**settings, mesh=mesh), loss_fn,
                          filter_fn=jrecipe.filter_fn)
    used = (("temporal_encoder",) if case == "tg" else
            tuple(k for k in tree if k != "of_extractor"))
    state = trainer.init_state({k: jax.tree.map(jnp.array, tree[k])
                                for k in used})
    rep = NamedSharding(trainer.mesh, PartitionSpec())
    state = JTR.TrainState(*(jax.device_put(x, rep) for x in (
        state.params, state.opt_state, state.step)))
    steps = []
    for _ in range(2):
        state, metrics = trainer.train_step(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        steps.append({k: float(v) for k, v in metrics.items()})
    return steps, flatten_dict(jax.tree.map(np.array, state.params))


def random_tree(shapes, seed=0):
    """numpy weights for a flax shape tree: O(1) activations (lecun-scaled
    kernels), norms near identity, positive batch-norm variances."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in sorted(flatten_dict(shapes).items()):
        shape, leaf = tuple(sds.shape), path[-1]
        normal = rng.standard_normal(shape).astype(np.float32)
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            value = normal / np.sqrt(fan_in)
        elif leaf == "scale":
            value = 1.0 + 0.1 * normal
        elif leaf == "var":
            value = 1.0 + 0.1 * np.abs(normal)
        elif leaf in ("bias", "mean"):
            value = 0.1 * normal
        elif leaf in ("lora_a", "lora_b"):  # a delta of O(1) next to W x
            value = 0.1 * normal
        else:  # embeddings, bos/eos, cls/position/query tokens, rel bias
            value = 0.5 * normal
        out[path] = np.asarray(value, np.float32)
    return unflatten_dict(out)


_PARAM_SHAPES: dict = {}
_PARAM_SPECS: dict = {}


def jax_params(jmodel, jcfg, seed=0):
    """numpy weights from ``seed`` for the JAX VideoTGB ``jmodel``, as the
    ``{"params": ...}`` tree of jnp arrays (shapes from ``jax.eval_shape``
    of its ``init_pipeline``: nothing is compiled). The shapes, a function
    of the config alone, are traced once per config; the arrays are new on
    every call (a JAX trainer may donate them)."""
    if jcfg not in _PARAM_SHAPES:
        fs = jcfg.tgb.flow_size
        img = image_size(jcfg)
        x = make_inputs(jcfg, 0)
        args = (jnp.zeros((1, jcfg.num_frames, img, img, 3)),
                jnp.zeros((1, L_FLOW, fs, fs, 2)),
                *(jnp.asarray(x[k][:1]) for k in (
                    "flow_mask", "video_length", "sampler_question_ids",
                    "sampler_question_mask", "question_ids",
                    "question_mask")))
        shapes = jax.eval_shape(
            lambda k: jmodel.init(k, *args, k, method=jmodel.init_pipeline),
            jax.random.key(0))
        _PARAM_SHAPES[jcfg] = nn.meta.unbox(shapes)["params"]
        _PARAM_SPECS[jcfg] = param_partition_spec(shapes["params"])
    tree = random_tree(_PARAM_SHAPES[jcfg], seed)
    return {"params": jax.tree.map(jnp.asarray, tree)}


def jax_param_specs(jmodel, jcfg):
    """The JAX package's ``PartitionSpec`` tree of ``jmodel``'s parameters
    (``param_partition_spec`` of their annotations)."""
    jax_params(jmodel, jcfg)
    return _PARAM_SPECS[jcfg]


def jax_with_lora(cfg, rank):
    """The JAX config with LoRA adapters of ``rank`` on its LLM, as the JAX
    CLI's ``build_model`` and ``load_model(--lora)`` make it."""
    if cfg.backbone == "blip2":
        t5 = dataclasses.replace(cfg.blip2.t5, lora_rank=rank)
        return dataclasses.replace(
            cfg, blip2=dataclasses.replace(cfg.blip2, t5=t5))
    llm = dataclasses.replace(cfg.instructblip.llm, lora_rank=rank)
    return dataclasses.replace(
        cfg, instructblip=dataclasses.replace(cfg.instructblip, llm=llm))


class Pair:
    """The tiny JAX VideoTGB with its params, and the port's VideoTGB on the
    CPU with the same weights (with LoRA adapters of ``lora_rank`` on the
    LLM when it is not 0)."""

    def __init__(self, seed=0, backbone="blip2", lora_rank=0):
        self.jcfg = jax_tiny_f32(backbone)
        self.tcfg = torch_tiny_f32(backbone)
        if lora_rank:
            self.jcfg = jax_with_lora(self.jcfg, lora_rank)
            self.tcfg = TV.with_lora(self.tcfg, lora_rank)
        self.jmodel = JV.VideoTGB(self.jcfg)
        self.inputs = make_inputs(self.jcfg, seed)
        self.params = jax_params(self.jmodel, self.jcfg, seed)
        self.tree = jax.tree.map(np.array, self.params["params"])
        self.tmodel = TV.VideoTGB(self.tcfg, device="cpu")
        load_flax_params(self.tmodel, self.tree)

    def japply(self, fn, *args):
        """jit-run ``fn(module, *args)`` inside the JAX model's apply."""
        return jax.jit(lambda p, *a: self.jmodel.apply(p, *a, method=fn))(
            self.params, *args)


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(got, want, **tol):
    tol = tol or TOL
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The tiny shapes gain nothing from many intra-op threads; two keep the
    port's tests from crowding the other test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def cheap_jax_compiles():
    """A port test runs each JAX reference program once or a few times, so
    compiling it costs more than running it: XLA's cheapest CPU level
    (``jax_disable_most_optimizations``: LLVM at level 0 without its
    expensive passes, as ``CHEAP_COMPILE``) compiles the tiny programs in
    about a third less time, inside the JAX package's own jits too. Set
    for the module's tests and restored after them."""
    from jax._src import compiler

    before = compiler._DISABLE_MOST_OPTIMIZATIONS.value
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def jax_load_model_seeded(args, with_specs=False):
    """Stands in for ``videotgb_tpu.evalsuite.inference.load_model`` on
    ``random:<preset>``: the same config (``nframe``, ``flow_size``, and
    ``bf16_param_config`` under ``bf16_params``), weights from
    :func:`jax_params` in place of flax's ``init``, which compiles some 800
    small programs on the CPU; under ``bf16_params`` the JAX package's own
    ``bf16_residency`` then casts every f32 leaf to bf16, as its
    ``load_model`` does. ``with_specs`` adds the parameters'
    ``PartitionSpec`` tree, which a ``--mesh`` run places them by."""
    from videotgb_tpu.evalsuite.inference import bf16_residency

    assert args.model_path.startswith("random:")
    bf16 = getattr(args, "bf16_params", False)
    cfg = getattr(JV.VideoTGBConfig, args.model_path.split(":", 1)[1])(
        getattr(args, "backbone", "blip2"))
    nframe = getattr(args, "nframe", None)
    if nframe and nframe != cfg.nframe:
        cfg = dataclasses.replace(cfg, nframe=nframe)
    if getattr(args, "flow_size", None):
        cfg = dataclasses.replace(
            cfg, tgb=dataclasses.replace(cfg.tgb, flow_size=args.flow_size))
    if bf16:
        cfg = JV.bf16_param_config(cfg)
    model = JV.VideoTGB(cfg)
    params = jax_params(model, cfg)
    if bf16:
        params = bf16_residency(params)
    if with_specs:
        return model, params, cfg, jax_param_specs(model, cfg)
    return model, params, cfg


def f32_tiny_presets(monkeypatch):
    """Both packages' ``tiny`` preset in f32 compute and parameters."""
    j_tiny, t_tiny = JV.VideoTGBConfig.tiny, TV.VideoTGBConfig.tiny
    monkeypatch.setattr(JV.VideoTGBConfig, "tiny", classmethod(
        lambda cls, backbone="blip2": _f32(
            j_tiny(backbone), dict(dtype=jnp.float32,
                                   param_dtype=jnp.float32))))
    monkeypatch.setattr(TV.VideoTGBConfig, "tiny", classmethod(
        lambda cls, backbone="blip2": _f32(
            t_tiny(backbone), dict(dtype=torch.float32,
                                   param_dtype=torch.float32))))


def gumbel_like(key, start_logits, top_k):
    """The JAX selection's Gumbel draws from ``key`` for these (B, L)
    logits, (top_k, 2, B, L)."""
    shape = (top_k, 2, *start_logits.shape)
    return torch.from_numpy(np.array(
        jax.random.gumbel(key, shape, jnp.float32)))


# each JAX program of a parity test runs once: XLA's cheapest CPU
# optimisation level compiles it in about a third less time
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def run_once(fn, *args):
    """jit ``fn``, compile it with ``CHEAP_COMPILE`` and call it."""
    return jax.jit(fn).lower(*args).compile(CHEAP_COMPILE)(*args)


def grads_against_jax(pair, jloss, tloss, filters, batch, unread=()):
    """``jloss(params, batch) -> (loss, aux)`` under ``jax.value_and_grad``
    with the JAX trainer's freeze (stop_gradient on frozen leaves) against
    ``tloss(model, batch) -> (loss, aux)`` backpropagated in a fresh port
    model: the loss and the gradient of every trainable parameter at 2e-4,
    no gradient on a frozen one. ``filters`` is the (JAX, port) pair of
    freeze filters. ``unread`` names top-level subtrees the JAX loss does
    not read (flax applies a method on the parameters it uses, and raises
    on one it lacks): its program leaves them out, which only saves
    compile time. Returns (the port's trainable names, JAX aux, port
    aux)."""
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_torch.training import optim as TO
    from videotgb_tpu.training import optim as JO

    params = {k: v for k, v in pair.params["params"].items()
              if k not in unread}
    mask = JO.trainable_mask(params, filters[0])

    def frozen(p, b):
        p = jax.tree.map(lambda m, x: x if m else jax.lax.stop_gradient(x),
                         mask, p)
        return jloss(p, b)

    (loss_j, aux_j), grads_j = run_once(
        jax.value_and_grad(frozen, has_aux=True), params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    grads_j = flax_to_state_dict(jax.device_get(grads_j))
    model = load_flax_params(TV.VideoTGB(pair.tcfg, device="cpu"), pair.tree)
    _, names = TO.make_optimizer(model, filter_fn=filters[1])
    loss, aux = tloss(model, {k: t(v) for k, v in batch.items()})
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
    return names, aux_j, aux


def write_stage3_media(root, size=(64, 48), frames=20):
    """A stage-3 ``text_dir`` under ``root`` (a ``pathlib.Path``), made from
    a seed: a JPEG, an mp4 (mp4v) of ``frames`` frames, {train,val}.json
    with image, video (one cropped by pseudo_label.json, one by its own
    ``pseudo_label``) and text-only rows, pseudo_label.json and
    nlp_tune.json (one text-only row). Returns the train rows."""
    import json

    import cv2

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    w, h = size
    cv2.imwrite(str(root / "pic.jpg"),
                rng.integers(0, 255, (h, w, 3), np.uint8))
    writer = cv2.VideoWriter(str(root / "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (h, w, 3), np.uint8))
    writer.release()

    def conv(q, a):
        return [{"from": "human", "value": q}, {"from": "gpt", "value": a}]

    rows = [
        {"id": "i0", "image": "pic.jpg",
         "conversations": conv("<image>\nwhat is this?", "a picture")},
        {"id": "v0", "video": "clip.mp4",
         "conversations": conv("<video>\nwhat happens?", "things move")},
        {"id": "v1", "video": "clip.mp4", "pseudo_label": [0.5, 0.9],
         "conversations": conv("<video>\nand later?", "they stop") * 2},
        {"id": "t0", "conversations": conv("just text", "sure")},
    ]
    (root / "train.json").write_text(json.dumps(rows))
    (root / "val.json").write_text(json.dumps(rows[:2]))
    (root / "pseudo_label.json").write_text(json.dumps({"v0": [0.25, 0.75]}))
    (root / "nlp_tune.json").write_text(json.dumps([rows[3]]))
    return rows
