"""Shared set-up of the port's CPU tests: the tiny VideoTGB in f32 on both
sides, with one set of numpy weights made from a seed, given to the JAX
model as its parameter tree and carried across to the port with
``videotgb_torch.convert``."""

from __future__ import annotations

import dataclasses

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

TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_parity.py's f32 tolerance
L_FLOW = 3  # flow pairs per clip in the tiny pipeline
B = 2


def _f32(cfg, f32):
    b = cfg.blip2
    blip2 = dataclasses.replace(
        b, vit=dataclasses.replace(b.vit, **f32),
        qformer=dataclasses.replace(b.qformer, **f32),
        t5=dataclasses.replace(b.t5, **f32))
    return dataclasses.replace(cfg, blip2=blip2,
                               tgb=dataclasses.replace(cfg.tgb, **f32))


def jax_tiny_f32() -> JV.VideoTGBConfig:
    return _f32(JV.VideoTGBConfig.tiny(),
                dict(dtype=jnp.float32, param_dtype=jnp.float32))


def torch_tiny_f32() -> TV.VideoTGBConfig:
    return _f32(TV.VideoTGBConfig.tiny(),
                dict(dtype=torch.float32, param_dtype=torch.float32))


def make_inputs(cfg, seed=0):
    """numpy inputs of the tiny pipeline, made from ``seed``."""
    rng = np.random.default_rng(seed)
    img = cfg.blip2.vit.image_size
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
        else:  # embeddings, bos/eos, cls/position/query tokens, rel bias
            value = 0.5 * normal
        out[path] = np.asarray(value, np.float32)
    return unflatten_dict(out)


class Pair:
    """The tiny JAX VideoTGB with its params, and the port's VideoTGB on the
    CPU with the same weights."""

    def __init__(self, seed=0):
        self.jcfg = jax_tiny_f32()
        self.tcfg = torch_tiny_f32()
        self.jmodel = JV.VideoTGB(self.jcfg)
        self.inputs = make_inputs(self.jcfg, seed)
        x = self.inputs
        fs = self.jcfg.tgb.flow_size
        img = self.jcfg.blip2.vit.image_size
        args = (jnp.zeros((1, self.jcfg.num_frames, img, img, 3)),
                jnp.zeros((1, L_FLOW, fs, fs, 2)),
                *(jnp.asarray(x[k][:1]) for k in (
                    "flow_mask", "video_length", "sampler_question_ids",
                    "sampler_question_mask", "question_ids",
                    "question_mask")))
        shapes = jax.eval_shape(
            lambda k: self.jmodel.init(k, *args, k,
                                       method=self.jmodel.init_pipeline),
            jax.random.key(0))
        self.tree = random_tree(nn.meta.unbox(shapes)["params"], seed)
        self.params = {"params": jax.tree.map(jnp.asarray, self.tree)}
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
