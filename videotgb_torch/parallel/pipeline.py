"""Pipeline parallelism over the mesh's ``pp`` axis (counterpart of
``videotgb_tpu/parallel/pipeline.py``: ``pipeline_apply``,
``active_pp_mesh`` and ``place_pipeline_params``).

The JAX package splits the stacked layers of a ``scan_layers`` tower into
contiguous stages over ``pp`` (stage s holds layers [s L/pp, (s+1) L/pp))
and streams microbatches through them with ``ppermute`` hops, a GPipe
schedule inside one ``shard_map``. Here each rank is one process:

* :func:`shard_pp` stages every ``scan_layers`` tower of a model (the T5
  encoder and decoder stacks, LLaMA's layers; the port keeps per-layer
  ``layers.{i}`` parameters, and the flag means "this stack may be
  staged"): each rank keeps its stage's layer tensors and frees the
  others' (:func:`place_pipeline_params`), and the tower holds a
  :class:`PPGroup`, which its passes without caches ask for
  (:func:`active_pp_mesh`) as they ask ``self.sp``;
* :func:`pipeline_apply` runs the schedule: M microbatches of this rank's
  rows (M = pp by default; only the dp x fsdp ranks split the batch), all
  forwards, then all backwards, inside one ``torch.autograd.Function``.
  At time step t stage s runs microbatch t - s through its layers and
  hands its activation to stage s + 1; the backward runs the microbatches
  the other way, stage s handing the gradient of its input to stage s - 1.
  The side inputs (biases, rotary tables, the encoder states) are on
  every rank already and do not hop. The last stage's output is delivered
  to every pp rank (an all-reduce in which the other stages add zeros, the
  JAX "collect" psum), so each rank reads the whole output. Unlike the
  JAX scan, no stage computes the garbage microbatches of the bubble;
* **the hop** is built from ``all_gather_into_tensor`` over the pp group:
  each rank contributes its block and keeps its predecessor's (forward)
  or its successor's (backward), a ring permute. NCCL refuses two ranks on
  one card, gloo's ``send``/``recv`` are documented for CPU tensors only,
  and gloo's ``all_gather_into_tensor`` carries CUDA tensors through the
  host (``chip_smoke.py`` phase 23 and 24 confirm it first); the same
  collective runs over NCCL on separate cards. It moves pp times the
  bytes a point-to-point hop would.

**Gradients follow the rule of ``parallel/sequence.py``.** Every rank
computes its loss from the delivered output as its share (the global
count of valid entries counts each row once per pp rank), so the sum over
the world of every rank's gradient is the global batch's. Inside the
pipeline the backward first sums the ranks' shares of the output's
gradient over the pp group; each stage then holds its layers' whole
gradient for its position's rows (the trainer sums those over the dp
ranks only), stage 0 returns the whole gradient of the input and the
other stages zeros, and every stage returns its own layers' part of each
side input's gradient (T5's relative-position table is read by every
layer). The trainer's sum over the world of the replicated parameters'
gradients then counts each once.

Nothing here catches a failed collective: a hop that fails raises.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable

import torch
import torch.distributed as dist

from videotgb_torch.parallel.mesh import PIPELINE_AXIS, pp_rank
from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.pipeline")


class PPGroup:
    """One rank's place on the ``pp`` axis: its stage ``rank``, the
    axis's ``size``, the axis's process group, and ``calls``, the count of
    each route the towers' passes took ("staged", or "staged, one
    microbatch" where the rows do not divide into M microbatches)."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.group = rank, size, group
        self.calls: collections.Counter = collections.Counter()

    def stage(self, n_layers: int) -> range:
        """The layers of this rank's stage out of ``n_layers``."""
        if n_layers % self.size:
            raise ValueError(
                f"{n_layers} layers not divisible by pp={self.size}")
        per = n_layers // self.size
        return range(self.rank * per, (self.rank + 1) * per)


def _hop(x: torch.Tensor, pp: PPGroup, shift: int) -> torch.Tensor:
    """The block of the rank ``shift`` stages before this one (a ring
    permute), from an all-gather of every rank's ``x`` over the pp
    group."""
    x = x.contiguous()
    out = x.new_empty((pp.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pp.group)
    src = (pp.rank - shift) % pp.size
    return out.narrow(0, src * x.shape[0], x.shape[0])


class _Schedule:
    """What one :func:`pipeline_apply` call runs: the stage's layers, the
    layer function, the pp group and the microbatch count."""

    def __init__(self, layer_fn, layers, pp: PPGroup, m: int):
        self.layer_fn, self.pp, self.m = layer_fn, pp, m
        self.layers = [layers[i] for i in pp.stage(len(layers))]
        self.saved: list = []

    def stage(self, h, sides):
        tree = (h, *sides)
        for layer in self.layers:
            tree = self.layer_fn(layer, tree)
        return tree[0]

    def forward(self, x, sides, needs_x, needs_sides, grad: bool):
        """The forward schedule; returns the last stage's output on every
        rank. With ``grad`` each microbatch's graph is kept."""
        pp, m = self.pp, self.m
        s, last = pp.rank, pp.size - 1
        mb = x.shape[0] // m
        self.saved = [None] * m
        outs = [None] * m
        recv = None
        for t in range(m + last):
            i, send = t - s, None
            if 0 <= i < m:
                h = x.narrow(0, i * mb, mb) if s == 0 else recv
                local = [a.narrow(0, i * mb, mb) for a in sides]
                if grad:
                    with torch.enable_grad():
                        h = h.detach().requires_grad_(s > 0 or needs_x)
                        local = [a.detach().requires_grad_(need)
                                 for a, need in zip(local, needs_sides)]
                        out = self.stage(h, local)
                    self.saved[i] = (h, local, out)
                else:
                    out = self.stage(h, local)
                send = out.detach()
                if s == last:
                    outs[i] = send
            if t < m + last - 1:
                recv = _hop(send if send is not None else x.new_zeros(
                    (mb, *x.shape[1:])), pp, 1)
        y = torch.cat(outs) if s == last else x.new_zeros(x.shape)
        dist.all_reduce(y, group=pp.group)
        return y

    def backward(self, dy, x, sides, needs_x, needs_sides, params):
        """The backward schedule on the output's gradient (this rank's
        share); returns (the input's gradient, the side inputs', the stage
        parameters')."""
        pp, m = self.pp, self.m
        s, last = pp.rank, pp.size - 1
        mb = x.shape[0] // m
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=pp.group)  # the pp ranks' shares
        dx = [None] * m
        dsides = [[None] * m for _ in sides]
        dparams = [None] * len(params)
        recv = None
        for t in range(m + last):
            i, send = t - (last - s), None
            if 0 <= i < m:
                g = dy.narrow(0, i * mb, mb) if s == last else recv
                h, local, out = self.saved[i]
                self.saved[i] = None
                wants = ([h] if h.requires_grad else []) + [
                    a for a in local if a.requires_grad] + list(params)
                grads = list(torch.autograd.grad(out, wants, g,
                                                 allow_unused=True)
                             if wants else [])
                if h.requires_grad:
                    send = grads.pop(0)
                    if send is None:
                        send = torch.zeros_like(h)
                    if s == 0:
                        dx[i] = send
                for j, a in enumerate(local):
                    if a.requires_grad:
                        dsides[j][i] = grads.pop(0)
                for j, gp in enumerate(grads):
                    if gp is not None:
                        dparams[j] = gp if dparams[j] is None else (
                            dparams[j] + gp)
            if t < m + last - 1:
                recv = _hop(send if send is not None else x.new_zeros(
                    (mb, *x.shape[1:])), pp, -1)
        self.saved = []

        def whole(parts, like):
            return torch.cat([torch.zeros_like(like.narrow(0, i * mb, mb))
                              if p is None else p
                              for i, p in enumerate(parts)])

        gx = None
        if needs_x:
            gx = whole(dx, x) if s == 0 else torch.zeros_like(x)
        gsides = [whole(parts, a) if need else None
                  for parts, a, need in zip(dsides, sides, needs_sides)]
        return gx, gsides, dparams


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: inputs (the activation, the side
    inputs, the stage's parameters that take a gradient, a token that
    keeps the node in every rank's graph), output the last stage's."""

    @staticmethod
    def forward(ctx, sched, n_sides, x, *rest):
        sides, params = rest[:n_sides], rest[n_sides:-1]
        ctx.sched = sched
        ctx.needs = (ctx.needs_input_grad[2],
                     list(ctx.needs_input_grad[3:3 + n_sides]))
        ctx.inputs = (x, sides, params)
        return sched.forward(x, sides, *ctx.needs, grad=True)

    @staticmethod
    def backward(ctx, dy):
        x, sides, params = ctx.inputs
        gx, gsides, gparams = ctx.sched.backward(dy, x, sides, *ctx.needs,
                                                 params)
        ctx.inputs = None
        return (None, None, gx, *gsides, *gparams, None)


def pipeline_apply(layer_fn: Callable[[Any, tuple], tuple], layers,
                   tree, pp: PPGroup, microbatches: int | None = None):
    """Apply the L layers of ``layers`` (an ``nn.ModuleList``) to ``tree``
    pipelined over ``pp`` (a group above size 1: the towers run their
    stacks sequentially without one).

    ``layer_fn(layer, tree) -> tree`` applies one layer. ``tree`` is the
    activation (B, ...) or a tuple of it and its side inputs, each with a
    leading batch dim B (this rank's rows): the side inputs pass through
    unchanged, and only the activation hops between stages. B %
    microbatches == 0, and microbatches defaults to the pipeline depth.
    Stage s runs layers [s L/pp, (s+1) L/pp) and holds only those
    (:func:`place_pipeline_params`). Returns the output tree, the
    activation delivered to every pp rank. Under grad mode the schedule is
    one autograd node whose backward is the backward schedule (a
    collective: every pp rank backpropagates through it)."""
    single = torch.is_tensor(tree)
    tree = (tree,) if single else tuple(tree)
    x, sides = tree[0], tree[1:]
    m = microbatches or pp.size
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"microbatches={m}")
    sched = _Schedule(layer_fn, layers, pp, m)
    if torch.is_grad_enabled():
        params = [p for layer in sched.layers for p in layer.parameters()
                  if p.requires_grad]
        token = torch.empty(0, requires_grad=True)
        y = _Pipeline.apply(sched, len(sides), x, *sides, *params, token)
    else:
        y = sched.forward(x, sides, False, [False] * len(sides), grad=False)
    return y if single else (y, *sides)


def active_pp_mesh(tower) -> PPGroup | None:
    """The tower's ``pp`` group when its passes without caches are staged
    (:func:`shard_pp` set one above size 1 on a ``scan_layers`` tower),
    else None (the towers ask it as ``models/llama.py`` and
    ``models/t5.py`` of the JAX package ask for the ambient mesh)."""
    pp = getattr(tower, "pp", None)
    if pp is None or pp.size == 1 or not tower.config.scan_layers:
        return None
    return pp


def stage_stack(tower, layers, layer_fn, tree: tuple) -> torch.Tensor:
    """A tower's staged pass: its side inputs broadcast to the
    activation's leading batch dim (as the JAX towers do), M = pp
    microbatches, or one where the rows do not divide by pp (where the
    JAX tower goes sequential, ``videotgb_tpu/models/llama.py:193-199``:
    the same numbers, without gathering the other stages' layers). Counts
    the route on the group and logs it the first time. Returns the
    activation."""
    pp = tower.pp
    b = tree[0].shape[0]
    tree = tuple(a if a.shape[0] == b else a.expand(b, *a.shape[1:])
                 for a in tree)
    m = pp.size if b % pp.size == 0 else 1
    route = "staged" if m > 1 else "staged, one microbatch"
    if not pp.calls[route]:
        log.info("%s: %d layers staged over pp=%d, %d microbatch(es) of %d "
                 "rows (%s)", type(tower).__name__, len(layers), pp.size, m,
                 b // m, route)
    pp.calls[route] += 1
    return pipeline_apply(layer_fn, layers, tree, pp, m)[0]


# ------------------------------------------------------------- placement
def staged_stacks(tower) -> dict:
    """The ``nn.ModuleList`` layer stacks of a tower that stage, by name:
    T5's encoder and decoder blocks, LLaMA's layers."""
    return {name: getattr(tower, name) for name in (
        "encoder_blocks", "decoder_blocks", "layers") if hasattr(tower, name)}


def place_pipeline_params(layers, pp: PPGroup) -> range:
    """Stage ``layers`` over ``pp``: every layer's parameters are marked
    with their stage (``pp_stage``), their shape (``pp_shape``) and
    whether this rank holds them (``pp_held``); the other stages' tensors
    are freed on this rank (left zero-sized). ``len(layers) % pp.size``
    must be 0 (``ValueError``, the JAX message). Returns this rank's
    layers."""
    mine = pp.stage(len(layers))
    per = len(mine)
    for i, layer in enumerate(layers):
        for p in layer.parameters():
            p.pp_stage, p.pp_shape = i // per, tuple(p.shape)
            p.pp_held = i in mine
            if not p.pp_held:
                p.data = p.data.new_empty(0)
    return mine


def towers(model: torch.nn.Module) -> list:
    """The towers whose stacks stage: T5 and LLaMA."""
    from videotgb_torch.models.llama import LlamaModel
    from videotgb_torch.models.t5 import T5Model

    return [m for m in model.modules() if isinstance(m, (T5Model,
                                                         LlamaModel))]


def is_staged(model: torch.nn.Module) -> bool:
    """Whether :func:`shard_pp` staged a tower of ``model`` (it then runs
    eagerly: ``utils/graphs.py``)."""
    return getattr(model, "pp", None) is not None


def shard_pp(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Stage every ``scan_layers`` tower of ``model`` over this rank's
    place on ``mesh``'s ``pp`` axis (nothing at pp = 1): its stacks'
    layers are placed (:func:`place_pipeline_params`) and it takes the
    :class:`PPGroup`. A model with no such tower stays whole on every pp
    rank, as the JAX package's pp axis leaves an unscanned tower
    sequential."""
    rank, size = pp_rank(mesh)
    if size == 1:
        return model
    if is_staged(model):
        raise ValueError("shard_pp: the model is staged already")
    pp = PPGroup(rank, size, mesh.get_group(PIPELINE_AXIS))
    staged = [t for t in towers(model) if t.config.scan_layers]
    mine = {}
    for tower in staged:
        for name, stack in staged_stacks(tower).items():
            held_layers = place_pipeline_params(stack, pp)
            mine[f"{type(tower).__name__}.{name}"] = list(held_layers)
        tower.pp = pp
    if staged:
        model.pp = pp
        log.info("pp rank %d of %d holds layers %s", rank, size, mine)
    else:
        log.info("pp=%d: no scan_layers tower, so every pp rank holds the "
                 "whole model", size)
    return model


def held(p: torch.Tensor) -> bool:
    """Whether this rank holds parameter ``p`` (every parameter but the
    other stages' layers)."""
    return getattr(p, "pp_held", True)


def stage_leaf(p: torch.Tensor) -> bool:
    """Whether ``p`` belongs to a staged layer (held by one pp rank)."""
    return hasattr(p, "pp_stage")


def from_owner(p: torch.Tensor, pp: PPGroup, t: torch.Tensor | None = None,
               like: torch.Tensor | None = None) -> torch.Tensor:
    """Stage leaf ``p``'s tensor on every rank of ``pp``, from the rank that
    holds ``p``: ``t`` there (``p`` itself by default; an Adam moment of
    ``p``, or its 0-dim step), shaped and typed as ``p`` or as ``like`` (a
    0-dim ``like`` keeps its shape). A collective: an all-gather in which
    the other ranks contribute zeros."""
    like = p if like is None else like
    shape = like.shape if like.dim() == 0 else p.pp_shape
    if not p.pp_held:
        t = torch.zeros(shape, dtype=like.dtype, device=p.device)
    t = (p.data if t is None else t).detach().to(p.device)
    t = t.reshape(-1).contiguous()
    out = t.new_empty(pp.size * t.numel())
    dist.all_gather_into_tensor(out, t, group=pp.group)
    return out.narrow(0, p.pp_stage * t.numel(), t.numel()).reshape(shape)


@contextlib.contextmanager
def whole_stages(model: torch.nn.Module, why: str):
    """Within the block every rank holds every layer of ``model``'s staged
    towers, gathered from their stages, and the towers run sequentially
    (the JAX trainer's evals run outside the mesh: the whole stack on
    one device); after it the other stages' tensors are freed again. A
    collective over the pp group; ``why`` names the pass in the log."""
    if not is_staged(model):
        yield model
        return
    pp = model.pp
    log.info("%s: the pp stages gathered whole on every rank", why)
    staged = [t for t in towers(model) if getattr(t, "pp", None) is pp]
    freed = []
    with torch.no_grad():
        for tower in staged:
            for stack in staged_stacks(tower).values():
                for layer in stack:
                    for p in layer.parameters():
                        whole = from_owner(p, pp)
                        if not p.pp_held:
                            p.data = whole
                            freed.append(p)
            tower.pp = None
    try:
        yield model
    finally:
        for p in freed:
            p.data = p.data.new_empty(0)
        for tower in staged:
            tower.pp = pp
