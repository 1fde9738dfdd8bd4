"""Sequence parallelism over the mesh's ``sp`` axis (the counterpart of the
``sp`` part of ``videotgb_tpu/parallel/sharding.py::constrain_batch``,
Megatron-SP over GSPMD).

The JAX package pins every (B, T, D) residual stream between transformer
layers to ``sp`` along T where T divides by ``sp``, and GSPMD inserts an
all-gather into each attention and a reduce-scatter after it. Here each
rank is one process and the collectives are explicit. A tower that holds
an :class:`SPGroup` (set by :func:`shard_sp`) does at its JAX call sites:

* **split** (:meth:`SPGroup.split`): a stream that :meth:`SPGroup.splits`
  (3-D, T divisible by ``sp``) is narrowed to this rank's T/sp tokens at
  :meth:`SPGroup.offset`; every rank computed it whole before, so nothing
  is communicated. A stream that does not split (a decode step's T = 1,
  an odd token count) stays whole on every rank, as the JAX constraint
  skips it;
* **token-local layers** (norms, dense layers, MLPs) run on the rank's
  tokens;
* **attention**: the queries are the rank's tokens, at their global
  positions (their rows of the bias, their rotary angles), and the keys
  and values come from the stream gathered whole (:meth:`SPGroup.gather`:
  ``all_gather_into_tensor`` forward, ``reduce_scatter_tensor`` backward);
  the flash dispatch rule reads the global query count, as JAX's does on
  its global shapes;
* **the end of the stack** gathers the stream, so whatever reads it after
  (the TGB's MRC head, the T5 decoder's cross-attention, an LM head, a
  loss) reads it whole, as every reader of a JAX global array does. A
  stream read only as keys and values (the TGB's question text, the T5
  encoder output in the decoder) is never split.

Dropout masks are drawn on whole streams, before a split: each ``sp`` rank
of a dp x fsdp position draws the same mask from the same generator, and
that mask is world 1's (``parallel.sharding.global_draw`` over the batch
rows). Kernel D's Philox counter starts at the position's first row
(``parallel.sharding.row_offset``), so the ``sp`` ranks select alike.

**Gradients: every rank's backward is its share, and shares are summed
over the whole world.** The ``sp`` ranks of one position compute its loss
whole, each divided by the count of valid entries summed over every rank
of the world (``parallel.sharding.global_count``, which counts each row
once per ``sp`` rank), so each rank's loss is 1/sp of its position's. Then:

* a gradient that reaches a gather is a share; the gather's backward, a
  reduce-scatter, sums the ``sp`` ranks' shares and keeps this rank's
  tokens, so below the gather each rank holds the whole gradient of its
  own tokens;
* a token-local parameter's gradient on a rank is its tokens' part, an
  attention's key and value projections' the rank's queries' part, a
  parameter above a split (the Q-Former before the T5 encoder) the part
  its tokens carried (a split's backward is zero outside them), and a
  parameter after the last gather (an LM head) 1/sp of the whole;
* so the sum over the ``sp`` ranks of every gradient is the position's,
  and the trainer's one sum of the gradients, the loss and the aux
  scalars over the world (``parallel.sharding.all_reduce_sum``) is the
  global batch's, as on the dp route.

The collectives are plain ``dist.all_gather_into_tensor`` and
``dist.reduce_scatter_tensor`` (DTensor's functional collectives end the
process with a segmentation fault over gloo on CUDA tensors:
``parallel/sharding.py::full_tensor``). No path catches a failed
collective.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from videotgb_torch.parallel.mesh import SEQUENCE_AXIS, sp_rank


class SPGroup:
    """One rank's place on the ``sp`` axis: its index ``rank``, the axis's
    ``size``, and the process group its collectives run on, the mesh's
    ``sp`` group unless the calling thread named another with
    :meth:`using` (the serving engine's two workers each have one, so that
    their collectives never interleave on one group)."""

    def __init__(self, rank: int, size: int, group):
        self.rank, self.size, self.default = rank, size, group
        self._local = threading.local()

    @property
    def group(self):
        return getattr(self._local, "group", None) or self.default

    @contextlib.contextmanager
    def using(self, group):
        """Within the block, this thread's collectives run on ``group``."""
        prev = getattr(self._local, "group", None)
        self._local.group = group
        try:
            yield
        finally:
            self._local.group = prev

    def splits(self, x: torch.Tensor) -> bool:
        """Whether a stream splits: 3-D (B, T, D) with T divisible by the
        axis (the JAX constraint's rule)."""
        return x.dim() == 3 and x.shape[1] % self.size == 0

    def offset(self, tokens: int) -> int:
        """The global index of this rank's first token of a stream of
        ``tokens`` tokens."""
        return self.rank * (tokens // self.size)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tokens of a whole (B, T, D) stream (a view)."""
        local = x.shape[1] // self.size
        return x.narrow(1, self.offset(x.shape[1]), local)

    def positions(self, tokens: int, device=None) -> torch.Tensor:
        """The global positions of this rank's tokens of a stream of
        ``tokens`` tokens."""
        local = tokens // self.size
        return self.offset(tokens) + torch.arange(local, device=device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (B, T, D) stream from every rank's (B, T/sp, D), in
        rank order; its backward sums the ranks' gradients and keeps this
        rank's tokens."""
        return _GatherTokens.apply(x, self.group, self.size)


def _all_gather(x, group, size):
    local = x.transpose(0, 1).contiguous()
    out = local.new_empty((size * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=group)
    return out.transpose(0, 1)


def _reduce_scatter(g, group, size):
    whole = g.transpose(0, 1).contiguous()
    out = whole.new_empty((whole.shape[0] // size, *whole.shape[1:]))
    dist.reduce_scatter_tensor(out, whole, group=group)
    return out.transpose(0, 1)


class _GatherTokens(torch.autograd.Function):
    """All-gather along the token axis; the backward is a reduce-scatter
    (every rank's queries read every token's keys and values). The group
    is the forward's: the backward may run on autograd's device thread."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _all_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.size), None, None


def stream(sp: SPGroup | None, x: torch.Tensor) -> SPGroup | None:
    """``sp`` where the stream ``x`` splits over it, else None (the
    stream stays whole)."""
    return sp if sp is not None and sp.splits(x) else None


def tower_modules(model: torch.nn.Module) -> list[torch.nn.Module]:
    """The towers with JAX ``constrain_batch`` sites: the TGB, T5 and
    LLaMA (the ViT-g, the Q-Former and RAFT have none)."""
    from videotgb_torch.models.llama import LlamaModel
    from videotgb_torch.models.t5 import T5Model
    from videotgb_torch.models.tgb import TGBModel

    kinds = (TGBModel, T5Model, LlamaModel)
    return [m for m in model.modules() if isinstance(m, kinds)]


def is_split(model: torch.nn.Module) -> bool:
    """Whether :func:`shard_sp` put ``model`` on an ``sp`` axis above 1
    (it then runs eagerly: ``utils/graphs.py``)."""
    return getattr(model, "sp", None) is not None


def shard_sp(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Put ``model``'s towers on this rank's place of ``mesh``'s ``sp``
    axis (nothing at ``sp`` = 1): each tower in :func:`tower_modules`
    splits its streams at the JAX call sites and gathers them for its
    attentions and at its end. No parameter moves."""
    rank, size = sp_rank(mesh)
    if size == 1:
        return model
    if is_split(model):
        raise ValueError("shard_sp: the model is split already")
    sp = SPGroup(rank, size, mesh.get_group(SEQUENCE_AXIS))
    for tower in tower_modules(model):
        tower.sp = sp
    model.sp = sp
    return model
