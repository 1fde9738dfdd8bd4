"""Tensor parallelism over the mesh's ``tp`` axis for serving (the
counterpart of the JAX package's GSPMD placement of every parameter that
carries "heads", "mlp" or "vocab" on ``tp``,
``videotgb_tpu/parallel/sharding.py:31-44,66-89``).

GSPMD places the collectives itself; here they are explicit, as Megatron
places them:

* column-parallel q / k / v and ``wi`` (``wi_0`` / ``wi_1``,
  ``gate_proj`` / ``up_proj``): a rank holds the output rows of its heads
  or hidden units, and their biases;
* row-parallel ``o`` and ``wo`` (``down_proj``): a rank holds the input
  columns of its heads or hidden units; the partial products are summed by
  one all-reduce over the ``tp`` group and the bias, whole on every rank,
  is added once after it;
* vocabulary-parallel embeddings: a rank holds its rows of the table, looks
  up the ids that fall in them (zeros elsewhere) and the lookups are summed
  by an all-reduce;
* a vocabulary-parallel ``lm_head``: column-parallel over the vocabulary,
  its logits all-gathered, so every rank picks the same token from the
  same logits.

Everything else (norms, RAFT, patch convolutions, position tables, the
projections into the LLM, the TGB's heads) is whole on every rank, as
GSPMD replicates it, and computed alike on each.

:data:`ROLES` is the table of these roles over the port's ``state_dict``
keys, read from the JAX annotations. The one departure: the JAX package
leaves the biases of column-parallel projections unannotated, so GSPMD
replicates them, where a rank here holds only its heads' or units' part.

The collectives are plain ``torch.distributed.all_reduce`` and
``all_gather_into_tensor`` (DTensor's functional collectives end the
process with a segmentation fault over gloo on CUDA tensors, torch 2.11:
``parallel/sharding.py::full_tensor``), outside autograd: the port serves
``tp`` layouts and does not train them (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import contextlib
import re
import threading

import torch
import torch.distributed as dist

from videotgb_torch.parallel.mesh import TENSOR_AXIS, tp_rank

COLUMN = "column"  # output rows split: weight dim 0, and its bias
ROW = "row"        # input columns split: weight dim 1; all-reduce, then bias
VOCAB = "vocab"    # embedding rows split: masked lookup, then all-reduce
GATHER = "gather"  # lm_head: vocabulary rows split, logits all-gathered
HEADS = "heads"    # a (buckets, heads) table: its heads' columns
LORA_B = "lora_b"  # a LoRA delta's B (r, out): its heads' columns

# the dim of the port's tensor each role splits
SPLIT_DIM = {COLUMN: 0, ROW: 1, VOCAB: 0, GATHER: 0, HEADS: 1, LORA_B: 1}

# (state_dict key pattern, role), each from the JAX annotation beside it
ROLES = (
    # MultiHeadAttention's q/k/v ("embed", "heads") and o ("heads", "embed"),
    # videotgb_tpu/models/common.py:222-233, 280-290
    (r"(^|\.)(q|k|v)\.(weight|bias)$", COLUMN),
    (r"(^|\.)o\.weight$", ROW),
    # Mlp's wi ("embed", "mlp") and wo ("mlp", "embed"), common.py:316-319;
    # T5's gated wi_0 / wi_1 and wo, t5.py:179-183; LLaMA's SwiGLU,
    # llama.py:111-115
    (r"(^|\.)(wi|wi_0|wi_1|gate_proj|up_proj)\.(weight|bias)$", COLUMN),
    (r"(^|\.)(wo|down_proj)\.weight$", ROW),
    # the LM heads ("embed", "vocab"), t5.py:275, llama.py:157
    (r"(^|\.)lm_head\.weight$", GATHER),
    # every embedding table ("vocab", "embed"), common.py:99: T5's shared
    # (t5.py:242), LLaMA's embed_tokens, the Q-Former's and the TGB's
    (r"(^|\.)(shared|embed_tokens|word_embeddings|token_type_embeddings"
     r"|frame_pos_embed)\.weight$", VOCAB),
    # T5's relative-position table (None, "heads"), t5.py:123
    (r"(^|\.)rel_embedding$", HEADS),
    # a LoRA delta's B (None, "heads"), lora.py:44; A ("embed", None) is
    # whole
    (r"(^|\.)(q|k|v)_lora\.lora_b$", LORA_B),
)
_ROLES = tuple((re.compile(p), role) for p, role in ROLES)
_ATTENTION = re.compile(r"(^|\.)((q|k|v|o)(_lora)?\.\w+|rel_embedding)$")
WHAT = {COLUMN: "output features", ROW: "input features",
        VOCAB: "vocabulary rows", GATHER: "vocabulary rows",
        HEADS: "heads", LORA_B: "output features"}
INT8_TP = ("the W8A8 ViT-g (ViTConfig.quant='int8') under tp is ROADMAP.md "
           "queue 1 item 9: kernel H would take the sliced K and N")


def role(key: str) -> str | None:
    """The ``tp`` role of a port ``state_dict`` key (None: whole on every
    rank)."""
    for pattern, name in _ROLES:
        if pattern.search(key):
            return name
    return None


def _tower_heads(cfg) -> dict[str, int]:
    """The head count of each tower of a ``VideoTGBConfig``, by the
    prefix of its keys."""
    backbone = cfg.blip2 or cfg.instructblip
    llm = backbone.t5 if cfg.blip2 is not None else backbone.llm
    return {"temporal_encoder.": cfg.tgb.num_heads,
            "model.vision_model.": backbone.vit.num_heads,
            "model.qformer.": backbone.qformer.num_heads,
            "model.language_model.": llm.num_heads}


def _module(key: str) -> str:
    return key.rsplit(".", 1)[0]


def tp_shard_state_dict(state_dict: dict, cfg, rank: int, size: int) -> dict:
    """Rank ``rank``'s slice of a whole ``VideoTGB`` ``state_dict`` (of
    ``cfg``) at ``tp`` = ``size``: each tensor with a role in
    :data:`ROLES` narrowed to the rank's contiguous ``1/size`` of its split
    dim (a copy), every other tensor as it is. Pure: nothing is
    communicated or changed in place. Raises ``ValueError`` naming the
    module whose heads, hidden units or vocabulary rows do not divide by
    ``size``."""
    heads = _tower_heads(cfg)
    out = {}
    for key, t in state_dict.items():
        name = role(key)
        if name is None or size == 1:
            out[key] = t
            continue
        if _ATTENTION.search(key):
            tower = [p for p in heads if key.startswith(p)]
            if len(tower) != 1:
                raise ValueError(f"{key}: not an attention of a VideoTGB "
                                 "tower")
            if heads[tower[0]] % size:
                raise ValueError(
                    f"{_module(key)}: {heads[tower[0]]} heads do not divide "
                    f"by tp={size}")
        dim = SPLIT_DIM[name]
        n = t.shape[dim]
        if n % size:
            raise ValueError(f"{_module(key)}: {n} {WHAT[name]} do not "
                             f"divide by tp={size}")
        piece = n // size
        out[key] = t.narrow(dim, rank * piece, piece).clone()
    return out


class TPGroup:
    """One rank's place on the ``tp`` axis: its index ``rank``, the axis's
    ``size``, and the process group its collectives run on, the mesh's
    ``tp`` group unless the calling thread named another with
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

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ``tp`` ranks (in place on a contiguous
        ``x``)."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ``tp`` ranks' ``x`` (..., n) side by side along the last dim,
        (..., size * n), in rank order."""
        local = x.movedim(-1, 0).contiguous()
        out = local.new_empty((self.size * local.shape[0],
                               *local.shape[1:]))
        dist.all_gather_into_tensor(out, local, group=self.group)
        return out.movedim(0, -1)


def is_sliced(model: torch.nn.Module) -> bool:
    """Whether :func:`shard_tp` sliced ``model`` (it then runs eagerly:
    ``utils/graphs.py``)."""
    return getattr(model, "tp", None) is not None


def shard_tp(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Slice a ``VideoTGB`` in place for this rank of ``mesh``'s ``tp``
    axis (nothing at ``tp`` = 1): every tensor of :data:`ROLES` becomes
    this rank's slice (:func:`tp_shard_state_dict`), each attention's
    head count its local one, each row-parallel ``Dense`` sums its product
    over the ``tp`` group before its bias, each embedding looks up its rows,
    and each ``lm_head`` gathers its logits. Raises ``ValueError`` naming
    the module that does not divide, and ``NotImplementedError`` for the
    W8A8 ViT-g."""
    from videotgb_torch.models.common import (Dense, Embed,
                                              MultiHeadAttention)

    rank, size = tp_rank(mesh)
    if size == 1:
        return model
    if is_sliced(model):
        raise ValueError("shard_tp: the model is sliced already")
    cfg = model.config
    if cfg.vit.quant is not None:
        raise NotImplementedError(INT8_TP)
    sliced = tp_shard_state_dict(model.state_dict(), cfg, rank, size)
    tp = TPGroup(rank, size, mesh.get_group(TENSOR_AXIS))
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    roles = {}
    with torch.no_grad():
        for key, t in tensors.items():
            roles[key] = role(key)
            if roles[key] is not None:
                t.data = sliced[key]
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention):
            m.num_heads //= size
        elif isinstance(m, Dense):
            kind = roles[f"{prefix}weight"]
            if kind == ROW:
                m.tp_reduce = tp
            elif kind == GATHER:
                m.tp_gather = tp
        elif isinstance(m, Embed):
            m.tp = tp
    model.tp = tp
    return model
