"""AdamW with a cosine-warmup schedule and parameter freezing (counterpart of
``videotgb_tpu/training/optim.py``).

The JAX package builds an optax chain (global-norm clip, then AdamW) masked
to the trainable subtrees, the frozen ones getting ``set_to_zero`` and no
state. Here the frozen parameters get ``requires_grad=False`` and no state,
and :func:`optimizer_step` does the optax chain's arithmetic on the
trainable ones with PyTorch's own pieces: ``clip_grad_norm_`` over their
gradients, then the fused ``torch.optim.AdamW`` (bias-corrected moments, eps
after the square root, decoupled weight decay; ``capturable`` on the card,
its step count a device tensor) at the learning rate the caller takes from
the schedule at the step count before the update (so step 0 of a warmup
from 0 moves nothing). Parameters are updated in place.

Under FSDP2 (``parallel.sharding.shard_params``) the parameters, their
gradients and the moments are DTensors, each rank holding its shard: the
fused, capturable AdamW takes them as they are (torch 2.11 and later), and
the clip's norm is the global norm over every rank's shard. On the
data-parallel route every rank holds the summed gradients whole, so the
ranks' clips and updates are the same arithmetic on the same numbers and
the trainable parameters stay bit-identical across the ranks.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from videotgb_torch.utils.graphs import invalidate

def cosine_warmup_schedule(lr: float, total_steps: int,
                           warmup_ratio: float = 0.05) -> Callable[[int], float]:
    """Linear warmup from 0, then cosine decay to 0 (HF
    get_cosine_schedule_with_warmup), with the step arithmetic of optax's
    ``warmup_cosine_decay_schedule`` as the JAX package configures it."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps, warmup + 1) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * min(max(step, 0), warmup) / warmup
        t = min(step - warmup, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def path_freeze_filter(freeze_prefixes: Sequence[str] = (),
                       train_prefixes: Sequence[str] | None = None,
                       train_lora_only: bool = False
                       ) -> Callable[[str], bool]:
    """Returns f(name) -> True if the parameter ``name`` (a ``state_dict``
    key of the port) trains. Prefixes are written as in the JAX package
    (``"model/qformer"``, ``"temporal_encoder"``): ``/`` reads as ``.``.

    * ``train_prefixes`` given: only those subtrees train (IV: the
      Q-Former, its projection and query tokens);
    * else: everything except ``freeze_prefixes``;
    * ``train_lora_only``: additionally train every LoRA adapter parameter
      wherever it lives (IVT): a name with a part that ends in ``_lora``
      or starts with ``lora_``.
    """
    def dotted(prefixes):
        return tuple(p.replace("/", ".") for p in prefixes)

    freeze = dotted(freeze_prefixes)
    train = None if train_prefixes is None else dotted(train_prefixes)

    def is_lora(name: str) -> bool:
        return any(part.endswith("_lora") or part.startswith("lora_")
                   for part in name.split("."))

    def fn(name: str) -> bool:
        if train_lora_only and is_lora(name):
            return True
        if train is not None:
            return name.startswith(train)
        return not name.startswith(freeze)

    return fn


# optax.adamw's defaults, as the JAX package's make_optimizer uses them
B1, B2, EPS = 0.9, 0.999, 1e-8


def make_optimizer(model: torch.nn.Module, weight_decay: float = 0.0,
                   filter_fn: Callable[[str], bool] | None = None
                   ) -> tuple[torch.optim.AdamW, list[str]]:
    """Marks each parameter of ``model`` trainable or frozen by
    ``filter_fn(name)`` (all train without one) and returns (AdamW over the
    trainable ones, their names)."""
    names, params = [], []
    for name, p in model.named_parameters():
        train = filter_fn is None or filter_fn(name)
        p.requires_grad_(train)
        p.grad = None
        if train:
            names.append(name)
            params.append(p)
    on_card = bool(params) and all(p.is_cuda for p in params)
    optimizer = torch.optim.AdamW(params, lr=0.0, betas=(B1, B2), eps=EPS,
                                  weight_decay=weight_decay, fused=True,
                                  capturable=on_card)
    # a restore makes new state tensors: a captured step would update the
    # old ones
    optimizer.register_load_state_dict_post_hook(invalidate)
    return optimizer, names


@torch.no_grad()
def optimizer_step(optimizer: torch.optim.Optimizer,
                   lr: float | torch.Tensor,
                   max_grad_norm: float | None = 1.0) -> torch.Tensor:
    """Clip by the global norm, then one AdamW update at ``lr``; returns the
    global norm of the gradients before clipping and clears them. A
    parameter left without a gradient counts as a zero gradient, as JAX's
    gradient of an unused leaf is zero.

    On the card (``capturable``, for the CUDA-graphed train step) ``lr`` is
    a 0-dim f32 device tensor the caller fills before each step or replay,
    not a host number a graph would keep; the zeros of the unused
    parameters are allocated once, at the first (eager) step, and zeroed
    in each step."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    zeros = optimizer.__dict__.setdefault("_unused_grads", {})
    for p in params:
        if p.grad is None:
            z = zeros.get(p)
            if z is None:
                z = zeros[p] = torch.zeros_like(p)
            else:
                z.zero_()
            p.grad = z
    norm = torch.nn.utils.clip_grad_norm_(
        params, float("inf") if max_grad_norm is None else max_grad_norm)
    if hasattr(norm, "full_tensor"):  # a DTensor: the norm over every shard
        norm = norm.full_tensor()
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return norm
