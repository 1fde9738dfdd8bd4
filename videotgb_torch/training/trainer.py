"""The train step (counterpart of ``videotgb_tpu/training/trainer.py``):
gradients of a recipe's loss, accumulated over micro-batches, then the
clipped AdamW update of the trainable parameters.

Frozen parameters carry ``requires_grad=False``, which is what the JAX
trainer's stop-gradient on frozen leaves does: autograd builds no backward
for a frozen tower that no trainable output depends on, and the clip and
the gradient norm count trainable parameters only. Each step draws its
dropout masks and Gumbel noise from one generator seeded from
``(seed, step)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from videotgb_torch.training.optim import (
    cosine_warmup_schedule,
    make_optimizer,
    optimizer_step,
)


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    lr: float = 5e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.05
    accumulate_grad_batches: int = 1
    max_grad_norm: float | None = 1.0
    seed: int = 42


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are updated in place), the optimizer and
    the number of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class Trainer:
    def __init__(self, config: TrainerConfig,
                 loss_fn: Callable[..., tuple[torch.Tensor, dict]],
                 filter_fn: Callable[[str], bool] | None = None):
        """``loss_fn(model, batch, generator) -> (loss, aux dict)``;
        ``filter_fn(name)`` says which parameters train (all without one)."""
        self.config = config
        self.loss_fn = loss_fn
        self.filter_fn = filter_fn
        self.schedule = cosine_warmup_schedule(config.lr, config.max_steps,
                                               config.warmup_ratio)

    def init_state(self, model: torch.nn.Module) -> TrainState:
        optimizer, self.trainable = make_optimizer(
            model, self.config.weight_decay, self.filter_fn)
        return TrainState(model, optimizer, 0)

    def generator(self, step: int, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.config.seed * 2 ** 32 + step)
        return gen

    def train_step(self, state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One optimizer step. With ``accumulate_grad_batches`` = A > 1 every
        entry of ``batch`` is stacked (A, B/A, ...) and the gradients, the
        loss and the scalar aux are averaged over the A micro-batches.
        Returns the state and the metrics ``loss``, ``grad_norm``, ``lr``
        and the recipe's scalar aux."""
        model = state.model
        dev = next(model.parameters()).device
        batch = {k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in batch.items()}
        gen = self.generator(state.step, dev)
        accum = self.config.accumulate_grad_batches
        micro = ([batch] if accum == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(accum)])
        loss_sum, aux_sums = 0.0, {}
        for mb in micro:
            loss, aux = self.loss_fn(model, mb, gen)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in aux.items():
                if torch.is_tensor(v) and v.dim() == 0:
                    aux_sums[k] = aux_sums.get(k, 0.0) + v.detach()
        if accum > 1:
            with torch.no_grad():
                for group in state.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad /= accum
        lr = self.schedule(state.step)
        grad_norm = optimizer_step(state.optimizer, lr,
                                   self.config.max_grad_norm)
        metrics = {"loss": loss_sum / accum, "grad_norm": grad_norm,
                   "lr": lr}
        metrics.update({k: v / accum for k, v in aux_sums.items()
                        if k not in metrics})
        return TrainState(model, state.optimizer, state.step + 1), metrics
