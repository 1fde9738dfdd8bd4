"""The training loop (counterpart of ``videotgb_tpu/training/trainer.py``):
the train step (gradients of a recipe's loss, accumulated over
micro-batches, then the clipped AdamW update of the trainable parameters)
and ``fit`` (logging, evaluation, checkpoints and early stopping on the JAX
trainer's cadence).

Frozen parameters carry ``requires_grad=False``, which is what the JAX
trainer's stop-gradient on frozen leaves does: autograd builds no backward
for a frozen tower that no trainable output depends on, and the clip and
the gradient norm count trainable parameters only. Each step draws its
dropout masks and Gumbel noise from one generator seeded from
``(seed, step)``.

On the card the step is a CUDA-graph program per batch signature (the JAX
trainer's jitted ``_train_step``): the forward, the backward, the
accumulation over micro-batches, the clip and the AdamW update, captured at
the second step and replayed after, its generator reseeded from
``(seed, step)`` and its learning rate filled into a device tensor before
each replay. ``train_step_multi`` takes a window of K batches stacked on a
new first axis (the JAX trainer's ``lax.scan`` of K steps): on the card one
upload and K replays of the step's graph, substep i reading slice i, each
computing what the i-th of K ``train_step`` calls computes. ``fit`` groups
the batches into such windows when ``steps_per_dispatch`` K > 1 and no
``batch_transform`` runs between steps (SF's pseudo-label pass needs the
current parameters every step), never stepping past ``max_steps``.

Given a ``mesh`` (``parallel.mesh.create_mesh``: dp x fsdp ranks, one
process a device), each rank's batches are its rows of the global batches
and a step computes what the JAX trainer's dp/fsdp-sharded step computes
on the global batch (which is what one device computes), up to reduction
order. The losses divide by the global count of valid entries
(``parallel.sharding.global_count``) and draw the global batch's random
numbers (``global_draw``); on the ``dp`` route (fsdp 1) every rank holds
the whole model and the trainable gradients are summed over the ranks in
buckets (``all_reduce_sum``) before the clip; on the ``fsdp`` route
(``shard_params``: FSDP2 units, each rank's backward scaled by the world
size so that FSDP2's averaging reduce-scatter leaves the sum) the clip
takes the global norm of the sharded gradients. The loss and the aux
scalars are summed over the ranks, so every rank logs, evaluates, saves
and stops on the same numbers. The step is a CUDA graph only on one
process or an NCCL group on the ``dp`` route: gloo's collectives run on
the host and cannot be captured, and FSDP2 keeps its gather and reshard
state on the host (``step_route`` names the route taken).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import torch

from videotgb_torch.parallel.mesh import mesh_rank
from videotgb_torch.parallel.sharding import (
    all_reduce_sum,
    batch_split,
    is_sharded,
    shard_params,
    sharded_call,
)
from videotgb_torch.training.optim import (
    cosine_warmup_schedule,
    make_optimizer,
    optimizer_step,
)
from videotgb_torch.utils.graphs import graphed
from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    lr: float = 5e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.05
    accumulate_grad_batches: int = 1
    max_grad_norm: float | None = 1.0
    # K train steps per dispatch (``train_step_multi`` over a stacked window
    # of K batches: one upload, K replays of the step's CUDA graph); 1 = one
    # step a batch. fit() takes 1 while a batch_transform runs (SF).
    steps_per_dispatch: int = 1
    log_every: int = 50
    eval_every: int = 500
    checkpoint_every: int = 500
    monitor: str = "val/score"
    monitor_mode: str = "max"
    early_stop_patience: int | None = None
    # callbacks-group extras (reference configs/callbacks/model_summary.yaml
    # RichModelSummary max_depth, rich_progress_bar.yaml RichProgressBar)
    model_summary_depth: int | None = None
    progress_bar: bool = False
    seed: int = 42


def param_summary(model: torch.nn.Module, trainable: Iterable[str],
                  max_depth: int) -> list[str]:
    """Depth-limited parameter table (the RichModelSummary analogue,
    reference configs/callbacks/model_summary.yaml): parameter counts
    grouped by the first ``max_depth`` components of their names, with the
    counts of the ``trainable`` ones."""
    trainable = set(trainable)
    groups: dict[str, list[int]] = {}
    for name, p in model.named_parameters():
        g = groups.setdefault(".".join(name.split(".")[:max_depth]), [0, 0])
        g[0] += p.numel()
        if name in trainable:
            g[1] += p.numel()
    width = max(len(n) for n in groups) if groups else 0
    lines = [f"  {'module'.ljust(width)}  params      trainable"]
    for name in sorted(groups):
        total, train = groups[name]
        lines.append(f"  {name.ljust(width)}  {total / 1e6:8.2f}M  "
                     f"{train / 1e6:8.2f}M")
    return lines


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
                 filter_fn: Callable[[str], bool] | None = None,
                 mesh=None):
        """``loss_fn(model, batch, generator) -> (loss, aux dict)``;
        ``filter_fn(name)`` says which parameters train (all without one);
        ``mesh`` the dp x fsdp mesh of a multi-rank run (None: one
        process)."""
        self.config = config
        self.loss_fn = loss_fn
        self.filter_fn = filter_fn
        self.mesh = mesh
        self.world = mesh_rank(mesh)[1]
        self.route = "single"
        self.step_route = "graph"
        self.writers = None  # optional utils.writers.MultiWriter
        self.schedule = cosine_warmup_schedule(config.lr, config.max_steps,
                                               config.warmup_ratio)
        self._best = None
        self._stale_evals = 0
        self._step = graphed(self._step_body)

    def init_state(self, model: torch.nn.Module) -> TrainState:
        """The train state of ``model``; with an fsdp extent above 1 the
        model is first sharded in place (``shard_params``)."""
        if (self.mesh is not None and self.mesh["fsdp"].size() > 1
                and not is_sharded(model)):
            shard_params(model, self.mesh)
        self.route = ("fsdp" if is_sharded(model) else
                      "dp" if self.mesh is not None else "single")
        if self.route == "fsdp":
            self.step_route = ("eager: FSDP2 gathers and reshards from the "
                               "host")
        elif (self.route == "dp"
              and torch.distributed.get_backend() != "nccl"):
            self.step_route = ("eager: gloo collectives run on the host")
        if self.step_route != "graph":
            self._step = self._step.eager
        optimizer, self.trainable = make_optimizer(
            model, self.config.weight_decay, self.filter_fn)
        params = dict(model.named_parameters())
        n_train = sum(params[n].numel() for n in self.trainable)
        n_total = sum(p.numel() for p in params.values())
        log.info("params: %.2fM trainable / %.2fM total",
                 n_train / 1e6, n_total / 1e6)
        if self.config.model_summary_depth:
            for line in param_summary(model, self.trainable,
                                      self.config.model_summary_depth):
                log.info("%s", line)
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
        and the recipe's scalar aux. On the card the step replays its CUDA
        graph from the second call of a batch signature on."""
        model = state.model
        dev = next(model.parameters()).device
        batch = {k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in batch.items()}
        lr = self.schedule(state.step)
        lr_arg = (lr if dev.type == "cpu" else
                  torch.full((), lr, dtype=torch.float32, device=dev))
        with batch_split(self.mesh):
            metrics = self._step(model, state.optimizer, batch,
                                 self.generator(state.step, dev), lr_arg)
        metrics["lr"] = lr
        return TrainState(model, state.optimizer, state.step + 1), metrics

    def _step_body(self, model, optimizer, batch, gen, lr):
        """The step as one program: every micro-batch's forward and
        backward, the average, the reduction over ranks, the clip and the
        update."""
        accum = self.config.accumulate_grad_batches
        micro = ([batch] if accum == 1 else
                 [{k: v[i] for k, v in batch.items()} for i in range(accum)])
        loss_sum, aux_sums = 0.0, {}
        for mb in micro:
            loss, aux = sharded_call(model, self.loss_fn, mb, gen)
            (loss * self.world if self.route == "fsdp" else loss).backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in aux.items():
                if torch.is_tensor(v) and v.dim() == 0:
                    aux_sums[k] = aux_sums.get(k, 0.0) + v.detach()
        if self.route == "dp":
            with torch.no_grad():
                all_reduce_sum([p.grad for group in optimizer.param_groups
                                for p in group["params"]
                                if p.grad is not None])
        if self.route != "single":  # the ranks' shares of the loss and aux
            keys = sorted(aux_sums)
            total = torch.stack([loss_sum] + [aux_sums[k] for k in keys])
            torch.distributed.all_reduce(total)
            loss_sum = total[0]
            aux_sums = dict(zip(keys, total[1:]))
        if accum > 1:
            with torch.no_grad():
                for group in optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad /= accum
        grad_norm = optimizer_step(optimizer, lr, self.config.max_grad_norm)
        metrics = {"loss": loss_sum / accum, "grad_norm": grad_norm}
        metrics.update({k: v / accum for k, v in aux_sums.items()
                        if k not in metrics and k != "lr"})
        return metrics

    def train_step_multi(self, state: TrainState, window: dict
                         ) -> tuple[TrainState, dict]:
        """K train steps on ``window``, whose tensors are stacked (K, ...)
        over K batches (the JAX trainer's ``train_step_multi``). Substep i
        computes exactly what the i-th of K ``train_step`` calls computes;
        the window is moved to the device once, and on the card each
        substep replays the step's graph on slice i. Returns the metrics
        stacked (K,) per key."""
        dev = next(state.model.parameters()).device
        window = {k: (v.to(dev) if torch.is_tensor(v) else v)
                  for k, v in window.items()}
        k_steps = next(v for v in window.values()
                       if torch.is_tensor(v)).shape[0]
        stacked: dict[str, list] = {}
        for i in range(k_steps):
            state, metrics = self.train_step(
                state, {k: v[i] for k, v in window.items()})
            for k, v in metrics.items():
                stacked.setdefault(k, []).append(v)
        out = {k: torch.stack(v) for k, v in stacked.items() if k != "lr"}
        out["lr"] = torch.tensor(stacked["lr"], dtype=torch.float64)
        return state, out

    def _windows(self, train_iter: Iterable[dict], k: int,
                 state: TrainState) -> Iterable:
        """The batch stream grouped into K-step windows for
        ``train_step_multi``: yields ``("window", stacked)`` with every
        tensor stacked (K, ...), and single batches where the horizon is
        nearer than a full window or the stream ends inside one, so a run
        stops at exactly ``max_steps`` and one window shape is captured."""
        remaining = self.config.max_steps - int(state.step)
        buf: list[dict] = []
        for batch in train_iter:
            if remaining < k:
                # the buffer is empty here: a full window leaves k or more
                remaining -= 1
                yield batch
                if remaining <= 0:
                    return
                continue
            buf.append(batch)
            if len(buf) == k:
                stacked = {key: torch.stack([b[key] for b in buf])
                           for key in buf[0] if torch.is_tensor(buf[0][key])}
                buf.clear()
                remaining -= k
                yield ("window", stacked)
                if remaining <= 0:
                    return
        yield from buf  # the stream ended inside a window

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        state: TrainState,
        train_iter: Iterable[dict],
        eval_fn: Callable[[TrainState], dict] | None = None,
        checkpoint_fn: Callable[[TrainState, dict | None], None] | None = None,
        batch_transform: Callable[[TrainState, dict], dict] | None = None,
    ) -> TrainState:
        """Train until ``max_steps`` (or the iterator ends, or early stop).
        ``batch_transform(state, batch)`` runs host-side per step with the
        CURRENT parameters (the hook of the SF pseudo-label pass). The
        cadence is the JAX trainer's: at each step or window of
        ``steps_per_dispatch`` steps log (when a multiple of ``log_every``
        was crossed), then evaluate (``eval_every``), save with the eval
        metrics and test for an early stop; between evals, save without
        metrics when the step is a multiple of ``checkpoint_every``."""
        cfg = self.config
        if state.step >= cfg.max_steps:
            return state  # resumed at/after the horizon: nothing to do
        # K steps a dispatch only while no host pass runs between steps
        k_dispatch = cfg.steps_per_dispatch if batch_transform is None else 1
        feed = (self._windows(train_iter, k_dispatch, state)
                if k_dispatch > 1 else train_iter)
        t0 = time.perf_counter()
        for batch in feed:
            prev_step = state.step
            if isinstance(batch, tuple):
                state, stacked = self.train_step_multi(state, batch[1])
                metrics = {k: v[-1] for k, v in stacked.items()}
            else:
                if batch_transform is not None:
                    batch = batch_transform(state, batch)
                state, metrics = self.train_step(state, batch)
            step = state.step

            def crossed(every):
                # true when any step in (prev_step, step] is a multiple of
                # ``every`` (the JAX trainer's test, which also serves its
                # K-step windows)
                return bool(every) and (step // every) > (prev_step // every)

            if cfg.progress_bar:
                # in-place per-step line (RichProgressBar analogue); the
                # loss fetch syncs the step, so keep it off for benchmarks
                print(f"\rstep {step}/{cfg.max_steps} "
                      f"loss={float(metrics['loss']):.4f}",
                      end="" if step < cfg.max_steps else "\n", flush=True)
            if crossed(cfg.log_every):
                host = {k: float(v) for k, v in metrics.items()}
                rate = step / (time.perf_counter() - t0)
                log.info("step %d %s (%.2f it/s)", step, host, rate)
                if self.writers is not None:
                    self.writers.log_metrics(host, step)
            if eval_fn is not None and crossed(cfg.eval_every):
                eval_metrics = eval_fn(state)
                log.info("eval @%d: %s", step, eval_metrics)
                if self.writers is not None:
                    self.writers.log_metrics(eval_metrics, step)
                if checkpoint_fn is not None:
                    checkpoint_fn(state, eval_metrics)
                if self._should_stop(eval_metrics):
                    log.info("early stopping at step %d", step)
                    break
            elif (checkpoint_fn is not None and cfg.checkpoint_every
                  and step % cfg.checkpoint_every == 0):
                # periodic save between eval ticks (metrics=None: recorded as
                # a resume point, never a "best" candidate)
                checkpoint_fn(state, None)
            if step >= cfg.max_steps:
                break
        return state

    def _should_stop(self, eval_metrics: dict) -> bool:
        cfg = self.config
        if cfg.early_stop_patience is None or cfg.monitor not in eval_metrics:
            return False
        value = eval_metrics[cfg.monitor]
        better = (
            self._best is None
            or (cfg.monitor_mode == "max" and value > self._best)
            or (cfg.monitor_mode == "min" and value < self._best)
        )
        if better:
            self._best = value
            self._stale_evals = 0
            return False
        self._stale_evals += 1
        return self._stale_evals >= cfg.early_stop_patience
