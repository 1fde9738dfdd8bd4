"""Checkpoint management and resume (counterpart of
``videotgb_tpu/training/checkpoint.py``, the same retention semantics;
``torch.save`` files where the JAX package writes Orbax trees).

Replaces Lightning's ModelCheckpoint/ckpt_path machinery (reference:
configs/callbacks/default.yaml:7-13, src/train.py:87-98):

  best/   top-k on the monitored metric (saves carrying metrics)
  last/   the most recent save regardless of metrics (save_last; also where
          periodic between-eval saves land)

A save is a step directory ``<best|last>/<step>/`` holding one file per
item (``params.pt``: the model's ``state_dict``; ``opt_state.pt``: the
optimizer's; ``step.pt``: the step count) and ``metrics.json``. It is
written under a hidden temporary name and renamed when complete, so a step
directory that exists is whole. A save that goes to both best/ and last/
writes its files once and hard-links them into the second directory.

As in the JAX manager (Orbax underneath), each of best/ and last/ skips a
save whose step is not above its newest kept step, best/ keeps the
``max_to_keep`` saves with the highest (``mode="max"``) or lowest metric
(a save without the monitored key counts 0.0; among equals the later step
stays), and last/ keeps one. Full training state round-trips, so a
preempted run resumes its optimizer moments and schedule; the per-step
generator is seeded from (seed, step), so restoring the step restores the
randomness too. Saving is synchronous: ``wait`` and ``close`` have nothing
to wait for.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Iterable

import torch

from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.ckpt")

_SUFFIX = ".pt"
_METRICS = "metrics.json"
_TMP = ".tmp-"  # a save in flight: .<step>.tmp-<pid of the saver>


@dataclasses.dataclass
class CheckpointConfig:
    directory: str = "checkpoints"
    max_to_keep: int = 1
    save_last: bool = True
    monitor: str = "val/score"
    mode: str = "max"


class _StepDir:
    """One retention pool (best/ or last/): step -> metrics of its kept
    saves, read back from disk when a manager opens an existing root."""

    def __init__(self, root: str, max_to_keep: int, monitor: str | None,
                 mode: str):
        self.root = root
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.steps: dict[int, dict | None] = {}
        for name in (os.listdir(root) if os.path.isdir(root) else ()):
            path = os.path.join(root, name)
            if name.isdigit():
                metrics = None
                if os.path.exists(os.path.join(path, _METRICS)):
                    with open(os.path.join(path, _METRICS)) as f:
                        metrics = json.load(f)
                self.steps[int(name)] = metrics

    def path(self, step: int) -> str:
        return os.path.join(self.root, str(step))

    def sweep_tmp(self) -> None:
        """Drop the temporary directories of saves cut off before their
        rename: this process's own and those of processes no longer alive.
        A save that another live process has in flight is left alone."""
        for name in os.listdir(self.root):
            pid = name.rpartition(_TMP)[2]
            if (name.startswith(".") and _TMP in name and pid.isdigit()
                    and (int(pid) == os.getpid() or not _alive(int(pid)))):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def latest(self) -> int | None:
        return max(self.steps) if self.steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest()
        return latest is None or step > latest

    def _ranked(self) -> list[int]:
        """Kept steps, worst first: by metric when monitoring, else by step
        (a stable sort, so among equal metrics the later step ranks better)."""
        steps = sorted(self.steps)
        if self.monitor is None:
            return steps
        return sorted(steps, key=lambda s: (self.steps[s] or {}).get(
            self.monitor, 0.0), reverse=self.mode == "min")

    def best(self) -> int | None:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def add(self, step: int, tmp: str, metrics: dict | None) -> None:
        """Rename the complete temporary directory ``tmp`` to the step's,
        then drop what falls outside ``max_to_keep``."""
        os.replace(tmp, self.path(step))
        self.steps[step] = metrics
        for old in self._ranked()[:-self.max_to_keep]:
            shutil.rmtree(self.path(old))
            del self.steps[old]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # alive, under another user
        return True
    return True


class CheckpointManager:
    """Top-k-on-metric + save_last retention over two step directories.
    Opening a root only reads it: the directories are made, and temporaries
    of cut-off saves swept, by the first save."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        root = os.path.abspath(config.directory)
        self._best = _StepDir(os.path.join(root, "best"), config.max_to_keep,
                              config.monitor, config.mode)
        self._last = _StepDir(os.path.join(root, "last"), 1, None, "max")

    def save(self, step: int, state: dict, metrics: dict | None = None
             ) -> None:
        """``state`` maps item name -> object ({"params": state_dict,
        "opt_state": optimizer state_dict, "step": int}); items save to
        separate files so restores can pick a subset (eval restores params
        only). Metric-carrying saves compete for best/; every save lands in
        last/ when ``save_last`` (metric-less periodic saves land ONLY
        there)."""
        metrics = ({k: float(v) for k, v in metrics.items()}
                   if metrics else None)
        # last/ first: it always keeps a save it takes, so best/ can link
        # from it even when its own top-k drops the new step at once
        pools = []
        if self.config.save_last or not metrics:
            pools.append(self._last)
        if metrics:
            pools.append(self._best)
        for pool in (self._best, self._last):
            os.makedirs(pool.root, exist_ok=True)
            pool.sweep_tmp()
        pools = [p for p in pools if p.should_save(step)]
        written = None
        for pool in pools:
            tmp = os.path.join(pool.root, f".{step}{_TMP}{os.getpid()}")
            os.makedirs(tmp)
            if written is None:
                for name, obj in state.items():
                    torch.save(obj, os.path.join(tmp, name + _SUFFIX))
                written = tmp
            else:  # the same bytes: link the first pool's files
                for name in state:
                    src = os.path.join(written, name + _SUFFIX)
                    dst = os.path.join(tmp, name + _SUFFIX)
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copyfile(src, dst)
            with open(os.path.join(tmp, _METRICS), "w") as f:
                json.dump(metrics, f)
            pool.add(step, tmp, metrics)
            if written == tmp:
                written = pool.path(step)
        log.info("saved step %d to %s", step,
                 " and ".join(os.path.basename(p.root) for p in pools) or
                 "nothing (not above the newest kept step)")

    def restore(self, step: int | None = None,
                items: Iterable[str] | None = None) -> dict:
        """Restore ``step`` (or the newest step across best/ and last/) as
        {item name: object} on the host; ``items`` names a SUBSET of the
        stored items. Tensors are memory-mapped from the files, so loading
        them into a live model copies each once."""
        step, pool = self._locate(step)
        names = sorted(self._items(pool, step)) if items is None else items
        return {name: torch.load(
            os.path.join(pool.path(step), name + _SUFFIX), map_location="cpu",
            mmap=True, weights_only=True) for name in names}

    def item_names(self, step: int | None = None) -> set[str]:
        """Item keys stored at ``step`` (probe before shaping a restore:
        a params-only checkpoint holds no optimizer state)."""
        step, pool = self._locate(step)
        return self._items(pool, step)

    @staticmethod
    def _items(pool: _StepDir, step: int) -> set[str]:
        return {name[:-len(_SUFFIX)] for name in os.listdir(pool.path(step))
                if name.endswith(_SUFFIX)}

    def _locate(self, step: int | None) -> tuple[int, _StepDir]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint in {self.config.directory}")
        if step in self._last.steps:
            return step, self._last
        if step in self._best.steps:
            return step, self._best
        raise FileNotFoundError(
            f"step {step} not found in {self.config.directory}")

    def best_step(self) -> int | None:
        return self._best.best()

    def latest_step(self) -> int | None:
        steps = [s for s in (self._best.latest(), self._last.latest())
                 if s is not None]
        return max(steps) if steps else None

    def step_dir(self, step: int) -> str:
        """The directory that holds ``step``'s files."""
        step, pool = self._locate(step)
        return pool.path(step)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open between saves."""


def resolve_ckpt_path(path: str) -> tuple[str, int | None]:
    """Map a user-supplied ``ckpt_path`` to (manager root, step).

    Accepts the manager root, a ``best``/``last`` subdir, or a concrete step
    directory (``.../last/500``) — resuming from an explicit path must load
    exactly what the path names (ADVICE r1, train.py:270).
    """
    path = os.path.abspath(path.rstrip("/"))
    step = None
    base = os.path.basename(path)
    if base.isdigit():
        step = int(base)
        path = os.path.dirname(path)
        base = os.path.basename(path)
    if base in ("best", "last"):
        path = os.path.dirname(path)
    return path, step


def train_state_items(state: Any) -> dict | None:
    """The items a full-state save holds for a ``TrainState``, in the
    single-device format at every layout: under FSDP2 each parameter and
    Adam moment is first gathered whole to the CPU
    (``parallel.sharding.full_tensor``, a collective every rank joins).
    Ranks other than the coordinator get None."""
    from videotgb_torch.parallel.distributed import is_coordinator
    from videotgb_torch.parallel.sharding import full_tensor

    def whole(x):
        return full_tensor(x).cpu() if hasattr(x, "to_local") else x

    params = {n: whole(v) for n, v in state.model.state_dict().items()}
    optim = state.optimizer.state_dict()
    optim = {"state": {i: {k: whole(v) for k, v in s.items()}
                       for i, s in optim["state"].items()},
             "param_groups": optim["param_groups"]}
    if not is_coordinator():
        return None
    return {"params": params, "opt_state": optim, "step": state.step}


def restore_into(restored: dict, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer | None = None
                 ) -> int | None:
    """Copy restored items into the live ``model`` (and ``optimizer``,
    where the checkpoint has its state) in place; returns the restored step
    count, or None when the checkpoint holds none. Every rank restores the
    same single-device files: a parameter or Adam moment under FSDP2 takes
    its rank's chunk of the whole tensor."""
    from videotgb_torch.parallel.sharding import shard_like

    def local(v, like):
        return shard_like(v, like) if hasattr(like, "to_local") else v

    live = model.state_dict()
    model.load_state_dict({n: local(v, live.get(n))
                           for n, v in restored["params"].items()})
    if optimizer is not None and "opt_state" in restored:
        order = [p for g in optimizer.param_groups for p in g["params"]]
        optim = restored["opt_state"]
        optimizer.load_state_dict({
            "state": {i: {k: (local(v, order[i])
                              if torch.is_tensor(v) and v.dim() > 0 else v)
                          for k, v in s.items()}
                      for i, s in optim["state"].items()},
            "param_groups": optim["param_groups"]})
    return int(restored["step"]) if "step" in restored else None


def restore_params(model: torch.nn.Module, path: str) -> tuple[str, int]:
    """Copy the ``params`` item of the checkpoint that ``path`` names (see
    :func:`resolve_ckpt_path`; a root gives its newest step) into
    ``model``, cast to each parameter's dtype. The keys must be the
    model's exactly (``load_state_dict`` raises naming the others).
    Returns (root, step)."""
    root, step = resolve_ckpt_path(path)
    mgr = CheckpointManager(CheckpointConfig(directory=root))
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    restore_into(mgr.restore(step, items=["params"]), model)
    return root, step
