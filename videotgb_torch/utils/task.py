"""Task wrapping, run-directory, extras and metric glue of the entry points
(the port's copy of ``videotgb_tpu/utils/task.py``).

Ports the reference's hydra-run utilities (reference: src/utils/utils.py):
``task_wrapper`` (:43-93 — log the exception into the run dir, always close
loggers so multiruns survive a crashed trial), ``get_metric_value``
(:96-119 — pull the optimized metric for a sweep), the hydra run directory
(single runs and multirun trials) and ``extras()``.
"""

from __future__ import annotations

import functools
import os
import traceback
from typing import Any, Callable, Mapping

from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.task")


def task_wrapper(task_fn: Callable) -> Callable:
    """Wrap an entry function: exceptions are written to
    ``<output_dir>/error.log`` and re-raised; the closers registered on
    ``wrapped._closers`` (writers and the like) run either way, and a
    closer's own failure is logged."""

    @functools.wraps(task_fn)
    def wrapped(cfg, *args: Any, **kwargs: Any):
        paths = cfg.get("paths") if hasattr(cfg, "get") else None
        out_dir = paths.get("output_dir") if paths else None
        try:
            return task_fn(cfg, *args, **kwargs)
        except Exception:
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir, "error.log"), "a") as f:
                    f.write(traceback.format_exc())
                log.error("task failed; traceback saved to %s/error.log",
                          out_dir)
            raise
        finally:
            for closer in getattr(wrapped, "_closers", []):
                try:
                    closer()
                except Exception as e:  # one closer must not stop the rest
                    log.error("closer %r failed: %s", closer, e)

    wrapped._closers = []
    return wrapped


def get_metric_value(metric_dict: Mapping[str, float],
                     metric_name: str | None) -> float | None:
    """Fetch the optimized metric for sweeps; None metric -> None
    (src/utils/utils.py:96-119 semantics incl. the not-found error)."""
    if not metric_name:
        return None
    if metric_name not in metric_dict:
        raise KeyError(
            f"metric '{metric_name}' not found in {sorted(metric_dict)}; "
            "make sure the name in hparams_search matches what the recipe logs"
        )
    return float(metric_dict[metric_name])


def _rewrite_prefix(node, old: str, new: str) -> None:
    """In-place: every string leaf equal to ``old`` or under ``old``/...
    gets the prefix swapped for ``new``."""
    if isinstance(node, Mapping):
        items = node.items()
    elif isinstance(node, list):
        items = enumerate(node)
    else:
        return
    for key, val in items:
        if isinstance(val, str) and (
                val == old or val.startswith(old.rstrip("/") + "/")):
            node[key] = new + val[len(old):]
        else:
            _rewrite_prefix(val, old, new)


def setup_run_dir(cfg, job_name: str = "train",
                  overrides: list[str] | None = None,
                  multirun_dir: str | None = None,
                  job_num: int | None = None) -> str | None:
    """Hydra run-dir management analogue (reference
    configs/hydra/default.yaml:9-21): point ``paths.output_dir`` (and the
    derived ``paths.ckpt_dir``) at a fresh dated run directory from
    ``cfg.hydra.run.dir``, attach a per-run job log file
    (``<run_dir>/<job_name>.log``), and snapshot the composed config +
    overrides into ``<run_dir>/.hydra/`` the way hydra does.

    An explicit ``paths.output_dir=...`` command-line override opts out
    (the user pinned the dir; nothing is redirected), mirroring hydra where
    a CLI override of the interpolated path wins. Returns the active output
    dir, or None when the ``hydra`` group is absent (hydra=null).

    Multirun trials pass ``multirun_dir`` (the sweep dir, frozen across
    trials) and ``job_num``: the trial lands in ``<sweep_dir>/<job_num>``
    (reference ``sweep.subdir: ${hydra.job.num}``).
    """
    explicit = any(o.split("=", 1)[0].lstrip("+") == "paths.output_dir"
                   for o in (overrides or []))
    hydra_cfg = cfg.get("hydra") if hasattr(cfg, "get") else None
    paths = cfg.get("paths") if hasattr(cfg, "get") else None
    if hydra_cfg is None or paths is None or explicit:
        return paths.get("output_dir") if paths else None

    if multirun_dir is not None:
        run_dir = os.path.join(multirun_dir, str(job_num or 0))
    else:
        run_dir = hydra_cfg["run"]["dir"]
    # de-collide runs launched within the same second (the template's finest
    # granularity): numeric suffix like hydra's job-id disambiguation
    base, n = run_dir, 1
    while os.path.exists(run_dir):
        run_dir = f"{base}_{n}"
        n += 1
    os.makedirs(run_dir)

    old_out = paths.get("output_dir")
    # rewrite EVERY string leaf that interpolated ${paths.output_dir}
    # (paths.ckpt_dir, callbacks.model_checkpoint.dirpath, ...) — hydra
    # resolves ${hydra:runtime.output_dir} late, so all derived paths follow
    # the run dir; this compose grammar resolves early, so follow up here
    if old_out:
        _rewrite_prefix(cfg, str(old_out), run_dir)
    paths["output_dir"] = run_dir

    if (hydra_cfg.get("job_logging") or {}).get("file", True):
        from videotgb_torch.utils.logging import (add_file_handler,
                                                  remove_file_handler)

        # one job log per run: a previous run's handler (same process:
        # repeated main calls, tests) must not keep receiving its records
        prev = getattr(setup_run_dir, "_handler", None)
        if prev is not None:
            remove_file_handler(prev)
        setup_run_dir._handler = add_file_handler(
            os.path.join(run_dir, f"{job_name}.log"))

    # .hydra/ snapshot: composed config + raw overrides (hydra writes
    # config.yaml/overrides.yaml per run)
    try:
        from videotgb_torch.config import to_dict
        from videotgb_torch.config.yaml_lite import dump

        snap = os.path.join(run_dir, ".hydra")
        os.makedirs(snap, exist_ok=True)
        with open(os.path.join(snap, "config.yaml"), "w") as f:
            f.write(dump(to_dict(cfg)))
        with open(os.path.join(snap, "overrides.yaml"), "w") as f:
            f.write(dump(list(overrides or [])))
    except (OSError, TypeError, ValueError):  # best-effort; never blocks the run
        log.warning("could not write .hydra config snapshot", exc_info=True)
    log.info("run dir: %s", run_dir)
    return run_dir


def apply_extras(cfg) -> None:
    """Apply the ``extras`` config group before a task runs (reference
    src/utils/utils.py:12-40 ``extras()``): ``ignore_warnings`` silences the
    python warnings module, ``enforce_tags`` requires a non-empty ``tags``
    list, ``print_config`` prints the composed tree."""
    import warnings

    from videotgb_torch.utils.logging import print_config_tree

    extras = cfg.get("extras") if hasattr(cfg, "get") else None
    if extras is None:
        extras = {}
    if extras.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if extras.get("enforce_tags") and not cfg.get("tags"):
        raise ValueError("extras.enforce_tags is set but cfg.tags is empty "
                         "(reference src/utils/utils.py enforce_tags)")
    if extras.get("print_config", True):
        print_config_tree(cfg)
