"""Evaluation entry point: ``python -m videotgb_torch.evaluate
ckpt_path=...`` (counterpart of ``videotgb_tpu/evaluate.py``; reference
src/eval.py:33-93).

Composes ``configs/eval.yaml``, restores the checkpoint's parameters into a
model built from the config, runs the recipe's validation loop
(``evaluate_tg`` or ``evaluate_generative``) on the validation split and
reports the metrics under ``test/*``. ``ckpt_path`` is required; it may
name the manager root, its ``best``/``last`` directory or one step
directory. Runs on the CUDA card unless ``trainer.platform=cpu``::

    python -m videotgb_torch.evaluate experiment=smoke_tg_synthetic \\
        trainer=cpu ckpt_path=outputs/checkpoints
"""

from __future__ import annotations

import sys

from videotgb_torch.config import Config, compose
from videotgb_torch.train import CONFIG_DIR
from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.eval")


def evaluate(cfg: Config) -> dict[str, float]:
    from videotgb_torch.train import (build_data, build_model, build_recipe,
                                      evaluate_recipe, run_device)
    from videotgb_torch.training.checkpoint import (CheckpointConfig,
                                                    CheckpointManager,
                                                    resolve_ckpt_path,
                                                    restore_into)

    if cfg.get("ckpt_path") in (None, "???"):
        raise ValueError("ckpt_path is required (reference src/eval.py:42)")
    device = run_device(cfg)
    recipe = build_recipe(cfg.model)
    model, mcfg = build_model(cfg.model, device=device,
                              seed=cfg.get("seed", 42))
    _, val_loader, tok = build_data(cfg, mcfg)

    root, step = resolve_ckpt_path(str(cfg.ckpt_path))
    mgr = CheckpointManager(CheckpointConfig(directory=root))
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    # parameters only: a full train-state checkpoint's optimizer state and
    # step are not read
    restore_into(mgr.restore(step, items=["params"]), model)
    log.info("restored params from %s @ step %d", root, step)

    metrics = evaluate_recipe(cfg, model, recipe, val_loader, tok)
    metrics = {f"test{k[3:]}" if k.startswith("val") else k: v
               for k, v in metrics.items()}
    log.info("test metrics: %s", metrics)
    return metrics


def main(argv: list[str] | None = None) -> dict[str, float]:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "eval", argv)
    from videotgb_torch.utils.task import apply_extras, setup_run_dir

    setup_run_dir(cfg, job_name="eval", overrides=argv)
    apply_extras(cfg)
    return evaluate(cfg)


if __name__ == "__main__":
    main()
