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
    python -m videotgb_torch.evaluate \\
        experiment=eval_LSTP_instructblipvicuna7b_ivinstruct \\
        ckpt_path=outputs/checkpoints        # a stage-3 (IV) checkpoint

It takes the training CLI's layouts (``videotgb_torch.train``): under
``torchrun`` each rank joins, a ``dp`` / ``fsdp`` / ``sp`` layout of more
ranks is spawned, each rank scores its rows of every validation batch (the
``sp`` ranks of a position split its token streams), and rank 0's metrics
(the world-1 metrics) return.
"""

from __future__ import annotations

import sys

from videotgb_torch.config import Config, compose
from videotgb_torch.train import CONFIG_DIR
from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.eval")


def evaluate(cfg: Config) -> dict[str, float]:
    from videotgb_torch.train import launch

    if cfg.get("ckpt_path") in (None, "???"):
        raise ValueError("ckpt_path is required (reference src/eval.py:42)")
    return launch(_evaluate, cfg)


def _evaluate(cfg: Config) -> dict[str, float]:
    from videotgb_torch.parallel.distributed import initialize
    from videotgb_torch.parallel.mesh import create_mesh, mesh_rank
    from videotgb_torch.parallel.sequence import shard_sp
    from videotgb_torch.parallel.sharding import shard_params
    from videotgb_torch.train import (build_data, build_model, build_recipe,
                                      evaluate_recipe, outside_the_step,
                                      run_device, run_layout)
    from videotgb_torch.training.checkpoint import restore_params

    device = run_device(cfg)
    initialize(device_type=device.type)
    mesh = create_mesh(run_layout(cfg), device_type=device.type)
    recipe = build_recipe(cfg.model)
    model, mcfg = build_model(cfg.model, device=device,
                              seed=cfg.get("seed", 42))
    _, val_loader, tok = build_data(cfg, mcfg, *mesh_rank(mesh))

    # parameters only: a full train-state checkpoint's optimizer state and
    # step are not read
    root, step = restore_params(model, str(cfg.ckpt_path))
    log.info("restored params from %s @ step %d", root, step)
    if mesh is not None and mesh["fsdp"].size() > 1:
        shard_params(model, mesh)
    shard_sp(model, mesh)

    with outside_the_step(mesh, model):
        metrics = evaluate_recipe(cfg, model, recipe, val_loader, tok)
    metrics = {f"test{k[3:]}" if k.startswith("val") else k: v
               for k, v in metrics.items()}
    log.info("test metrics: %s", metrics)
    return metrics


def main(argv: list[str] | None = None) -> dict[str, float]:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "eval", argv)
    from videotgb_torch.parallel.distributed import (broadcast_object,
                                                     is_coordinator)
    from videotgb_torch.train import join_launcher
    from videotgb_torch.utils.task import apply_extras, setup_run_dir

    join_launcher(cfg)
    if is_coordinator():  # one run directory, made by rank 0
        setup_run_dir(cfg, job_name="eval", overrides=argv)
    cfg = broadcast_object(cfg)
    apply_extras(cfg)
    return evaluate(cfg)


if __name__ == "__main__":
    main()
