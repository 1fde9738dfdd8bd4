"""Training entry point: ``python -m videotgb_torch.train experiment=...``
(counterpart of ``videotgb_tpu/train.py``; reference src/train.py:35-132).

Composes the run config from the repo's ``configs/`` tree (the same
override grammar: ``experiment=smoke_e2e_synthetic``, ``trainer=cpu``,
``model.optimizer.lr=1e-4``), builds the data, the model with random
weights from ``seed``, the recipe and the trainer, fits with evaluation,
checkpoints and early stopping, and optionally tests the best checkpoint::

    python -m videotgb_torch.train experiment=smoke_tg_synthetic trainer=cpu
    python -m videotgb_torch.train experiment=smoke_e2e_synthetic \\
        model.preset=flagship            # on the CUDA card

The run goes to the CUDA card unless ``trainer.platform=cpu`` (``trainer=cpu``
sets it); without a card that raises. The ported recipes are the
BLIP2-Flan-T5 TG and E2E stages; SF, IV, IVT, LoRA, the InstructBLIP
backbones and parallel layouts raise ``NotImplementedError`` naming their
ROADMAP.md item. ``ckpt_path=<dir>`` resumes the full training state
(parameters, optimizer moments, step) or warm-starts from parameters only.

Unlike the JAX CLI, the port takes no batch from the train loader to
initialise parameters, so its first epoch is the loader's first (shuffled
from ``seed + 1``) where the JAX CLI's is its second.

``build_model`` and ``build_recipe`` take the keys of a
``configs/model/*.yaml`` group as a plain dict, for use from Python::

    model, cfg = build_model({"preset": "tiny"}, device="cpu")
    recipe = build_recipe({"recipe": "e2e", "selection": "uniform"})
    trainer = Trainer(TrainerConfig(max_steps=10), recipe.loss_fn,
                      recipe.filter_fn)
    state = trainer.init_state(model)
    state, metrics = trainer.train_step(state, batch)
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from videotgb_torch.config import Config, compose
from videotgb_torch.device import resolve_device
from videotgb_torch.models.videotgb import VideoTGB, VideoTGBConfig
from videotgb_torch.training.recipes import RECIPES
from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.train")

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

# recipes of the JAX package that the port does not have yet
_NOT_PORTED = {
    "sf": "the SF recipe is ROADMAP.md queue 1 item 5",
    "iv": "the IV recipe is ROADMAP.md queue 1 item 4",
    "ivt": "the IVT recipe (with LoRA) is ROADMAP.md queue 1 item 5",
}


def build_model(model_cfg: dict, device=None, seed: int = 0):
    """(VideoTGB with random weights from ``seed``, its config). ``preset``
    is tiny / small / flagship; the backbone is blip2 (BLIP2-Flan-T5), the
    one the ported recipes train. ``device=None`` means the CUDA device."""
    backbone = model_cfg.get("backbone", "blip2")
    if backbone != "blip2":
        raise NotImplementedError(
            f"training the {backbone!r} backbone is not ported: the "
            "InstructBLIP training forward is ROADMAP.md queue 1 item 4")
    if model_cfg.get("lora_rank"):
        raise NotImplementedError(
            "LoRA adapters are not ported: ROADMAP.md queue 1 item 5")
    mcfg = getattr(VideoTGBConfig, model_cfg.get("preset", "flagship"))()
    return VideoTGB(mcfg, device=device, seed=seed), mcfg


def build_recipe(model_cfg: dict):
    name = model_cfg.get("recipe", "tg")
    if name not in RECIPES:
        raise NotImplementedError(
            f"recipe {name!r} is not ported yet: "
            f"{_NOT_PORTED.get(name, 'unknown recipe')} "
            f"(ported: {sorted(RECIPES)})")
    kwargs = {}
    if model_cfg.get("tgb_mode"):
        kwargs["mode"] = model_cfg["tgb_mode"]
    if name == "e2e" and model_cfg.get("selection"):
        kwargs["selection"] = model_cfg["selection"]
    return RECIPES[name](**kwargs)


def run_device(cfg: Config) -> torch.device:
    """The device of a run from ``trainer.platform`` ("cpu"; unset or
    "cuda"/"gpu" for the card, which must exist) after checking that the
    parallel layout is one process on one device."""
    tcfg = cfg.get("trainer") or Config()
    layout = {k: tcfg.get(k, 1) for k in ("dp", "fsdp", "tp", "pp", "sp")}
    if (layout["dp"] not in (-1, 1)
            or any(layout[k] != 1 for k in ("fsdp", "tp", "pp", "sp"))
            or int(tcfg.get("devices", 1)) > 1):
        raise NotImplementedError(
            f"parallel layout {layout} on {tcfg.get('devices', 1)} devices: "
            "the port trains on one device; data, FSDP, tensor, pipeline and "
            "sequence parallelism are ROADMAP.md queue 1 item 7")
    platform = tcfg.get("platform")
    if platform in (None, "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the run wants a CUDA device and none is available; set "
                "trainer.platform=cpu (or trainer=cpu) to train on the CPU")
        return resolve_device(None)
    if platform == "cpu":
        return resolve_device("cpu")
    raise ValueError(f"trainer.platform={platform!r}: the port runs on "
                     "'cuda' (the default) or 'cpu'")


def apply_callbacks(cfg: Config, tcfg) -> dict:
    """Map the ``callbacks`` config group (reference
    configs/callbacks/{default,model_checkpoint,early_stopping}.yaml) onto the
    trainer: early_stopping -> TrainerConfig monitor/mode/patience,
    model_checkpoint.every_n_train_steps -> checkpoint_every. Returns the
    None-stripped model_checkpoint knobs for CheckpointConfig.

    Monitor precedence: an explicit ``trainer.monitor`` key (every
    configs/trainer/*.yaml sets one; experiment overlays override it) wins
    over the callbacks group's monitor — the two sources agree in every
    shipped config, so this only matters for hand-rolled configs where the
    trainer key is the established knob."""
    cbs = cfg.get("callbacks") or Config()
    mc = {k: v for k, v in (cbs.get("model_checkpoint") or {}).items()
          if v is not None}
    es = {k: v for k, v in (cbs.get("early_stopping") or {}).items()
          if v is not None}
    monitor = es.get("monitor", mc.get("monitor"))
    if monitor == "???":
        raise ValueError("callbacks.early_stopping.monitor must be set "
                         "(reference configs/callbacks/early_stopping.yaml)")
    trainer_has_monitor = "monitor" in (cfg.get("trainer") or {})
    if monitor and not trainer_has_monitor:
        tcfg.monitor = monitor
        tcfg.monitor_mode = es.get("mode", mc.get("mode", tcfg.monitor_mode))
    if es:
        tcfg.early_stop_patience = es.get("patience",
                                          tcfg.early_stop_patience)
    if mc.get("every_n_train_steps"):
        tcfg.checkpoint_every = mc["every_n_train_steps"]
    ms = cbs.get("model_summary")
    if ms is not None:
        tcfg.model_summary_depth = (ms or {}).get("max_depth", 1)
    if "rich_progress_bar" in cbs:
        tcfg.progress_bar = True
    return mc


def build_data(cfg: Config, mcfg):
    """(train loader, val loader, tokenizer) of ``data.name`` synthetic or
    videoinstruct; the image/video instruction mixes (iv, ivt) come with
    the IV recipe (ROADMAP.md queue 1 item 4)."""
    from videotgb_torch.data.datasets import (
        SyntheticVideoQA, VideoInstructDataset, collate_videoinstruct,
    )
    from videotgb_torch.data.loader import PrefetchLoader
    from videotgb_torch.data.tokenizer import load_tokenizer

    dcfg = cfg.data
    kind = dcfg.get("name", "synthetic")
    if kind in ("iv", "ivt"):
        raise NotImplementedError(
            f"data.name={kind}: the image/video instruction data comes with "
            "the IV recipe, ROADMAP.md queue 1 item 4")
    tok = load_tokenizer(dcfg.get("tokenizer"))
    sampler_tok = load_tokenizer(dcfg.get("sampler_tokenizer"))
    common = dict(
        num_frames=mcfg.num_frames,
        max_flow_len=dcfg.get("max_flow_len", 64),
        nframe=mcfg.nframe,
        image_size=mcfg.vit.image_size,
    )
    if kind == "synthetic":
        train_ds = SyntheticVideoQA(
            length=dcfg.get("train_size", 64),
            flow_size=mcfg.tgb.flow_size,
            flow_len_range=tuple(dcfg.get("flow_len_range", (8, 64))),
            seed=cfg.get("seed", 0), **common)
        val_ds = SyntheticVideoQA(
            length=dcfg.get("val_size", 16), flow_size=mcfg.tgb.flow_size,
            flow_len_range=tuple(dcfg.get("flow_len_range", (8, 64))),
            seed=cfg.get("seed", 0) + 1, **common)
    elif kind == "videoinstruct":
        train_ds = VideoInstructDataset(
            dcfg.text_dir, dcfg.video_dir, dcfg.of_dir, split="train", **common)
        val_ds = VideoInstructDataset(
            dcfg.text_dir, dcfg.video_dir, dcfg.of_dir, split="val", **common)
    else:
        raise ValueError(f"unknown data.name {kind}")

    def collate(samples):
        return collate_videoinstruct(
            samples, tok, sampler_tok,
            max_flow_len=common["max_flow_len"],
            max_txt_len=dcfg.get("max_txt_len", 128),
            nframe=mcfg.nframe,
            answer_len=dcfg.get("answer_len", 32),
        )

    loader_kw = dict(
        batch_size=dcfg.get("batch_size", 2),
        collate_fn=collate,
        num_workers=dcfg.get("num_workers", 8),
        seed=cfg.get("seed", 0),
    )
    return (PrefetchLoader(train_ds, shuffle=True, **loader_kw),
            PrefetchLoader(val_ds, shuffle=False, **loader_kw), tok)


@torch.no_grad()
def evaluate_tg(model, recipe, loader) -> dict[str, float]:
    """TG-stage validation: span IoU metrics, dropout off
    (reference: LSTP_TG_blip2_module.py:397-451)."""
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.training import metrics as M

    iou_state = M.iou_init()
    loss_state = M.mean_init()
    for batch in loader:
        db = device_batch(batch, model.device)
        loss, aux = recipe.loss_fn(model, db, None, deterministic=True)
        iou_state = M.iou_update(
            iou_state, aux["start_logits"], aux["end_logits"],
            db["starts"], db["ends"])
        loss_state = M.mean_update(loss_state, loss)
    iou, iou3, iou5 = M.iou_compute(iou_state)
    return {
        "val/loss": float(M.mean_compute(loss_state)),
        "val/iou_score": float(iou),
        "val/iou_3": float(iou3),
        "val/iou_5": float(iou5),
    }


@torch.no_grad()
def evaluate_generative(model, recipe, loader, tok,
                        max_new_tokens: int = 16) -> dict[str, float]:
    """E2E validation: the eval loss (dropout off), then greedy
    ``generate_blip2`` answers scored with BLEU-1 — the reference's val/score
    monitor (LSTP_SF_blip2_module.py:107-119,560-584). Every batch draws its
    selection noise from a generator seeded 0, as the JAX eval takes
    ``jax.random.key(0)``."""
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.models.videotgb import generate_blip2
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.training import metrics as M

    t5cfg = model.config.blip2.t5
    dcfg = DecodeConfig(max_new_tokens=max_new_tokens,
                        eos_token_id=t5cfg.eos_token_id,
                        pad_token_id=t5cfg.pad_token_id)
    dev = model.device

    def generator():
        return torch.Generator(device=dev).manual_seed(0)

    loss_state = M.mean_init()
    loss_batches = 0
    preds: list[str] = []
    targets: list[str] = []
    for batch in loader:
        db = device_batch(batch, dev)
        loss, _ = recipe.loss_fn(model, db, generator(), deterministic=True)
        loss_state = M.mean_update(loss_state, loss)
        loss_batches += 1
        tokens, _ = generate_blip2(model, db, dcfg, generator())
        preds.extend(tok.batch_decode(tokens.cpu().numpy(),
                                      skip_special_tokens=True))
        targets.extend(a.replace(" </s>", "") for a in batch["_text_answer"])
    out = ({"val/loss": float(M.mean_compute(loss_state))}
           if loss_batches else {})
    if preds:
        out["val/score"] = M.bleu1(preds, targets)
    return out


def evaluate_recipe(cfg: Config, model, recipe, loader, tok
                    ) -> dict[str, float]:
    """``evaluate_tg`` for the TG recipe, else ``evaluate_generative``."""
    if cfg.model.get("recipe", "tg") == "tg":
        return evaluate_tg(model, recipe, loader)
    return evaluate_generative(model, recipe, loader, tok,
                               max_new_tokens=cfg.model.get("eval_max_new", 16))


def train(cfg: Config) -> dict[str, float]:
    with torch.autograd.set_detect_anomaly(bool(cfg.get("debug_nans"))):
        return _train(cfg)


def _train(cfg: Config) -> dict[str, float]:
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, resolve_ckpt_path, restore_into,
        train_state_items,
    )
    from videotgb_torch.training.trainer import Trainer, TrainerConfig
    from videotgb_torch.utils.writers import build_writers

    seed = cfg.get("seed", 42)
    device = run_device(cfg)
    recipe = build_recipe(cfg.model)
    model, mcfg = build_model(cfg.model, device=device, seed=seed)
    train_loader, val_loader, tok = build_data(cfg, mcfg)
    if len(train_loader) == 0:
        raise ValueError(f"the train loader has no batch: data.train_size < "
                         f"data.batch_size ({cfg.data.get('batch_size')})")

    tcfg_raw = cfg.get("trainer", Config())
    max_steps = tcfg_raw.get("max_steps",
                             tcfg_raw.get("max_epochs", 1) * len(train_loader))
    tcfg = TrainerConfig(
        max_steps=max_steps,
        lr=cfg.model.get("optimizer", Config()).get("lr", 5e-5),
        weight_decay=cfg.model.get("optimizer", Config()).get("weight_decay", 0.0),
        warmup_ratio=cfg.model.get("scheduler", Config()).get("warmup", 0.05),
        accumulate_grad_batches=tcfg_raw.get("accumulate_grad_batches", 1),
        steps_per_dispatch=tcfg_raw.get("steps_per_dispatch", 1),
        log_every=tcfg_raw.get("log_every", 10),
        eval_every=tcfg_raw.get("eval_every", max(max_steps // 4, 1)),
        monitor=tcfg_raw.get("monitor", "val/iou_score"),
        seed=seed,
    )
    ckpt_overrides = apply_callbacks(cfg, tcfg)
    trainer = Trainer(tcfg, recipe.loss_fn, recipe.filter_fn)
    out_dir = cfg.get("paths", Config()).get("output_dir", "outputs")
    trainer.writers = build_writers(cfg.get("loggers", ["csv"]), out_dir)
    trainer.writers.log_hyperparams({"config": dict(cfg)})
    state = trainer.init_state(model)

    ckpt_dir = ckpt_overrides.get(
        "dirpath") or cfg.get("paths", Config()).get("ckpt_dir",
                                                     "outputs/checkpoints")
    ckpt = CheckpointManager(CheckpointConfig(
        directory=ckpt_dir,
        monitor=tcfg.monitor,
        mode=ckpt_overrides.get("mode", tcfg.monitor_mode),
        max_to_keep=ckpt_overrides.get("save_top_k", 1),
        save_last=ckpt_overrides.get("save_last", True)))
    if cfg.get("ckpt_path"):
        root, step = resolve_ckpt_path(str(cfg.ckpt_path))
        src = (ckpt if os.path.abspath(root) == os.path.abspath(ckpt_dir)
               else CheckpointManager(CheckpointConfig(directory=root,
                                                       monitor=tcfg.monitor)))
        step = step if step is not None else src.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
        if "opt_state" in src.item_names(step):
            # full-state resume: optimizer moments + schedule position
            # continue exactly (reference trainer.fit(ckpt_path=...) semantics)
            state.step = restore_into(src.restore(step), state.model,
                                      state.optimizer)
            log.info("resumed full train state from %s @ step %d", root, step)
        else:
            # params-only source: warm start
            restore_into(src.restore(step, items=["params"]), state.model)
            log.info("warm-started params from %s @ step %d", root, step)

    def eval_fn(state):
        return evaluate_recipe(cfg, state.model, recipe, val_loader, tok)

    def checkpoint_fn(state, metrics):
        ckpt.save(state.step, train_state_items(state), metrics)

    def batches():
        step = 0
        while step < tcfg.max_steps:
            for batch in train_loader:
                yield device_batch(batch, device)
                step += 1
                if step >= tcfg.max_steps:
                    return

    # debug=profiler overlay (reference configs/debug/profiler.yaml:
    # trainer.profiler="simple"): trace the whole max_steps-bounded fit
    prof_cfg = cfg.get("profiler")
    if prof_cfg is not None:
        from videotgb_torch.utils.profiling import trace

        trace_dir = (prof_cfg.get("trace_dir") if isinstance(prof_cfg, dict)
                     else None) or os.path.join(out_dir, "trace")
        prof_ctx = trace(trace_dir, device)
    else:
        prof_ctx = contextlib.nullcontext()

    try:
        with prof_ctx:
            state = trainer.fit(state, batches(), eval_fn=eval_fn,
                                checkpoint_fn=checkpoint_fn)
        final = eval_fn(state)
        checkpoint_fn(state, final)
        ckpt.wait()
        log.info("final metrics: %s", final)

        if cfg.get("test"):
            # reference: trainer.test on the best checkpoint after fit
            # (src/train.py:91-98); its parameters replace the live ones
            best = ckpt.best_step()
            if best is not None:
                restore_into(ckpt.restore(best, items=["params"]), model)
                test_metrics = {
                    f"test{k[3:]}" if k.startswith("val") else k: v
                    for k, v in eval_fn(state).items()}
                log.info("test metrics (best ckpt @%d): %s", best,
                         test_metrics)
                final.update(test_metrics)
    finally:
        trainer.writers.finish()
    return final


def main(argv: list[str] | None = None) -> dict[str, float]:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "train", argv)
    from videotgb_torch.utils.task import apply_extras, setup_run_dir

    setup_run_dir(cfg, job_name="train", overrides=argv)
    apply_extras(cfg)
    return train(cfg)


if __name__ == "__main__":
    main()
