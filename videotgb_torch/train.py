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
    python -m videotgb_torch.train experiment=smoke_sf_vicuna_synthetic \\
        trainer=cpu

The run goes to the CUDA card unless ``trainer.platform=cpu`` (``trainer=cpu``
sets it); without a card that raises. Every recipe of the JAX package is
here: TG, SF (self-refinement: a pseudo-label pass with the current
parameters before each step, ``sf_pseudo_scores``), E2E, and stage 3's IV
and IVT (pre-selected frames from the image/video/text instruction mix,
``data.name`` iv / ivt; IVT with ``model.lora_rank`` adapters on the LLM),
on the BLIP2-Flan-T5, InstructBLIP-Flan-T5 (``backbone: instructblip_t5``)
and InstructBLIP-Vicuna (``backbone: instructblip``) backbones; parallel
layouts raise ``NotImplementedError`` naming their ROADMAP.md item.
``ckpt_path=<dir>`` resumes the full training state (parameters, optimizer
moments, step) or warm-starts from parameters only.
``trainer.accumulate_grad_batches=A`` makes each optimizer step of A
consecutive loader batches (Lightning's accumulation), so a step sees A x
``data.batch_size`` rows and an epoch is len(loader) / A steps.

Stage 3 (IV, IVT) uses the whole model as the other recipes do: RAFT and
the TGB are built (from ``seed``) and saved with it, frozen and unused, so a
stage-3 checkpoint also serves the two-phase path through
``evalsuite.inference.load_model``. (The JAX CLI initialises only the
backbone for stage 3.)

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

import numpy as np
import torch

from videotgb_torch.config import Config, compose
from videotgb_torch.device import resolve_device
from videotgb_torch.models.videotgb import VideoTGB, VideoTGBConfig, with_lora
from videotgb_torch.training.recipes import RECIPES
from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.train")

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def build_model(model_cfg: dict, device=None, seed: int = 0):
    """(VideoTGB with random weights from ``seed``, its config). ``preset``
    is tiny / small / flagship; ``backbone`` is blip2 (BLIP2-Flan-T5, the
    default), instructblip_t5 (the T5 composition with the
    instruction-aware Q-Former) or instructblip (Vicuna). ``lora_rank``
    puts LoRA adapters of that rank on the LLM (T5 or LLaMA).
    ``device=None`` means the CUDA device."""
    backbone = model_cfg.get("backbone", "blip2")
    if backbone not in ("blip2", "instructblip_t5", "instructblip"):
        raise ValueError(f"unknown backbone {backbone!r}")
    mcfg = getattr(VideoTGBConfig, model_cfg.get("preset", "flagship"))(
        backbone)
    if model_cfg.get("lora_rank"):
        mcfg = with_lora(mcfg, int(model_cfg["lora_rank"]))
    return VideoTGB(mcfg, device=device, seed=seed), mcfg


def build_recipe(model_cfg: dict):
    name = model_cfg.get("recipe", "tg")
    if name not in RECIPES:
        raise ValueError(f"unknown recipe {name!r} (one of {sorted(RECIPES)})")
    kwargs = {}
    if name in ("tg", "sf", "e2e") and model_cfg.get("tgb_mode"):
        kwargs["mode"] = model_cfg["tgb_mode"]
    if name == "sf" and model_cfg.get("online_flow"):
        kwargs["online_flow"] = True
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
    """(train loader, val loader, tokenizer) of ``data.name`` synthetic,
    videoinstruct, or the stage-3 mixes iv / ivt."""
    from videotgb_torch.data.datasets import (
        SyntheticVideoQA, VideoInstructDataset, collate_videoinstruct,
    )
    from videotgb_torch.data.loader import PrefetchLoader
    from videotgb_torch.data.tokenizer import load_tokenizer

    dcfg = cfg.data
    kind = dcfg.get("name", "synthetic")
    tok = load_tokenizer(dcfg.get("tokenizer"))
    sampler_tok = load_tokenizer(dcfg.get("sampler_tokenizer"))
    common = dict(
        num_frames=mcfg.num_frames,
        max_flow_len=dcfg.get("max_flow_len", 64),
        nframe=mcfg.nframe,
        image_size=mcfg.vit.image_size,
    )
    loader_kw = dict(
        batch_size=dcfg.get("batch_size", 2),
        num_workers=dcfg.get("num_workers", 8),
        seed=cfg.get("seed", 0),
    )
    if kind in ("iv", "ivt"):
        return _stage3_loaders(cfg, mcfg, tok, sampler_tok, loader_kw)
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

    return (PrefetchLoader(train_ds, shuffle=True, collate_fn=collate,
                           **loader_kw),
            PrefetchLoader(val_ds, shuffle=False, collate_fn=collate,
                           **loader_kw), tok)


def _stage3_loaders(cfg: Config, mcfg, tok, sampler_tok, loader_kw):
    """The IV / IVT loaders from the ``text_dir`` layout of the reference
    (ivinstruct_dataset.py:52,202, ivtinstruct_dataset.py:218):
    ``{split}.json`` and ``pseudo_label.json``, and for ivt the text-only
    rows of ``nlp_tune.json``; ``data.text_path`` / ``text_only_path`` /
    ``pseudo_label_path`` override them. The instruction-aware backbones
    read the prompt through the sampler tokenizer (the BERT vocabulary) for
    the Q-Former."""
    from videotgb_torch.data.datasets import IVInstructDataset, collate_iv
    from videotgb_torch.data.loader import PrefetchLoader

    dcfg = cfg.data
    kind = dcfg.name
    image_size = mcfg.vit.image_size
    td = dcfg.get("text_dir")

    def dataset(split):
        text = dcfg.get("text_path") or os.path.join(td, f"{split}.json")
        pseudo = dcfg.get("pseudo_label_path") or (
            os.path.join(td, "pseudo_label.json") if td else None)
        text_only = dcfg.get("text_only_path") or (
            os.path.join(td, "nlp_tune.json") if td else None)
        return IVInstructDataset(
            text, dcfg.image_dir, dcfg.video_dir, split=split,
            nframe=mcfg.nframe, image_size=image_size,
            include_text_only=kind == "ivt", text_only_path=text_only,
            pseudo_label_path=pseudo, seed=cfg.get("seed", 0))

    def collate(samples):
        return collate_iv(
            samples, tok, nframe=mcfg.nframe, image_size=image_size,
            max_txt_len=dcfg.get("max_txt_len", 128),
            answer_len=dcfg.get("answer_len", 32),
            qformer_tokenizer=sampler_tok if mcfg.instruction_aware else None)

    return (PrefetchLoader(dataset("train"), shuffle=True, collate_fn=collate,
                           **loader_kw),
            PrefetchLoader(dataset("val"), shuffle=False, collate_fn=collate,
                           **loader_kw), tok)


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
    """SF/E2E/IV/IVT validation: the eval loss (dropout off), then greedy
    answers (``generate_blip2`` on the T5 backbones, ``generate_instructblip``
    on Vicuna; ``generate_iv`` for a stage-3 batch, which has pre-selected
    frames and no flow) scored with BLEU-1 — the reference's val/score
    monitor
    (LSTP_SF_blip2_module.py:107-119,560-584). An SF batch without pseudo
    scores has no loss (the reference's eval never computes mrc_loss), and
    ``val/loss`` is absent when no batch had one. Every batch draws its
    selection noise from a generator seeded 0, as the JAX eval takes
    ``jax.random.key(0)``."""
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.models.videotgb import (generate_blip2,
                                                generate_instructblip,
                                                generate_iv)
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.training import metrics as M
    from videotgb_torch.training.recipes import SFRecipe

    if model.config.backbone == "blip2":
        t5cfg = model.config.blip2.t5
        eos, pad, generate = (t5cfg.eos_token_id, t5cfg.pad_token_id,
                              generate_blip2)
    else:
        llm = model.config.instructblip.llm
        eos, pad, generate = (llm.eos_token_id, llm.pad_token_id,
                              generate_instructblip)
    dcfg = DecodeConfig(max_new_tokens=max_new_tokens, eos_token_id=eos,
                        pad_token_id=pad)
    dev = model.device

    def generator():
        return torch.Generator(device=dev).manual_seed(0)

    loss_state = M.mean_init()
    loss_batches = 0
    preds: list[str] = []
    targets: list[str] = []
    for batch in loader:
        db = device_batch(batch, dev)
        if not isinstance(recipe, SFRecipe) or "scores" in db:
            loss, _ = recipe.loss_fn(model, db, generator(),
                                     deterministic=True)
            loss_state = M.mean_update(loss_state, loss)
            loss_batches += 1
        if "flow" in db:
            tokens, _ = generate(model, db, dcfg, generator())
        else:  # stage 3: pre-selected frames, no selection
            tokens = generate_iv(model, db, dcfg, generator())
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
    tcfg_raw = cfg.get("trainer", Config())
    accum = tcfg_raw.get("accumulate_grad_batches", 1)
    is_sf = cfg.model.get("recipe", "tg") == "sf"
    if is_sf and accum > 1:
        raise ValueError("the SF pseudo-label pass scores one loader batch "
                         "a step: trainer.accumulate_grad_batches must be 1")
    recipe = build_recipe(cfg.model)
    model, mcfg = build_model(cfg.model, device=device, seed=seed)
    train_loader, val_loader, tok = build_data(cfg, mcfg)
    if len(train_loader) == 0:
        raise ValueError(f"the train loader has no batch: data.train_size < "
                         f"data.batch_size ({cfg.data.get('batch_size')})")

    max_steps = tcfg_raw.get(
        "max_steps",
        max(tcfg_raw.get("max_epochs", 1) * len(train_loader) // accum, 1))
    tcfg = TrainerConfig(
        max_steps=max_steps,
        lr=cfg.model.get("optimizer", Config()).get("lr", 5e-5),
        weight_decay=cfg.model.get("optimizer", Config()).get("weight_decay", 0.0),
        warmup_ratio=cfg.model.get("scheduler", Config()).get("warmup", 0.05),
        accumulate_grad_batches=accum,
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

    def loader_batches():
        while True:
            yield from train_loader

    def batches():
        """Each step's batch: one loader batch, or ``accum`` consecutive
        ones stacked on a new first axis (the trainer's micro-batches)."""
        stream = loader_batches()
        for _ in range(tcfg.max_steps):
            if accum == 1:
                batch = next(stream)
                db = device_batch(batch, device)
                if is_sf:  # the pseudo pass scores against the gold text
                    db["_text_answer"] = batch["_text_answer"]
            else:
                group = [next(stream) for _ in range(accum)]
                db = device_batch({k: np.stack([g[k] for g in group])
                                   for k in group[0]
                                   if isinstance(group[0][k], np.ndarray)},
                                  device)
            yield db

    def sf_scores(cur_state, db):
        db = dict(db)
        answers = db.pop("_text_answer")
        db["scores"] = sf_pseudo_scores(
            cur_state.model, db, answers, tok,
            max_new_tokens=cfg.model.get("pseudo_max_new", 16))
        return db

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
                                checkpoint_fn=checkpoint_fn,
                                batch_transform=sf_scores if is_sf else None)
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


def sf_pseudo_scores(model, db, text_answers, tok,
                     max_new_tokens: int = 16) -> torch.Tensor:
    """The SF scoring pass: per-frame greedy answers with the model's
    current parameters (``pseudo_label_generate``, on the model's device)
    -> decoded on the host -> rouge_n recall against each row's gold
    answer -> scores (B, F) f32 on the host (reference:
    LSTP_SF_blip2_module.py:151-192)."""
    from videotgb_torch.training.metrics import rouge_n
    from videotgb_torch.training.recipes import pseudo_label_generate

    frames = db["frames"]
    b, f = frames.shape[:2]
    ids = pseudo_label_generate(
        model, frames, db["question_ids"], db["question_mask"],
        max_new_tokens=max_new_tokens,
        qformer_input_ids=db.get("qformer_input_ids"),
        qformer_attention_mask=db.get("qformer_attention_mask"))
    predictions = tok.batch_decode(ids.cpu().numpy(),
                                   skip_special_tokens=True)
    targets = [text_answers[i // f] for i in range(b * f)]
    scores = torch.tensor(rouge_n(targets, predictions), dtype=torch.float32)
    return scores.reshape(b, f)


def main(argv: list[str] | None = None) -> dict[str, float]:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "train", argv)
    from videotgb_torch.utils.task import apply_extras, setup_run_dir

    setup_run_dir(cfg, job_name="train", overrides=argv)
    apply_extras(cfg)
    return train(cfg)


if __name__ == "__main__":
    main()
