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
and InstructBLIP-Vicuna (``backbone: instructblip``) backbones.

Parallel layouts (the ``trainer`` group's ``dp``, ``fsdp`` and ``sp``; each
rank is one process on one device, ``parallel/``): ``dp: -1`` (the default,
and ``trainer=ddp``, ``ddp_freeze``, ``ddp_spawn``) absorbs the world, the
visible cards or ``trainer.devices`` on the CPU; ``trainer=fsdp`` shards
the parameters over ``fsdp`` ranks (FSDP2); ``trainer=sp`` splits the
towers' token streams over ``sp`` ranks that share their rows
(``parallel/sequence.py``; with a smoke experiment's ``dp: 1``, two ranks,
and ``trainer.dp=2 trainer.sp=2`` four). Under ``torchrun`` every process
joins the launcher's group (NCCL on the card, gloo on the CPU)::

    torchrun --nproc_per_node 4 -m videotgb_torch.train \
        experiment=smoke_e2e_synthetic trainer=ddp

Without a launcher a layout that wants more than one rank is spawned by
``main`` itself (``trainer=ddp_sim``: 2 gloo processes on the CPU), and
``main`` returns rank 0's metrics. ``data.batch_size`` is the global batch;
each rank loads its rows of it, and a step equals the one-device step on
the global batch up to reduction order. ``trainer.pp=2`` trains with the
pp ranks holding the whole model (no config sets a tower's
``scan_layers``, so nothing stages, as in the JAX CLI; a library
``Trainer`` stages ``scan_layers`` towers, ``parallel/pipeline.py``).
``tp`` above 1, ``sp`` beside an ``fsdp`` above 1, and ``pp`` beside a
``tp``, ``fsdp`` or ``sp`` above 1 raise ``NotImplementedError`` naming
their ROADMAP.md items.
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


def run_layout(cfg: Config):
    """The ``MeshConfig`` of the ``trainer`` group's axes (``dp`` defaults
    to -1, the others to 1); ``tp`` above 1, ``sp`` beside an ``fsdp``
    above 1, or ``pp`` beside a ``tp``, ``fsdp`` or ``sp`` above 1 raise
    ``NotImplementedError``."""
    from videotgb_torch.parallel.mesh import MeshConfig, check_ported

    tcfg = cfg.get("trainer") or Config()
    mesh = MeshConfig(dp=tcfg.get("dp", -1), fsdp=tcfg.get("fsdp", 1),
                      tp=tcfg.get("tp", 1), pp=tcfg.get("pp", 1),
                      sp=tcfg.get("sp", 1))
    check_ported(mesh)
    return mesh


def run_world(cfg: Config) -> int:
    """The ranks a run takes: a launcher's ``WORLD_SIZE``; else a ``-1``
    axis absorbs the visible cards (on the card) or ``trainer.devices``
    (on the CPU), and a fixed layout takes dp x fsdp x pp x sp. Raises
    where the layout does not fit that count, or wants more cards than are
    visible."""
    from videotgb_torch.parallel.distributed import env_world

    mesh = run_layout(cfg)
    tcfg = cfg.get("trainer") or Config()
    on_card = tcfg.get("platform") in (None, "cuda", "gpu")
    if env_world() > 1:
        world = env_world()
    elif -1 in (mesh.dp, mesh.fsdp, mesh.pp, mesh.sp):
        world = (torch.cuda.device_count() if on_card
                 else int(tcfg.get("devices", 1)))
        world = max(world, 1)
    else:
        world = mesh.dp * mesh.fsdp * mesh.pp * mesh.sp
    mesh.resolve(world)
    if on_card and world > 1 and env_world() <= 1 and \
            world > torch.cuda.device_count():
        raise ValueError(f"the layout {mesh} takes {world} ranks, one a "
                         f"card, and {torch.cuda.device_count()} are visible")
    return world


def run_device(cfg: Config) -> torch.device:
    """The device of a run from ``trainer.platform`` ("cpu"; unset or
    "cuda"/"gpu" for the card, which must exist: ``cuda:{LOCAL_RANK}``
    inside a rank) after checking the parallel layout (``run_layout``)."""
    run_layout(cfg)
    tcfg = cfg.get("trainer") or Config()
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


def build_data(cfg: Config, mcfg, rank: int = 0, world: int = 1):
    """(train loader, val loader, tokenizer) of ``data.name`` synthetic,
    videoinstruct, or the stage-3 mixes iv / ivt; in a data-parallel run,
    each loader yields rank ``rank``'s rows of every global batch of
    ``data.batch_size`` rows."""
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
        rank=rank,
        world=world,
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


def _summed_over_ranks(losses: list) -> list:
    """Each batch's loss summed over the ranks: the ranks' shares of a
    global batch's loss (``global_count``) add up to it."""
    if not losses:
        return losses
    total = torch.stack(losses)
    torch.distributed.all_reduce(total)
    return list(total)


@torch.no_grad()
def evaluate_tg(model, recipe, loader) -> dict[str, float]:
    """TG-stage validation: span IoU metrics, dropout off
    (reference: LSTP_TG_blip2_module.py:397-451). Under a data-parallel
    split each rank scores its rows; the batch losses and the IoU state are
    summed over the ranks (one copy of each row's: the ``sp`` ranks of a
    position score the same rows), so every rank returns the world-1
    metrics."""
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.parallel.sharding import (copies, first_copy,
                                                  sharded_call, split)
    from videotgb_torch.training import metrics as M

    iou_state = M.iou_init()
    losses = []
    for batch in loader:
        db = device_batch(batch, model.device)
        loss, aux = sharded_call(model, recipe.loss_fn, db, None,
                                 deterministic=True)
        iou_state = M.iou_update(
            iou_state, aux["start_logits"], aux["end_logits"],
            db["starts"], db["ends"])
        losses.append(loss.float())
    if split()[1] * copies() > 1:  # a split over ranks: one copy a row
        if not first_copy():
            iou_state = {k: torch.zeros_like(torch.as_tensor(v))
                         for k, v in iou_state.items()}
        iou_state = M.all_reduce_state(iou_state)
        losses = _summed_over_ranks(losses)
    loss_state = M.mean_init()
    for loss in losses:
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
    ``jax.random.key(0)``. Under a data-parallel split each rank answers
    its rows; the batch losses are summed and the answers and targets
    gathered in the global order before scoring (one copy of each
    position's), so every rank returns the world-1 metrics."""
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.models.videotgb import (generate_blip2,
                                                generate_instructblip,
                                                generate_iv)
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.parallel.distributed import gather_objects
    from videotgb_torch.parallel.sharding import copies, sharded_call, split
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

    losses = []
    preds: list[list[str]] = []  # per batch: this rank's rows
    targets: list[list[str]] = []
    for batch in loader:
        db = device_batch(batch, dev)
        if not isinstance(recipe, SFRecipe) or "scores" in db:
            loss, _ = sharded_call(model, recipe.loss_fn, db, generator(),
                                   deterministic=True)
            losses.append(loss.float())
        if "flow" in db:
            tokens, _ = sharded_call(model, generate, db, dcfg, generator())
        else:  # stage 3: pre-selected frames, no selection
            tokens = sharded_call(model, generate_iv, db, dcfg, generator())
        preds.append(tok.batch_decode(tokens.cpu().numpy(),
                                      skip_special_tokens=True))
        targets.append([a.replace(" </s>", "")
                        for a in batch["_text_answer"]])
    if split()[1] * copies() > 1:
        losses = _summed_over_ranks(losses)
        ranks = gather_objects((preds, targets))[::copies()]
        preds = [[p for r in ranks for p in r[0][i]]
                 for i in range(len(preds))]
        targets = [[t for r in ranks for t in r[1][i]]
                   for i in range(len(targets))]
    loss_state = M.mean_init()
    for loss in losses:
        loss_state = M.mean_update(loss_state, loss)
    preds = [p for rows in preds for p in rows]
    targets = [t for rows in targets for t in rows]
    out = ({"val/loss": float(M.mean_compute(loss_state))}
           if losses else {})
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


@contextlib.contextmanager
def outside_the_step(mesh, model):
    """A pass between steps (an eval, SF's pseudo-label pass) on this
    rank's rows (``batch_split``); on a sharded model its decodes stop
    together on every rank and its graphed calls run eagerly (FSDP2's
    gathers, ``utils.graphs.eager``); on a model staged over ``pp`` every
    rank runs it on the whole stack, the stages gathered for it
    (``parallel.pipeline.whole_stages``; a staged model's graphed calls
    run eagerly), as the JAX trainer's evals run outside the mesh."""
    from videotgb_torch.parallel.pipeline import whole_stages
    from videotgb_torch.parallel.sharding import batch_split, is_sharded
    from videotgb_torch.utils.graphs import eager

    sharded = is_sharded(model)
    with batch_split(mesh, lockstep=sharded), (
            eager() if sharded else contextlib.nullcontext()), whole_stages(
                model, "a pass between steps"):
        yield


def launch(fn, cfg: Config):
    """``fn(cfg)`` at the layout's world: where it wants more than one rank
    and no launcher started them, in ranks spawned here (gloo on the CPU,
    NCCL on the card), returning rank 0's result."""
    from videotgb_torch.parallel.distributed import env_world, spawn
    from videotgb_torch.utils.logging import job_log_paths

    world = run_world(cfg)
    if (world > 1 and env_world() <= 1
            and not torch.distributed.is_initialized()):
        on_cpu = (cfg.get("trainer") or Config()).get("platform") == "cpu"
        return spawn(_in_rank, world, "gloo" if on_cpu else "nccl",
                     args=(fn, cfg, job_log_paths()),
                     device_type="cpu" if on_cpu else "cuda")
    return fn(cfg)


def _in_rank(fn, cfg: Config, job_logs):
    """``fn(cfg)`` in a spawned rank, with the run's job log files attached
    again (a new process has none; rank 0 writes them)."""
    from videotgb_torch.utils.logging import (add_file_handler,
                                              remove_file_handler)

    handlers = [add_file_handler(path) for path in job_logs]
    try:
        return fn(cfg)
    finally:
        for handler in handlers:
            remove_file_handler(handler)


def train(cfg: Config) -> dict[str, float]:
    """Train as ``cfg`` says and return the final metrics (rank 0's, where
    ``launch`` spawns the ranks)."""
    return launch(_train_rank, cfg)


def _train_rank(cfg: Config) -> dict[str, float]:
    with torch.autograd.set_detect_anomaly(bool(cfg.get("debug_nans"))):
        return _train(cfg)


def _train(cfg: Config) -> dict[str, float]:
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.parallel.distributed import (
        barrier, broadcast_object, initialize, is_coordinator)
    from videotgb_torch.parallel.mesh import create_mesh, mesh_rank
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, resolve_ckpt_path, restore_into,
        train_state_items,
    )
    from videotgb_torch.training.trainer import Trainer, TrainerConfig
    from videotgb_torch.utils.writers import build_writers

    seed = cfg.get("seed", 42)
    device = run_device(cfg)
    initialize(device_type=device.type)  # a launcher's ranks join here
    mesh = create_mesh(run_layout(cfg), device_type=device.type)
    rank, world = mesh_rank(mesh)
    tcfg_raw = cfg.get("trainer", Config())
    accum = tcfg_raw.get("accumulate_grad_batches", 1)
    is_sf = cfg.model.get("recipe", "tg") == "sf"
    if is_sf and accum > 1:
        raise ValueError("the SF pseudo-label pass scores one loader batch "
                         "a step: trainer.accumulate_grad_batches must be 1")
    recipe = build_recipe(cfg.model)
    model, mcfg = build_model(cfg.model, device=device, seed=seed)
    train_loader, val_loader, tok = build_data(cfg, mcfg, rank, world)
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
    trainer = Trainer(tcfg, recipe.loss_fn, recipe.filter_fn, mesh=mesh)
    out_dir = cfg.get("paths", Config()).get("output_dir", "outputs")
    trainer.writers = build_writers(cfg.get("loggers", ["csv"]), out_dir)
    trainer.writers.log_hyperparams({"config": dict(cfg)})
    state = trainer.init_state(model)
    if mesh is not None:
        log.info("%d ranks, the %s route; train_step: %s",
                 torch.distributed.get_world_size(), trainer.route,
                 trainer.step_route)

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
        with outside_the_step(mesh, state.model):
            return evaluate_recipe(cfg, state.model, recipe, val_loader, tok)

    def checkpoint_fn(state, metrics):
        items = train_state_items(state)  # a collective under FSDP
        if is_coordinator():
            ckpt.save(state.step, items, metrics)
        barrier()

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
        with outside_the_step(mesh, cur_state.model):
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
            best = broadcast_object(ckpt.best_step())
            if best is not None:
                # the saves are rank 0's: the other ranks read them from disk
                src = ckpt if is_coordinator() else CheckpointManager(
                    ckpt.config)
                restore_into(src.restore(best, items=["params"]), model)
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
    from videotgb_torch.parallel.sharding import sharded_call
    from videotgb_torch.training.metrics import rouge_n
    from videotgb_torch.training.recipes import pseudo_label_generate

    frames = db["frames"]
    b, f = frames.shape[:2]
    ids = sharded_call(
        model, pseudo_label_generate, frames, db["question_ids"],
        db["question_mask"],
        max_new_tokens=max_new_tokens,
        qformer_input_ids=db.get("qformer_input_ids"),
        qformer_attention_mask=db.get("qformer_attention_mask"))
    predictions = tok.batch_decode(ids.cpu().numpy(),
                                   skip_special_tokens=True)
    targets = [text_answers[i // f] for i in range(b * f)]
    scores = torch.tensor(rouge_n(targets, predictions), dtype=torch.float32)
    return scores.reshape(b, f)


def join_launcher(cfg: Config) -> None:
    """Under a launcher (``WORLD_SIZE`` > 1), join its process group on
    the run's device type before the run directory is made."""
    from videotgb_torch.parallel.distributed import env_world, initialize

    if env_world() > 1:
        on_cpu = (cfg.get("trainer") or Config()).get("platform") == "cpu"
        initialize(device_type="cpu" if on_cpu else "cuda")


def main(argv: list[str] | None = None) -> dict[str, float]:
    argv = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "train", argv)
    from videotgb_torch.parallel.distributed import (broadcast_object,
                                                     is_coordinator)
    from videotgb_torch.utils.task import apply_extras, setup_run_dir

    join_launcher(cfg)
    if is_coordinator():  # one run directory, made by rank 0
        setup_run_dir(cfg, job_name="train", overrides=argv)
    cfg = broadcast_object(cfg)
    apply_extras(cfg)
    return train(cfg)


if __name__ == "__main__":
    main()
