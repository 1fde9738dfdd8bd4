"""Build a model and a recipe from the keys of a ``configs/model/*.yaml``
group, given as a plain dict (counterpart of ``build_model`` and
``build_recipe`` in ``videotgb_tpu/train.py``)::

    model, cfg = build_model({"preset": "tiny"}, device="cpu")
    recipe = build_recipe({"recipe": "e2e", "selection": "uniform"})
    trainer = Trainer(TrainerConfig(max_steps=10), recipe.loss_fn,
                      recipe.filter_fn)
    state = trainer.init_state(model)
    state, metrics = trainer.train_step(state, batch)
"""

from __future__ import annotations

from videotgb_torch.models.videotgb import VideoTGB, VideoTGBConfig
from videotgb_torch.training.recipes import RECIPES


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
            f"recipe {name!r} is not ported yet (ported: {sorted(RECIPES)})")
    kwargs = {}
    if model_cfg.get("tgb_mode"):
        kwargs["mode"] = model_cfg["tgb_mode"]
    if name == "e2e" and model_cfg.get("selection"):
        kwargs["selection"] = model_cfg["selection"]
    return RECIPES[name](**kwargs)
