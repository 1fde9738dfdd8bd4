"""LoRA adapters for the frozen LLM towers (counterpart of
``videotgb_tpu/models/lora.py``).

The reference wraps the LLM with peft LoRA in the IVT stage-3 recipes
(reference: src/models/LSTP_Blip2_IVT_module.py:184-188 — r=8, alpha=32,
targeting T5's q/v projections; LSTP_Vicuna_IVT_module.py:182-186 —
q_proj/v_proj). Here, as in the JAX package, LoRA is a low-rank delta added
to the output of an attention's q and v projections:
``y = W x + (alpha / r) * (x A) B``, with A ~ N(0, 0.02) and B = 0, so the
wrapped model starts exactly at the base model.

The adapter's parameters keep the JAX names and layouts, ``lora_a`` (in, r)
and ``lora_b`` (r, out), under a module named ``<q|v>_lora``; so
``videotgb_torch.convert`` carries them across by name and
``training.optim.path_freeze_filter(train_lora_only=True)`` finds them. The
two products are plain ``torch.matmul`` in the attention's compute dtype
(no kernel, also under the W8A8 ``quant`` path).
"""

from __future__ import annotations

import torch
from torch import nn

from videotgb_torch.models.common import _fill_normal, _param


class LoRADelta(nn.Module):
    """The low-rank delta only (added to a base projection's output)."""

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float = 32.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.rank = rank
        self.alpha = alpha
        self.dtype = dtype
        self.lora_a = _param((in_features, rank), param_dtype, device)
        self.lora_b = _param((rank, features), param_dtype, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.lora_a, 0.02, gen)
        with torch.no_grad():
            self.lora_b.zero_()

    def forward(self, x):
        dt = self.dtype
        h = torch.matmul(x.to(dt), self.lora_a.to(dt))
        return (self.alpha / self.rank) * torch.matmul(h, self.lora_b.to(dt))


def lora_param_filter(name: str) -> bool:
    """True for a LoRA adapter parameter (a ``state_dict`` key of the
    port, or a ``/``-joined JAX path), for optimizer masks."""
    return any(part.startswith("lora_")
               for part in name.replace("/", ".").split("."))
