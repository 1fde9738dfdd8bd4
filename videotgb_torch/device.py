"""Device choice, numeric flags and per-step generators shared by every
entry point."""

from __future__ import annotations

import os

import numpy as np
import torch


def local_rank() -> int | None:
    """``LOCAL_RANK`` of a multi-process run's environment (this rank's
    card); None in a single process."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    value = os.environ.get("LOCAL_RANK")
    return None if value is None else int(value)


def configure_precision() -> None:
    """Full-f32 products on the card.

    cuDNN runs f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; RAFT's flow is precision-sensitive, so both flags are
    set to False here rather than assumed. bf16 products are unaffected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device: ``cuda:{LOCAL_RANK}`` inside a rank
    of a multi-process run (``torchrun``, ``parallel.distributed.spawn``),
    else the current one; without one this raises instead of falling back
    to the CPU. Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "videotgb_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        rank = local_rank()
        device = "cuda" if rank is None else f"cuda:{rank}"
    device = torch.device(device)
    if device.type == "cuda":
        configure_precision()
    return device


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The random stream of one batch: ``(seed, step)`` mixed by numpy's
    ``SeedSequence`` into the 64-bit seed of a ``torch.Generator`` on
    ``device``. It takes the place of the JAX package's
    ``jax.random.fold_in(jax.random.key(seed), step)``; the draws match
    JAX's in distribution only."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))
