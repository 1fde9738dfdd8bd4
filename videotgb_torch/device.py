"""Device choice and numeric flags shared by every entry point."""

from __future__ import annotations

import torch


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
    """``None`` means the CUDA device; without one this raises instead of
    falling back to the CPU. Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "videotgb_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        configure_precision()
    return device
