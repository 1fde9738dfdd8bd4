"""ViT-g tower, bf16 against W8A8 int8: the serving path's whole-tower
verdict on the int8 projections.

The counterpart of the JAX package's ``tools/int8probe.py``: the flagship
ViT-g (1408 wide, 39 layers) with the tanh gelu and bf16 parameters, once
in bf16 and once with ``quant="int8"`` (every q/k/v/o and MLP product
through ``ops.quant.int8_matmul``, kernel H on the card), the same weights
from a seed, at ``--batch`` images (``PROBE_BATCH``, default 256: 64 clips
x 4 frames). The JAX probe's scanned and unrolled variants are one thing in
eager PyTorch, so there are two lines, each the mean ms of one tower pass
over ``--iters`` passes queued back to back.

    python -m videotgb_torch.tools.int8probe [--batch 256] [--iters 6]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.models.common import init_params
from videotgb_torch.models.vit import ViTConfig, ViTModel
from videotgb_torch.tools import timed_loop

BASE = ViTConfig(act="gelu_new", param_dtype=torch.bfloat16)  # serving


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("PROBE_BATCH", "256")))
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bf16 = init_params(ViTModel(BASE, device=dev), seed=0)
    int8 = ViTModel(dataclasses.replace(BASE, quant="int8"), device=dev)
    int8.load_state_dict(bf16.state_dict())
    gen = torch.Generator(device=dev).manual_seed(0)
    img = BASE.image_size
    pix = torch.randn((args.batch, img, img, 3), generator=gen,
                      device=dev).to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        for name, model in (("bf16", bf16), ("int8", int8)):
            t = timed_loop(lambda model=model: model(pix), args.iters, dev)
            out[name] = t * 1e3
            print(f"{name}: {t * 1e3:.1f} ms/batch{args.batch} on {dev}",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
