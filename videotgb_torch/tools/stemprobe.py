"""Probe RAFT's 7x7/s2 stem: a direct convolution against explicit im2col.

The counterpart of the JAX package's ``tools/stemprobe.py``. The stem has
3 input channels, which leave a direct convolution's products mostly
empty. Variants, on (B, res, res, 3) bf16 images with f32 accumulation
(median of ``--iters`` synchronised calls after one warm call; cuDNN and
cuBLAS, no hand-written kernel):

  direct      ``F.conv2d`` 7x7/s2, pad 3 (the shipped stem)
  im2col      49 strided slices of the padded image concatenated to
              (B, 112, 112, 147), then one (B*112*112, 147) x (147, 64)
              product
  patches49   ``F.unfold`` (torch's own im2col), then the same product

Each variant's largest difference from ``direct`` on two images is
printed beside its time and rate.

    python -m videotgb_torch.tools.stemprobe [--batch 512] [--res 224]
        [--iters 5] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from videotgb_torch.device import resolve_device
from videotgb_torch.utils.profiling import timed

DT = torch.bfloat16


def variants(w, bias, res: int) -> dict:
    """The three stems on NHWC images; ``w`` (7, 7, 3, 64) HWIO."""
    ho = res // 2
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    wmat = w.reshape(147, 64)
    wpatch = w.permute(2, 0, 1, 3).reshape(147, 64)  # (c, kh, kw) order

    def finish(out):
        return (out.float() + bias.float()).to(DT)

    def direct(a):
        out = F.conv2d(a.permute(0, 3, 1, 2), w_oihw, stride=2, padding=3)
        return finish(out.permute(0, 2, 3, 1))

    def im2col(a):
        b = a.shape[0]
        ap = F.pad(a, (0, 0, 3, 3, 3, 3))
        cols = [ap[:, dy:dy + res:2, dx:dx + res:2, :]
                for dy in range(7) for dx in range(7)]
        patches = torch.cat(cols, dim=-1)
        return finish((patches.reshape(-1, 147) @ wmat)
                      .reshape(b, ho, ho, 64))

    def patches49(a):
        b = a.shape[0]
        p = F.unfold(a.permute(0, 3, 1, 2), 7, padding=3, stride=2)
        return finish((p.transpose(1, 2).reshape(-1, 147) @ wpatch)
                      .reshape(b, ho, ho, 64))

    return {"direct": direct, "im2col": im2col, "patches49": patches49}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for small shapes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, res = args.batch, args.res
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((b, res, res, 3))).to(
        dev, DT)
    w = torch.from_numpy(rng.standard_normal((7, 7, 3, 64)) * 0.05).to(dev, DT)
    bias = torch.from_numpy(rng.standard_normal((64,)) * 0.05).to(dev, DT)
    out, ref = {}, None
    flops = b * (res // 2) ** 2 * 147 * 64 * 2
    with torch.no_grad():
        for name, f in variants(w, bias, res).items():
            got = f(img[:2]).float()
            ref = got if ref is None else ref
            err = float((got - ref).abs().max())
            sec = timed(lambda f=f: f(img).float().sum(),
                        iters=args.iters)[0]
            out[name] = {"ms": sec * 1e3, "max_abs_err": err}
            print(f"{name:24s} {sec * 1000:9.3f} ms  max_abs_err={err:.2e} "
                  f"tfs={flops / sec / 1e12:.1f}", flush=True)
    return out


if __name__ == "__main__":
    main()
