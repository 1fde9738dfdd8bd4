"""Probe RAFT's feature encoder at the serving batch, stage by stage.

The counterpart of the JAX package's ``tools/raftencprobe.py``. The JAX
benchmark's RAFT batch (64 clips x 4 flow pairs) gives the feature net 512
images at 224^2 and the context net 256, in bf16. It measures (median of
``--iters`` synchronised calls after one warm call; cuDNN convolutions, no
hand-written kernel):

  full    the feature net (instance norm) and the context net (batch norm)
  norm    instance norm at the stage-1 shape (B, 64, 112, 112): two-pass
          mean/var against one-pass E[x^2] - E[x]^2, and their largest
          difference
  stem    the 7x7/s2 stem as a direct convolution and as its exact
          space-to-depth rewrite (2x2 -> 12 channels, a 4x4/s1 convolution
          with the zero-padded, rearranged kernel), and their largest
          difference
  prefix  cumulative prefixes of the real feature net (stem, layer1,
          layer2, layer3, head) and each stage's delta

    python -m videotgb_torch.tools.raftencprobe [--fnet 512] [--cnet 256]
        [--res 224] [--only all|full,norm,stem,prefix] [--iters 5]
        [--device cuda]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from videotgb_torch.device import resolve_device
from videotgb_torch.utils.profiling import timed


def report(name, sec, extra=None) -> None:
    line = f"{name:28s} {sec * 1000:9.3f} ms"
    if extra:
        line += "  " + " ".join(f"{k}={v}" for k, v in extra.items())
    print(line, flush=True)


def inorm_twopass(x):
    x32 = x.float()
    mean = torch.mean(x32, dim=(2, 3), keepdim=True)
    var = torch.var(x32, dim=(2, 3), keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def inorm_onepass(x):
    x32 = x.float()
    mean = torch.mean(x32, dim=(2, 3), keepdim=True)
    meansq = torch.mean(x32 * x32, dim=(2, 3), keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    return ((x32 - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def stem_s2d(stem, a):
    """The 7x7/s2, pad-3 convolution as a 4x4/s1 valid one on the image
    padded by 3 and rearranged 2x2 -> 12 channels: out[y] = sum_{a, p}
    w8[2a + p] * pad[2(y + a) + p], w8 the kernel zero-padded to 8x8."""
    dt = stem.dtype
    w = stem.weight.to(dt)  # (64, 3, 7, 7)
    o, c = w.shape[:2]
    w8 = F.pad(w, (0, 1, 0, 1))
    ws2d = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    ws2d = ws2d.reshape(o, 4 * c, 4, 4)
    ap = F.pad(a.to(dt), (3, 3, 3, 3))
    b, _, hp, wp = ap.shape
    s = ap.reshape(b, c, hp // 2, 2, wp // 2, 2).permute(0, 3, 5, 1, 2, 4)
    s = s.reshape(b, 4 * c, hp // 2, wp // 2)
    return F.conv2d(s, ws2d, stem.bias.to(dt))


def prefix(enc, x, upto: int):
    """The feature net's first ``upto`` stages after the stem (4 = all
    three and the 1x1 head)."""
    x = F.relu(enc.norm1(enc.conv1(x.to(enc.dtype))))
    for i in range(1, min(upto, 3) + 1):
        x = getattr(enc, f"layer{i}_1")(getattr(enc, f"layer{i}_0")(x))
    return enc.conv2(x) if upto >= 4 else x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fnet", type=int, default=512)
    ap.add_argument("--cnet", type=int, default=256)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--only", default="all",
                    help="comma list of: full,norm,stem,prefix")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for small shapes")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))

    def want(sec):
        return "all" in only or sec in only

    from videotgb_torch.models.common import init_params
    from videotgb_torch.models.raft import BasicEncoder

    dev = resolve_device(args.device)
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    b, r = args.fnet, args.res
    img = torch.rand((b, 3, r, r), generator=gen, device=dev) * 2.0 - 1.0
    enc = init_params(BasicEncoder(256, "instance", dt, device=dev), seed=0)
    out = {}

    def t(fn):
        return timed(lambda: fn().float().sum(), iters=args.iters)[0]

    with torch.no_grad():
        if want("full"):
            out["fnet"] = t(lambda: enc(img))
            report(f"fnet_instance_b{b}", out["fnet"])
            encb = init_params(BasicEncoder(256, "batch", dt, device=dev),
                               seed=0)
            imgc = img[: args.cnet]
            out["cnet"] = t(lambda: encb(imgc))
            report(f"cnet_batch_b{args.cnet}", out["cnet"])
        if want("norm"):
            x1 = torch.randn((b, 64, r // 2, r // 2), generator=gen,
                             device=dev).to(dt)
            for name, f in (("inorm_twopass", inorm_twopass),
                            ("inorm_onepass", inorm_onepass)):
                out[name] = t(lambda f=f: f(x1))
                report(f"{name}_{r // 2}", out[name])
            out["inorm_maxdiff"] = float((inorm_onepass(x1).float()
                                          - inorm_twopass(x1).float())
                                         .abs().max())
            report("inorm_maxdiff", 0.0,
                   {"max_abs": f"{out['inorm_maxdiff']:.2e}"})
        if want("stem"):
            out["stem_direct"] = t(lambda: enc.conv1(img))
            report("stem_7x7s2_direct", out["stem_direct"])
            out["stem_s2d"] = t(lambda: stem_s2d(enc.conv1, img))
            out["stem_s2d_maxdiff"] = float(
                (stem_s2d(enc.conv1, img[:2]).float()
                 - enc.conv1(img[:2]).float()).abs().max())
            report("stem_s2d", out["stem_s2d"],
                   {"max_abs": f"{out['stem_s2d_maxdiff']:.2e}"})
        if want("prefix"):
            prev = 0.0
            for upto, name in enumerate(("stem", "layer1", "layer2",
                                         "layer3", "head")):
                sec = t(lambda upto=upto: prefix(enc, img, upto))
                out[f"prefix_{name}"] = sec
                report(f"prefix_{name}", sec,
                       {"delta_ms": round((sec - prev) * 1000, 3)})
                prev = sec
    return out


if __name__ == "__main__":
    main()
