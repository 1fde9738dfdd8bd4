"""RAFT correlation-lookup probe: kernel B against the query-blocked kernel E.

The counterpart of the JAX package's ``tools/lookupprobe.py``. The same
function (the radius-4 windowed bilinear lookup on the query-minor pyramid)
read two ways, at the probe's shapes (pairs x 28x28 feature maps, 256
channels, 4 levels, bf16):

  base      kernel B (``csrc/corr_lookup.cu``) as the RAFT path runs it:
            on the probe's pyramids its tile body, whose block of queries
            stages the scanlines they reach by TMA
  qblock    kernel E (``csrc/corr_lookup_blocked.cu``, a thin entry over the
            same tile body): a block of ``qb`` queries streams every
            scanline of each level through shared memory
  qskip     kernel E streaming only the scanlines its block's queries reach
            (``skip=True``)

Coordinates: "raft" (the pixel grid plus N(0, 2) flow, the GRU's steady
state; partly off the map at the borders) and "wild" (uniform over the map,
the worst case for skipping). Each line gives the median ms of ``--loop``
chained lookups (the coordinates drift by 0.13 per lookup, as a refine's
do) and the max abs error against the plain version on 2 pairs.

    python -m videotgb_torch.tools.lookupprobe [--pairs 256] [--hw 28]
        [--iters 5] [--qb 128] [--loop 20] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.ops import kernels
from videotgb_torch.ops.correlation_pallas import (
    _DTYPE_CODES,
    build_corr_pyramid_t,
    lookup_corr_pyramid_t,
    lookup_corr_pyramid_t_plain,
    lookup_launch_args,
    lookup_tile,
)
from videotgb_torch.tools import timed


def blocked_lookup_cuda(pyramid_t, coords, radius: int = 4, qb: int = 128,
                        skip: bool = False):
    """Launch ``corr_lookup_blocked`` on CUDA tensors: the tile body with
    ``qb`` queries a block and :func:`lookup_tile`'s stages for it."""
    if qb % 32 or not 32 <= qb <= 128:
        raise ValueError(f"blocked lookup: qb {qb}; a multiple of 32 up to "
                         "128")
    if not 0 <= radius <= 4:
        raise ValueError(f"blocked lookup: radius {radius}; 0 to 4")
    out, args, _keep = lookup_launch_args("blocked lookup", pyramid_t,
                                          coords, radius)
    _, h, w, _ = coords.shape
    elem = out.element_size()
    if (h * w * elem) % 16 or any(lvl.data_ptr() % 16 for lvl in pyramid_t):
        raise ValueError(f"blocked lookup: {h * w} queries; the kernel copies "
                         f"16 aligned bytes of queries at a time, so a "
                         f"multiple of {16 // elem}")
    tile = lookup_tile(coords.shape[0], h, w, len(pyramid_t), radius,
                       out.dtype, qb=qb)
    if tile is None:
        raise ValueError(f"blocked lookup: a block of {qb} queries on a "
                         f"{h} x {w} map does not fit the kernel's shared "
                         "memory")
    lib = kernels.library("corr_lookup_blocked")
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    rc = lib.corr_lookup_blocked(*args, qb, int(skip), tile.stage_bytes,
                                 _DTYPE_CODES[out.dtype], stream)
    kernels.check_launch("corr_lookup_blocked", rc)
    kernels.count("corr_lookup_blocked", "tile")
    return out


def blocked_lookup(pyramid_t, coords, radius: int = 4, qb: int = 128,
                   skip: bool = False):
    """Windowed bilinear lookup, blocked over ``qb`` queries: coords
    (P, H, W, 2) pixel (x, y) on the query-minor pyramid ->
    (P, H, W, L*(2r+1)^2) in the pyramid's dtype.

    Kernel E on CUDA tensors; ``skip`` streams only the scanlines the
    block's queries touch (the same kernel, a narrower window, the same
    result). On CPU tensors the plain version, which ``qb`` and ``skip`` do
    not change."""
    pyramid_t = list(pyramid_t)
    if coords.device.type == "cpu":
        return lookup_corr_pyramid_t_plain(pyramid_t, coords, radius)
    return blocked_lookup_cuda(pyramid_t, coords, radius, qb, skip)


def make_pyramid(pairs: int, hw: int, dtype, device, generator):
    """The probe's pyramid: two random (pairs, hw, hw, 256) feature maps."""
    f1, f2 = (torch.randn((pairs, hw, hw, 256), generator=generator,
                          device=device).to(dtype) for _ in range(2))
    return build_corr_pyramid_t(f1, f2, 4)


def make_coords(pairs: int, hw: int, device, generator) -> dict:
    """The probe's two coordinate sets, (pairs, hw, hw, 2) pixel (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(hw, device=device),
                            torch.arange(hw, device=device), indexing="ij")
    grid = torch.stack([gx, gy], -1)[None].float()
    return {
        "raft": grid + 2.0 * torch.randn((pairs, hw, hw, 2),
                                         generator=generator, device=device),
        "wild": torch.rand((pairs, hw, hw, 2), generator=generator,
                           device=device) * (hw - 1),
    }


def chained(lookup, pyramid_t, coords, n_loop: int):
    """``n_loop`` lookups with the coordinates drifting by 0.13 each; the
    f32 sum of every output, so that none is dead work."""
    acc = torch.zeros((), device=coords.device)
    for _ in range(n_loop):
        acc = acc + lookup(pyramid_t, coords).sum(dtype=torch.float32)
        coords = coords + 0.13
    return acc


def report(name, sec, extra=None):
    line = f"{name:24s} {sec * 1000:9.2f} ms"
    if extra:
        line += "  " + " ".join(f"{k}={v}" for k, v in extra.items())
    print(line, flush=True)


def variants(qb: int) -> dict:
    return {
        "base": lambda p, c: lookup_corr_pyramid_t(p, c),
        "qblock": lambda p, c: blocked_lookup(p, c, qb=qb),
        "qskip": lambda p, c: blocked_lookup(p, c, qb=qb, skip=True),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--hw", type=int, default=28)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--qb", type=int, default=128)
    ap.add_argument("--loop", type=int, default=20,
                    help="chained lookups per timed run (GRU iterations)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    pyr = make_pyramid(args.pairs, args.hw, torch.bfloat16, dev, gen)
    results = {}
    for cname, coords in make_coords(args.pairs, args.hw, dev, gen).items():
        print(f"--- coords = {cname} (x{args.loop} chained lookups) on "
              f"{dev}", flush=True)
        pyr2 = [lvl[:2] for lvl in pyr]
        ref = lookup_corr_pyramid_t_plain(pyr2, coords[:2]).float()
        for name, fn in variants(args.qb).items():
            err = float((fn(pyr2, coords[:2]).float() - ref).abs().max())
            sec = timed(lambda fn=fn: chained(fn, pyr, coords, args.loop),
                        args.iters)
            report(name, sec, {"max_abs_err": f"{err:.2e}"})
            results[(cname, name)] = {"ms": sec * 1e3, "max_abs_err": err}
    return results


if __name__ == "__main__":
    main()
