"""RAFT all-pairs correlation volume: build, pyramid, windowed bilinear
lookup (plain PyTorch; the query-minor pyramid and its CUDA lookup kernel
live in :mod:`videotgb_torch.ops.correlation_pallas`).

Layout is channels-last: fmaps (B, H, W, C); coords (B, H, W, 2) as (x, y)
pixel coordinates; lookup output (B, H, W, levels*(2r+1)^2), level-major,
then the x offset, then the y offset (the reference's channel order, which
the motion encoder's 1x1 conv weights depend on).
"""

from __future__ import annotations

import torch


def _pool_levels(first, h, w, num_levels, to_map, from_map):
    """Floor-halving avg-pool pyramid (torch avg_pool2d(2, 2) semantics);
    a 1x1 level repeats instead of halving to 0x0 (tiny shapes only)."""
    pyramid = [first]
    hh, ww = h, w
    for _ in range(num_levels - 1):
        if hh == 1 and ww == 1:
            pyramid.append(pyramid[-1])
            continue
        ph, pw = (2 if hh >= 2 else 1), (2 if ww >= 2 else 1)
        nh, nw = max(hh // 2, 1), max(ww // 2, 1)
        cur = to_map(pyramid[-1], hh, ww)  # (N, hh, ww, X)
        n, x = cur.shape[0], cur.shape[-1]
        cur = cur[:, :nh * ph, :nw * pw]
        cur = cur.reshape(n, nh, ph, nw, pw, x).mean(dim=(2, 4))
        hh, ww = nh, nw
        pyramid.append(from_map(cur, hh, ww))
    return pyramid


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """fmaps (B, H, W, C) -> [(B, H*W, H/2^i, W/2^i)] * num_levels, f32."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).float()
    f2 = fmap2.reshape(b, h * w, c).float()
    corr = torch.matmul(f1, f2.transpose(1, 2))
    corr = corr / torch.sqrt(torch.tensor(float(c)))
    q = h * w

    def to_map(level, hh, ww):  # (B, Q, hh, ww) -> (B*Q, hh, ww, 1)
        return level.reshape(b * q, hh, ww, 1)

    def from_map(cur, hh, ww):
        return cur.reshape(b, q, hh, ww)

    return _pool_levels(corr.reshape(b, q, h, w), h, w, num_levels, to_map,
                        from_map)


def lookup_corr_pyramid_dense(pyramid, coords, radius: int = 4):
    """Windowed bilinear lookup as two dense hat-weight contractions per
    level: out[q, i, j] = sum_{y,x} hat(x - px[q,i]) hat(y - py[q,j])
    corr[q,y,x] with hat(d) = max(0, 1 - |d|), which is grid_sample's
    bilinear sampling with zero padding. pyramid [(B, Q, Hl, Wl)]; coords
    (B, H, W, 2) -> (B, H, W, L*(2r+1)^2) f32."""
    b, h, w, _ = coords.shape
    q = h * w
    k = 2 * radius + 1
    dev = coords.device
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    cx = coords[..., 0].reshape(b, q).float()
    cy = coords[..., 1].reshape(b, q).float()
    outs = []
    for i, corr in enumerate(pyramid):
        scale = 1.0 / (2 ** i)
        hl, wl = corr.shape[2], corr.shape[3]
        px = cx[:, :, None] * scale + offs  # (B, Q, k)
        py = cy[:, :, None] * scale + offs
        xs = torch.arange(wl, dtype=torch.float32, device=dev)
        ys = torch.arange(hl, dtype=torch.float32, device=dev)
        wx = torch.clamp(1.0 - torch.abs(xs - px[..., None]), min=0.0)
        wy = torch.clamp(1.0 - torch.abs(ys - py[..., None]), min=0.0)
        tmp = torch.einsum("bqhw,bqiw->bqhi", corr.float(), wx)
        lvl = torch.einsum("bqjh,bqhi->bqij", wy, tmp)
        outs.append(lvl.reshape(b, q, k * k))
    return torch.cat(outs, dim=-1).reshape(b, h, w, -1)


def bilinear_sample(img, coords):
    """grid_sample(align_corners=True, zeros padding) for NHWC images:
    img (B, H, W, C), coords (B, Ho, Wo, 2) pixel (x, y) -> (B, Ho, Wo, C)."""
    b, h, w, c = img.shape
    _, ho, wo, _ = coords.shape
    cx = coords[..., 0].reshape(b, ho * wo)
    cy = coords[..., 1].reshape(b, ho * wo)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    tx = (cx - x0)[..., None]
    ty = (cy - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def tap(xi, yi):
        valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
        xi_c = torch.clamp(xi, 0, w - 1).long()
        yi_c = torch.clamp(yi, 0, h - 1).long()
        idx = (yi_c * w + xi_c)[..., None].expand(b, ho * wo, c)
        vals = torch.gather(flat, 1, idx)
        return torch.where(valid, vals, torch.zeros((), dtype=vals.dtype,
                                                     device=vals.device))

    out = (tap(x0, y0) * (1 - tx) * (1 - ty)
           + tap(x0 + 1, y0) * tx * (1 - ty)
           + tap(x0, y0 + 1) * (1 - tx) * ty
           + tap(x0 + 1, y0 + 1) * tx * ty)
    return out.reshape(b, ho, wo, c)
