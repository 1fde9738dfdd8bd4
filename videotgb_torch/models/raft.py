"""RAFT optical flow (the frozen flow extractor feeding the TGB).

Counterpart of ``videotgb_tpu/models/raft.py``: BasicEncoder feature and
context nets (instance norm / frozen batch norm), the query-minor
correlation pyramid with its radius-4 lookup (the CUDA kernel on the card),
the motion encoder + separable ConvGRU update run as 20 shared-weight
iterations, and x8 convex upsampling.

The public layout is the JAX package's NHWC: images (B, H, W, 3) in
[0, 255], flow (B, H, W, 2). Inside, convolutions run NCHW through cuDNN.
Parameters are f32; ``RAFTConfig.dtype`` is the convolutions' compute dtype
(bf16 on the serving path); norms and the flow accumulation stay f32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from videotgb_torch.models.common import _fill_normal, _param
from videotgb_torch.ops.correlation import build_corr_pyramid, lookup_corr_pyramid_dense
from videotgb_torch.ops.correlation_pallas import (
    build_corr_pyramid_t,
    lookup_corr_pyramid_t,
)


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    corr_levels: int = 4
    corr_radius: int = 4
    hidden_dim: int = 128
    context_dim: int = 128
    fnet_dim: int = 256
    iters: int = 20
    # False is the only value with a behaviour of its own: the standard
    # pyramid with the dense lookup. None and True both mean the query-minor
    # pyramid with the lookup kernel on CUDA (its plain version on the CPU);
    # True is accepted so that the JAX package's config values carry across.
    # Both paths compute the same function.
    fused_lookup: bool | None = None
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "RAFTConfig":
        return cls(iters=2)


class Conv(nn.Module):
    """Conv2d computing in ``dtype`` with 'same'-style padding k//2 (a flax
    ``nn.Conv`` with explicit padding; for 1x1 kernels 'SAME' is 0 too)."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride = stride
        self.padding = (kh // 2, kw // 2)
        self.dtype = dtype
        self.init_std = 1.0 / math.sqrt(in_ch * kh * kw)  # flax's lecun normal
        self.weight = _param((out_ch, in_ch, kh, kw), param_dtype, device)
        self.bias = _param((out_ch,), param_dtype, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.weight, self.init_std, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.padding)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False), NCHW, single-pass f32 statistics."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        mean = torch.mean(x32, dim=(2, 3), keepdim=True)
        meansq = torch.mean(x32 * x32, dim=(2, 3), keepdim=True)
        var = torch.clamp(meansq - mean * mean, min=0.0)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d in eval mode, NCHW: f32 affine with running stats."""

    def __init__(self, features, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param((features,), torch.float32, device)
        self.bias = _param((features,), torch.float32, device)
        self.running_mean = _param((features,), torch.float32, device)
        self.running_var = _param((features,), torch.float32, device)

    def reset_parameters_from(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        def c(t):
            return t[None, :, None, None]

        y = (x.float() - c(self.running_mean)) * torch.rsqrt(
            c(self.running_var) + self.eps)
        return (y * c(self.weight) + c(self.bias)).to(x.dtype)


def _norm(kind, features, device):
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return FrozenBatchNorm(features, device=device)
    return nn.Identity()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_planes, planes, 3, stride, **kw)
        self.conv2 = Conv(planes, planes, 3, 1, **kw)
        self.norm1 = _norm(norm_fn, planes, device)
        self.norm2 = _norm(norm_fn, planes, device)
        self.downsample = self.norm3 = None
        if stride != 1 or in_planes != planes:
            self.downsample = Conv(in_planes, planes, 1, stride, **kw)
            self.norm3 = _norm(norm_fn, planes, device)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/s2 stem + three residual stages (64, 96, 128; stride 8) + 1x1."""

    def __init__(self, output_dim, norm_fn, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(3, 64, 7, 2, **kw)
        self.norm1 = _norm(norm_fn, 64, device)
        in_planes = 64
        for i, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)]):
            setattr(self, f"layer{i + 1}_0",
                    ResidualBlock(in_planes, dim, norm_fn, stride, **kw))
            setattr(self, f"layer{i + 1}_1",
                    ResidualBlock(dim, dim, norm_fn, 1, **kw))
            in_planes = dim
        self.conv2 = Conv(128, output_dim, 1, **kw)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x.to(self.dtype))))
        for i in range(1, 4):
            x = getattr(self, f"layer{i}_0")(x)
            x = getattr(self, f"layer{i}_1")(x)
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RAFTConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.dtype = cfg.dtype
        corr_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.convc1 = Conv(corr_planes, 256, 1, **kw)
        self.convc2 = Conv(256, 192, 3, **kw)
        self.convf1 = Conv(2, 128, 7, **kw)
        self.convf2 = Conv(128, 64, 3, **kw)
        self.conv = Conv(64 + 192, 126, 3, **kw)

    def forward(self, flow, corr):
        """flow (B, 2, H, W), corr (B, L*81, H, W) -> (B, 128, H, W)."""
        corr = corr.to(self.dtype)
        flow_c = flow.to(self.dtype)
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow_c))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow_c], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        cin = hidden_dim + input_dim
        for suffix, kernel in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{suffix}",
                        Conv(cin, hidden_dim, kernel, **kw))

    def forward(self, h, x):
        h = h.to(self.dtype)
        x = x.to(self.dtype)
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class UpdateBlock(nn.Module):
    """The GRU refinement step whose weights all 20 iterations share."""

    def __init__(self, cfg: RAFTConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.encoder = BasicMotionEncoder(cfg, device=device)
        self.gru = SepConvGRU(cfg.hidden_dim, cfg.context_dim + 128, **kw)
        self.flow_head_conv1 = Conv(cfg.hidden_dim, 256, 3, **kw)
        self.flow_head_conv2 = Conv(256, 2, 3, **kw)
        self.mask_conv1 = Conv(cfg.hidden_dim, 256, 3, **kw)
        self.mask_conv2 = Conv(256, 64 * 9, 1, **kw)

    def forward(self, net, inp, corr, flow):
        """NCHW. Returns (net, delta flow)."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head_conv2(F.relu(self.flow_head_conv1(net)))
        return net, delta

    def mask(self, net):
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)))


def convex_upsample(flow, mask):
    """flow (B, H, W, 2), mask (B, H, W, 64*9) -> (B, 8H, 8W, 2): softmax
    over 9 taps of 8x-scaled 3x3 flow patches."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    padded = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([padded[:, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)], dim=3)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """``forward(image1, image2)`` -> flow (B, H, W, 2);
    ``consecutive(frames (B, L, H, W, 3))`` -> (B, L-1, H, W, 2) with the
    feature net run once over the B*L unique frames."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig(), device=None):
        super().__init__()
        self.config = cfg
        self.fnet = BasicEncoder(cfg.fnet_dim, "instance", cfg.dtype, device)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch",
                                 cfg.dtype, device)
        self.update_block = UpdateBlock(cfg, device)

    @staticmethod
    def _normalize(image):
        """NHWC [0, 255] -> NCHW [-1, 1] f32."""
        return (2.0 * (image.float() / 255.0) - 1.0).permute(0, 3, 1, 2)

    def _refine(self, fmap1, fmap2, image1):
        """fmaps NCHW (B, C, h, w); image1 normalized NCHW."""
        cfg = self.config
        dt = cfg.dtype
        f1 = fmap1.permute(0, 2, 3, 1)
        f2 = fmap2.permute(0, 2, 3, 1)
        fused = cfg.fused_lookup is not False
        if fused:
            pyramid = build_corr_pyramid_t(f1, f2, cfg.corr_levels)
        else:
            pyramid = build_corr_pyramid(f1, f2, cfg.corr_levels)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :cfg.hidden_dim]).to(dt)
        inp = F.relu(cnet[:, cfg.hidden_dim:]).to(dt)

        b, _, h8, w8 = fmap1.shape
        gy, gx = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=fmap1.device),
            torch.arange(w8, dtype=torch.float32, device=fmap1.device),
            indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(b, h8, w8, 2)
        coords1 = coords0.clone()
        for _ in range(cfg.iters):
            if fused:
                corr = lookup_corr_pyramid_t(pyramid, coords1, cfg.corr_radius)
            else:
                corr = lookup_corr_pyramid_dense(pyramid, coords1,
                                                 cfg.corr_radius)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, delta = self.update_block(net, inp, corr.permute(0, 3, 1, 2),
                                           flow)
            # flow updates accumulate in f32 whatever the conv dtype
            coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
        # the upsampling mask of the last iteration is the only one used
        mask = self.update_block.mask(net).float().permute(0, 2, 3, 1)
        return convex_upsample(coords1 - coords0, mask)

    def forward(self, image1, image2):
        image1 = self._normalize(image1)
        image2 = self._normalize(image2)
        both = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1, fmap2 = both.chunk(2, dim=0)
        return self._refine(fmap1, fmap2, image1)

    def consecutive(self, frames):
        b, l = frames.shape[:2]
        imgs = self._normalize(frames.reshape(b * l, *frames.shape[2:]))
        fmaps = self.fnet(imgs)
        fmaps = fmaps.reshape(b, l, *fmaps.shape[1:])
        imgs = imgs.reshape(b, l, *imgs.shape[1:])
        fmap1 = fmaps[:, :-1].reshape(b * (l - 1), *fmaps.shape[2:])
        fmap2 = fmaps[:, 1:].reshape(b * (l - 1), *fmaps.shape[2:])
        image1 = imgs[:, :-1].reshape(b * (l - 1), *imgs.shape[2:])
        flow = self._refine(fmap1, fmap2, image1)
        return flow.reshape(b, l - 1, *flow.shape[1:])
