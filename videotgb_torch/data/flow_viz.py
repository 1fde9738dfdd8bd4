"""Optical-flow -> RGB visualization (the Baker et al. colorwheel, for the
demo's flow images) and flow normalisation for the TGB input: the port's
copy of ``videotgb_tpu/data/flow_viz.py``, the same arrays."""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) RY/YG/GC/CB/BM/MR ramp."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def flow_to_image(flow_uv: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """flow (..., H, W, 2) -> uint8 RGB (..., H, W, 3), normalized by the
    max radius over the whole array (matching the per-video normalization)."""
    flow = np.asarray(flow_uv, np.float32)
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad_max = rad.max() if rad.size else 0.0
    eps = 1e-5
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)
    return _uv_to_colors(u, v)


def _uv_to_colors(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        small = rad <= 1
        col = np.where(small, 1 - rad * (1 - col), col * 0.75)
        img[..., i] = np.floor(255 * col)
    return img


def normalize_flow(flow: np.ndarray) -> np.ndarray:
    """Per-video max-radius normalization for the TGB input
    (reference: videoinstruct_dataset.py:211-226). flow (T, H, W, 2)."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad_max = rad.max() if rad.size else 0.0
    eps = 1e-5
    return np.stack([u / (rad_max + eps), v / (rad_max + eps)], axis=-1)
