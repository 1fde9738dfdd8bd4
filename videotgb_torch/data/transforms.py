"""Host-side video/image transforms with CLIP normalization (the port's
copy of ``videotgb_tpu/data/transforms.py``, same arrays).

Functional numpy equivalents of the reference's LAVIS-derived transform
stack: resize -> (optional crop) -> to float [0,1] -> normalize by CLIP
stats. Layout is (T, H, W, C) throughout. ``cv2`` is imported inside the
resizes only. ``clip_transform`` hands uint8 frames to the C++ library of
``data.native`` when it built, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from videotgb_torch.data.constants import CLIP_MEAN, CLIP_STD


def resize_video(frames: np.ndarray, size: int | tuple[int, int]) -> np.ndarray:
    """Bilinear resize (T, H, W, C); int size = resize short side keeping
    aspect (torchvision Resize semantics used by ResizeVideo)."""
    t, h, w, c = frames.shape
    if isinstance(size, int):
        if h < w:
            nh, nw = size, max(int(round(w * size / h)), 1)
        else:
            nh, nw = max(int(round(h * size / w)), 1), size
    else:
        nh, nw = size
    if (nh, nw) == (h, w):
        return frames
    import cv2

    return np.stack(
        [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in frames]
    )


def center_crop_video(frames: np.ndarray, size: int) -> np.ndarray:
    t, h, w, c = frames.shape
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return frames[:, top : top + size, left : left + size]


def normalize_video(
    frames: np.ndarray,
    mean: tuple[float, ...] = CLIP_MEAN,
    std: tuple[float, ...] = CLIP_STD,
) -> np.ndarray:
    """uint8 (T, H, W, C) -> float32 normalized."""
    x = frames.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def clip_transform(frames: np.ndarray, size: int = 224,
                   use_native: bool = True) -> np.ndarray:
    """The standard eval-time pipeline: resize to (size, size) + normalize
    (the reference's ResizeVideo((224,224)) + ToTensor + Normalize chain).
    Delegates uint8 input to the multithreaded C++ library
    (``data.native``) when it built, as the JAX package does; the numpy
    path differs from it by up to 2e-2 in normalized pixels."""
    if use_native and frames.dtype == np.uint8:
        from videotgb_torch.data import native

        if native.available():
            return native.resize_normalize(frames, size, CLIP_MEAN, CLIP_STD)
    frames = resize_video(frames, (size, size))
    return normalize_video(frames)


def horizontal_flip_video(frames: np.ndarray, p: float, rng: np.random.Generator) -> np.ndarray:
    """RandomHorizontalFlipVideo (reference: src/gadgets/transforms.py)."""
    if rng.random() < p:
        return frames[:, :, ::-1]
    return frames


def random_crop_video(frames: np.ndarray, size: int,
                      rng: np.random.Generator) -> np.ndarray:
    """RandomCropVideo: same crop window for every frame of the clip."""
    t, h, w, c = frames.shape
    top = int(rng.integers(0, max(h - size, 0) + 1))
    left = int(rng.integers(0, max(w - size, 0) + 1))
    return frames[:, top : top + size, left : left + size]


def random_resized_crop_video(
    frames: np.ndarray, size: int, rng: np.random.Generator,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
    attempts: int = 10,
) -> np.ndarray:
    """RandomResizedCropVideo (torchvision semantics: sample area/aspect,
    crop, resize to (size, size)); one window shared across the clip."""
    t, h, w, c = frames.shape
    area = h * w
    for _ in range(attempts):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = frames[:, top : top + ch, left : left + cw]
            return resize_video(crop, (size, size))
    return resize_video(center_crop_video(frames, min(h, w)), (size, size))


def denormalize(
    frames: np.ndarray,
    mean: tuple[float, ...] = CLIP_MEAN,
    std: tuple[float, ...] = CLIP_STD,
) -> np.ndarray:
    x = frames * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)
