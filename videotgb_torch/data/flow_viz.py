"""Flow normalisation for the TGB input (the port's copy of
``normalize_flow`` from ``videotgb_tpu/data/flow_viz.py``, the same
arrays)."""

from __future__ import annotations

import numpy as np


def normalize_flow(flow: np.ndarray) -> np.ndarray:
    """Per-video max-radius normalization for the TGB input
    (reference: videoinstruct_dataset.py:211-226). flow (T, H, W, 2)."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad_max = rad.max() if rad.size else 0.0
    eps = 1e-5
    return np.stack([u / (rad_max + eps), v / (rad_max + eps)], axis=-1)
