"""CLIP normalization stats used by every visual transform
(the same values as ``videotgb_tpu.data.constants``, kept here so the port
imports nothing of the JAX package)."""

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
