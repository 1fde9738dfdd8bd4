"""VideoTGB in PyTorch for NVIDIA Hopper (H100).

A port of the BLIP2-Flan-T5 video-QA serving path of ``videotgb_tpu``:
RAFT optical flow -> Temporal Grounding Bridge span selection -> ViT-g ->
Q-Former -> Flan-T5 generation. The two hot spots that the JAX package ran
as Pallas TPU kernels run here as CUDA C++ kernels written for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use:

* ``csrc/flash_fwd.cu``   flash-attention forward (``ops.attention``);
* ``csrc/corr_lookup.cu`` RAFT correlation-pyramid lookup
  (``ops.correlation_pallas``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; there each kernel is replaced by its plain PyTorch version.
Nothing CUDA-specific is built or imported when this package is imported.
"""

from videotgb_torch.device import resolve_device

__all__ = ["resolve_device"]
