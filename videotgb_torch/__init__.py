"""VideoTGB in PyTorch for NVIDIA Hopper (H100).

A port of the video-QA serving paths of ``videotgb_tpu`` (RAFT optical
flow -> Temporal Grounding Bridge span selection -> ViT-g -> Q-Former ->
Flan-T5 or, through the instruction-aware Q-Former, Vicuna-7B generation)
and of its training recipes on the three backbones (``training/``,
``train.py``): TG, SF, E2E and stage 3's IV and IVT (LoRA adapters on the
LLM, ``models/lora.py``). The hot spots that the JAX package ran as
Pallas TPU kernels run here as CUDA C++ kernels written for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use:

* ``csrc/flash_fwd.cu``   flash-attention forward (``ops.attention``);
* ``csrc/flash_bwd.cu``   flash-attention backward (``ops.attention``);
* ``csrc/corr_lookup.cu`` RAFT correlation-pyramid lookup
  (``ops.correlation_pallas``);
* ``csrc/select_frames.cu`` fused frame selection from the span logits
  (``ops.select_pallas``; ``VideoTGB.select_frames`` on the card).

The JAX package's probe kernels have their tools in ``tools/``:
``csrc/corr_lookup_blocked.cu`` (``tools.lookupprobe``), the Triton fused
add + LayerNorm (``tools.lnprobe``) and ``csrc/flash_bshd.cu``
(``tools.attnlayoutprobe``).

``serve.ServingEngine`` serves it with dynamic batching (a select and an
answer worker, each on its own CUDA stream on the card) and
``evalsuite.inference`` / ``evalsuite.evaluate`` run the QA benchmarks and
their judge, over the host modules of ``data/`` (tokenizers, video I/O,
transforms).

The recipes train from the command line as in the JAX package:
``python -m videotgb_torch.train experiment=...`` composes the repo's
``configs/`` tree (``config/``, read without PyYAML), builds the synthetic,
VideoInstruct or stage-3 image/video/text data (``data/datasets.py``,
``data/conversation.py``, ``data/loader.py``) and fits
with evaluation, checkpoints, resume and early stopping
(``training/trainer.py``, ``training/checkpoint.py``,
``training/metrics.py``, ``utils/``); ``python -m videotgb_torch.evaluate
ckpt_path=...`` scores a checkpoint, and ``evalsuite.inference.load_model``
(with ``--lora 1`` for an IVT one) serves it.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``trainer.platform=cpu`` for the CLIs); there each kernel
is replaced by its plain PyTorch version.
Nothing CUDA-specific is built or imported when this package is imported.
"""

from videotgb_torch.device import resolve_device

__all__ = ["resolve_device"]
