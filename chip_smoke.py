#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``videotgb_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):

1. the card's name and power limit (``nvidia-smi``), then an ``nvcc`` build
   of every kernel in ``videotgb_torch/csrc`` (one process per source, and
   one for an empty kernel, phase 8's floor), with each instantiation's
   registers, spills and shared memory (kernels B and E's tile body with
   its dynamic share at the serving shape);
2. kernel A (flash-attention forward) against its plain PyTorch version at
   the main-path shape (ViT-g: 16 images x 16 heads x 264 x 88, bf16, a
   (1,1,1,264) pad bias) and at the other bias layouts, f32, an unaligned
   bf16 view, and a fully masked row in f32 and bf16, each on the body
   ``flash_body`` picks (tensor cores for aligned bf16, CUDA cores for the
   rest); timed on the tensor-core body beside the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
   at the serving shape, the E2E ViT-g shape (32 images), the T5-xl
   encoder's (8, 32, 160, 64) with its (8, 32, 160, 160) f32 bias and the
   Vicuna-7B prefill's (4, 32, 96, 224, 128) with its (4, 1, 96, 224) bias
   (also checked at Sq = Skv = 160), as
   device time per call (calls captured in a CUDA graph: a call's host
   overhead exceeds the kernel's time);
3. kernel B (RAFT correlation lookup) against its plain version at 16 pairs
   (the serving path's) and 256 pairs (the JAX benchmark's RAFT batch of
   128, twice), 28x28 queries, 4 levels, r = 4, f32 and bf16, RAFT's
   coordinates (``tools/lookupprobe.py::make_coords``'s "raft"), "wild" and
   off-map ones, on both bodies (the tile body the rule picks and the
   gather body); in bf16 both bodies timed as device time per call (calls
   captured in a CUDA graph), per eager call and as the host's time per
   call, beside the bound and the plain version;
4. the serving path at flagship width (ViT-g, Q-Former, Flan-T5-xl, TGB
   BERT-base, RAFT; random weights from a seed) for 4 requests:
   ``select_phase_blip2`` -> gather -> ``answer_phase_blip2``, then
   ``flow_features`` + ``generate_blip2`` on the same batch, with exact
   launch counts of the three kernels (every lookup on the tile body; one
   kernel D per selection) and the same frames from both routes; the ViT
   once without the flash kernel and RAFT once without the lookup kernel,
   against the kernel path; one RAFT refine traced (device time by kernel
   family, the lookup's among them); the selection tail
   (``model.select_frames``: a seed draw and kernel D) against the plain
   route on the same logits, eager wall, host time and device operations
   per call, and the select phase in turns with and without it;
5. kernel C (flash-attention backward) against its plain version at the
   training path's shape (T5-xl encoder: 8 x 32 heads x 160 x 64, bf16, an
   (8,32,160,160) f32 bias, no ds) and at a learned bias with ds, padding,
   no bias, f32, an unaligned bf16 view, Sq != Skv (32 x 600, 1 x 160, 65
   x 160), D = 128, a fully masked row in f32 and bf16, S = 1024 and S =
   1536, each on the body ``flash_body`` picks (tensor cores for aligned
   bf16: one launch where ``flash_bwd_passes`` says so, else two; CUDA
   cores for the rest); two launches bit-identical at the main shape and
   with ds; the forward output and the gradients through
   ``flash_attention`` (kernels A and C) at the T5 encoder's shape and
   bias, and at S = 1200, against autograd of the plain attention; both
   bodies, the plain version and the backward of
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls;
   its kernels summed under ``torch.profiler``) timed at the main shape as
   device time per call;
6. the E2E training path at flagship width (f32 parameters, bf16 compute,
   uniform selection, batch 8, 32 candidate frames, 32-token questions and
   answers): 3 ``Trainer.train_step`` steps, the first uncounted, with
   exact launch counts per step (63 flash forward, 24 flash backward),
   trainable parameters moved and frozen ones bit-identical, the last step
   split into forward, backward and optimizer, then one more step traced
   (device time by kernel family, kernel C's among them);
7. the TG training path at flagship TGB width (batch 32, 64 flow frames,
   24-token questions, dropout on): 3 steps, no kernel launched;
8. kernel D (fused frame selection) on the select phase's own span logits
   from phase 4 (4, 4), the JAX benchmark's batch (64, 4), the TG shape
   (32, 66) and (1024, 256) at F = 128 and F = 1024, each as the strided
   views of a (B, L, 2) head output, with lengths 1 and 2, (0, 0) peaks,
   NaN logits and tied rows planted: equal to its plain version at
   ``noise_scale=0`` and, as int64, with the same handed noise; F = 128 and
   1024 under both rescale rules and both ends; with noise, reproducible
   per seed (by value and from a device tensor) and, over 65,536
   zero-logit rows, the histogram of the plain version's frames within
   0.01; device time per call (``graph_ms``) beside an empty kernel's,
   host time per call, the plain version's eager time;
9. kernel E (the lookup probe's query-blocked lookup) at 256 pairs x 28x28,
   bf16 and f32, "raft", "wild" and off-map coordinates, with and without
   row skipping, against the plain version at phase 3's tolerances; 20
   launches per chained run; timed beside kernel B; then the probe tool;
10. kernel F (Triton ``add_ln`` and ``ln``) at 256 x 264 x 1408, f32 and
   bf16, against their plain versions; the 4-layer stack's three variants
   with exact launches (2 per layer, 1 flash forward per layer); timed
   beside ``F.layer_norm``; then the probe tool;
11. kernel G (flash attention in (B, S, H, D)) at 128 x 264 x 16 x 88, f32
   (CUDA-core body) and bf16 (tensor-core body), against its plain version
   and kernel A on the transposes; 1 launch per layer of the stack; timed
   beside SDPA; then the probe tool;
12. kernel H (int8 and bf16 GEMMs on one warp-specialised wgmma + TMA main
   loop): int8 bit for bit with its plain version (int32 and bf16
   epilogues, every block tiling and the tiling rule's pick) at 8192^3, at
   the int8 ViT-g's three product shapes, at odd M and N, with +-127
   saturated inputs; bf16 at 8192^3 within one bf16 ulp plus the f32 order
   bound; every tiling timed (device time per call, launches captured in a
   CUDA graph; the rule's pick also per eager call) at the W8A8 path's
   three shapes and for one image (M = 264; int32 out), at 8192^3 int8 ->
   bf16 and bf16, in TOP/s or TF/s beside ``torch._int_mm`` and
   ``torch.matmul`` (yardsticks the port never calls); then the W8A8
   serving path at flagship width
   (``vit.quant = "int8"``) for 4 requests, select -> answer with exact
   launch counts (234 int8_mm and 39 flash_fwd per ViT pass, 20
   corr_lookup per refine) and the host time of kernel H's TMA descriptor
   encodes, the ViT-g output bit-identical with kernel H swapped for its
   plain version and within the JAX package's int8 gate of the bf16 tower
   on the same images, the int8 tower's time split into products and
   quantize passes; then the three int8 tools (the GEMM probe counted: its
   kernel-H lines launch int8_mm and bf16_mm once per call);
13. the port's serving engine (``videotgb_torch.serve.ServingEngine``) at
   flagship width, bf16 residency, batch 4, 4 flow pairs, 16 new tokens,
   fed through ``submit`` with random uint8 frames from a seed: a warm-up
   request, 4 requests one at a time, a burst of 8 (two identical pairs)
   and 8 Poisson arrivals at 4 req/s; its select worker (kernels B and D)
   and answer worker (kernel A) on two threads and two CUDA streams. Every
   future resolves; the launches over the engine's run are its batches
   times (20 lookups on the tile body, 1 selection, 39 flash forwards on
   the tensor-core body); every batch equals direct single-threaded phase
   calls on the same padded batch with its step's generator, indices and
   tokens bit for bit; latency percentiles, throughput, ``phase_ms``, how
   much select(N+1) overlapped answer(N), peak memory;
14. InstructBLIP-Vicuna-7B at flagship width (8.0B parameters in bf16,
   built on the card without a ``device``; random weights from a seed) for
   4 requests with 64-token prompts and 128 new tokens:
   ``select_phase_blip2`` in "multi_modal" mode with the "ratio" rule ->
   gather -> ``answer_phase_instructblip``, with exact launches (20 lookups
   and 1 selection per select phase; 71 flash forwards per answer, 39 on
   the ViT-g and 32 on the Vicuna prefill at (4, 32, 96, 224, 128); none in
   a decode step), then ``generate_instructblip`` on the same batch and
   noise seed, equal in frames and tokens; the wall time of the select
   phase, ViT-g + Q-Former, the prefill and a decode step, and one decode
   step traced (device time by kernel family); then the serving
   engine with ``backbone="instructblip"`` (16 new tokens: a warm-up, 4
   requests one at a time, a burst of 8), checked as in phase 13;
15. the training and evaluation CLIs as a user calls them,
   ``videotgb_torch.train.main`` and ``videotgb_torch.evaluate.main`` at
   flagship width (f32 parameters, bf16 compute; random weights from the
   seed, synthetic data): ``experiment=smoke_e2e_synthetic
   model.preset=flagship`` at batch 8 (32 candidate frames at 224², 32-token
   questions and answers) for 3 steps with an eval at step 3, each step
   exactly 63 A + 24 C and each eval batch 102 A + 1 D, all A and C on the
   tensor-core bodies; finite losses, frozen parameters bit-identical after
   fit, a ``metrics.csv`` row per step, ``val/loss`` and ``val/score``, one
   step under ``best/``; then a CLI resume from that checkpoint to
   ``trainer.max_steps=4`` (exactly one step, the schedule's lr at step
   index 3, the optimizer's step count 4), a library round trip (the live
   state saved, one step, a fresh model restored from the save, the same
   step bit-identical in loss, gradient norm, trainable parameters and
   Adam moments), ``evaluate.main`` on the checkpoint (``test/loss``,
   ``test/score``), and the TG CLI at batch 32 and 64 flow frames (2
   steps, no kernel, ``val/iou_score``); each step's wall split into the
   data wait and ``train_step``, eval walls, save and restore walls and
   bytes, peak memory. Its four 18.1 GB saves are made and counted but not
   written (their time goes to phase 22): each is a copy of its items in
   host memory beside empty placeholder files, which the resume, the
   library round trip and ``evaluate.main`` restore from;
16. the self-refinement (SF) recipe and the InstructBLIP training paths at
   flagship width, f32 parameters, bf16 compute, batch 2, 32 candidate
   frames at 224², 64 flow frames, 128-token questions, 32-token answers,
   32 pseudo tokens. 16a: ``train.main`` with ``experiment=
   smoke_sf_synthetic model.preset=flagship``, 2 steps, one eval, one save
   made but not written (the 40.9 GB write gives its time to phase 21):
   each step's pseudo-label pass and ``train_step`` timed and counted
   against the launches ``expected_launches`` derives from the config and
   the dispatch rule (kernel C with ds on every T5 encoder layer, two
   passes), the scores in [0, 1] and the spans inside each row's flow
   length, ViT-g and RAFT bit-identical, T5, TGB and Q-Former tensors
   moved, finite ``loss``, ``lm_loss`` and ``mrc_loss``; the memory the
   optimizer step adds; the T5 relative-position bias's
   gradient on kernel C against its plain version. 16b:
   ``SFRecipe(online_flow=True)`` on InstructBLIP-Flan-T5
   (``LSTP_SF_small``), 2 library steps with ``flow_frames`` (2, 65, 224,
   224, 3) from a seed: RAFT's 20 lookups a step on top, the
   instruction-aware Q-Former's kernel C calls in one pass. 16c: 2
   ``E2ERecipe`` steps on InstructBLIP-Vicuna-7B, the LLaMA frozen (kernel
   C at head dim 128 on two passes), the Q-Former moved. Then kernel C at
   the two new shapes against its plain version, timed beside SDPA's
   backward;
17. stage 3 at flagship width (f32 parameters, bf16 compute) on a dataset
   the phase writes from a seed with cv2 under ``build/phase17/`` (3 JPEGs,
   2 mp4 videos of 48 frames at 320x240, 8 train rows of images, videos
   cropped to pseudo-label spans and text, 2 val rows, 2 text-only
   nlp_tune.json rows; every row read back without the dataset's resample,
   and a failed row read during the runs is fatal); 128-token prompts,
   32-token answers. 17a: ``train.main`` with ``experiment=
   LSTP_blip2flant5xl_ivtinstruct`` (rank-8 adapters on the T5; batch 1, 4
   micro-batches a step), 2 steps, one eval, one save (held in host memory
   beside empty placeholder files, not written: the 17.2 GB write gives
   its time to phase 24): each step's and eval
   batch's launches against those ``expected_stage3`` derives (kernel C
   without ds on one pass at (1, 32, 160, 160, 64)), the frozen parameters
   bit-identical, the adapters' B, the Q-Former, its projection and query
   tokens moved, a text-only row's loss independent of its frame slab.
   17b: the checkpoint through ``evalsuite.inference.load_model`` (``lora``
   1, bf16 residency) against the trained model held in memory at the same
   residency: the same parameters, then ``select_phase_blip2`` +
   ``answer_phase_blip2`` for 4 requests with the same generator, 20 B + 1
   D + 39 A each, identical frames and tokens; ``evaluate.main`` on the
   checkpoint gives the run's val/score. 17c: ``train.main`` with
   ``experiment=LSTP_instructblipvicuna7b_ivinstruct`` (batch 2, no
   accumulation, 2 steps, one eval, one save made but not written (the
   33.7 GB write gives its time to phase 21); ``llama-vendored`` where
   ``transformers`` imports, else ``data.tokenizer=byte``, said on a line
   of its own): launches as derived (kernel C at head dim 128 on two
   passes), the frozen parameters bit-identical, the Q-Former moved,
   ``generate_iv``'s LLaMA branch in the eval. Each run's step walls split
   into data wait and ``train_step``, eval walls, save and restore walls
   and bytes, peak memory. Then kernel C at the phase's two shapes against
   its plain version, timed beside SDPA's backward;
18. the chat demo and the converter (``demo_paths``): two 96-frame clips at
   320x240 written with cv2 under ``build/phase18/``; 18a
   ``demo.app.Chat`` on BLIP2-Flan-T5-xl at flagship width (bf16
   residency, RAFT f32 on bf16-rounded weights) behind ``make_handler`` on
   127.0.0.1: the page, a multipart POST with beams 5 equal to
   ``Chat.generate(num_beams=5)``, a greedy answer equal to
   ``generate_blip2`` on its batch and generator, nframe 8 through the form
   on the same parameters, 20 B + 1 D + 39 A per answer; 18b
   InstructBLIP-Vicuna-7B with beams 5 at 128 new tokens, 20 B + 1 D + 71
   A; on both, beams on the two clips in one batch equal to each clip's;
   18c ``tools.convert_checkpoint`` at the tiny preset from a
   raft-sintel.pth and a sampler (safetensors where it imports) written
   from a seeded model under the reference's names
   (``tests/_torch_reference_names.py``), restored by ``load_model`` on
   the card and served. Each answer's wall and each model's peak
   memory;
19. the slice's tools (``tool_paths``), each ``main`` run in the process
   at flagship width with batches, layers and iterations cut: the native
   host library built and ``clip_transform``'s native and numpy paths
   within 2e-2; kernel A at the Q-Former's shapes (128 frames x 12 heads x
   32 queries over 32 and 264 keys, 64 wide, bf16) against its plain
   version, timed beside it and SDPA; ``traceprobe`` raft, vit, qformer
   and decode at batch 32 on the JAX tool's model, ``perfprobe`` pipe,
   vit, raft and model, ``qformerattnprobe``, ``raftencprobe``,
   ``stemprobe``, ``decodeprobe``, ``traintraceprobe`` tg and ivt on one
   flagship with LoRA rank 8 and sf on ``small``: each run's launches of
   A-D exactly as derived from the code, every summariser's device total
   in (0, wall], the variants' exactness checks; a 2-trial sweep through
   ``utils.sweep.run_sweep`` on the card (``<sweep dir>/0`` and ``/1``
   under ``build/phase19/``); ``evalsuite.debug`` on a written file.

20. the CUDA-graph programs (``graph_paths``) against their eager
   functions;
21. data-parallel and fully sharded training (``parallel_paths``) at
   flagship width, E2E at a global batch of 8: a world-1 reference in this
   process, then two ranks on the one card over gloo (NCCL refuses two
   ranks on one device; gloo carries CUDA tensors through the host), each
   confirming gloo's ``all_reduce``, ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` on CUDA tensors first: 21a the dp route, a
   uniform step then a ``selection=tgb`` step, 63 A + 24 C a step a rank
   and 1 D on the tgb step, all on the tensor-core bodies, each rank's
   loss and grad norm within 1e-2 relative of world 1's, D's frames equal
   to world 1's (the Philox counter starts at the rank's first global
   row), trainable parameters bit-identical across the ranks (an
   all-reduce of their bits' minimum and maximum), every frozen tensor's
   fingerprint unchanged, each rank's step wall, peak memory and the
   all-reduces' share of the step; 21b the fsdp route as ``train.py``
   takes it (the model handed unsharded to ``Trainer.init_state``, which
   applies FSDP2 over an fsdp=2 mesh), one E2E step at step 1 (lr > 0)
   against the dp route's step with FSDP2's grouping of each unit's input
   gradients (``P21Grouping``): its gradients (each leaf gathered whole
   before the update) bit-identical, its loss equal, its grad norm within
   1e-5 and each updated trainable entry within one last bit of itself
   plus four of lr's (the clip reads the shards' norm); its loss and grad
   norm within 1e-2 of the unwrapped world-1 step's, and the gradient gaps
   leaf by leaf to the world-1 step, the plain dp step and the grouped dp
   step printed; 21c a tiny world-2 FSDP checkpoint restored in this
   process with equal parameters and Adam moments;
22. tensor-parallel serving (``tensor_parallel_paths``) at flagship width,
   bf16 residency: world-1 references in this process, then two gloo
   ranks on the one card at tp=2, each model sliced by
   ``parallel.tensor.shard_tp``: 22a ``flow_features`` +
   ``generate_blip2`` on 4 requests (64-token prompts, 4 flow pairs, 16 new
   tokens) on the model of 22c's engine; 22c ``ServingEngine(mesh=
   "tp=2")``, 4 requests through rank 0's ``submit``; 22b
   InstructBLIP-Vicuna-7B, the same requests, 80 new tokens (Vicuna's
   prefill takes kernel A from 75 on). Each run's launches exactly as
   derived (A 39, or 71 on Vicuna, B 20, D 1 a batch, on the tensor-core
   and tile bodies); kernel A at the shapes the ranks give it (8 of
   ViT-g's 16 heads, 16 of Vicuna's 32) against its plain version on the
   recorded inputs; frames equal to world 1's (22c's against direct phase
   calls on each batch rank 0 assembled, with its step's generator); the
   LLM's visual tokens within 1/8 of world 1's largest, and the first
   decode step's logits too where one bf16 step on the LLM's inputs moves
   world 1's by less; each rank's tokens bit-identical to the other's;
   the greedy tokens' agreement with world 1, a rank's wall and the share
   of it in the tp collectives (through the host: gloo times nothing a
   multi-card NCCL machine would); the engine's route (eager);
23. sequence parallelism (``sequence_parallel_paths``) at flagship width,
   held to phases 21 and 22's world-1 references: two gloo ranks on the
   one card at sp=2 (``parallel.sequence.shard_sp``), each first
   confirming gloo's bf16 ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` on CUDA tensors: 23a E2E on
   ``configs/trainer/sp.yaml``'s layout (dp 1 x sp 2) at a global batch of
   8, a uniform step then a ``selection=tgb`` step, each rank's launches
   exactly A 63 and C 24 a step (24 of each at the T5-xl encoder's split
   (8, 32, 80, 160, 64) under an (8, 32, 80, 160) bias) and D 1 on the
   tgb step, on the tensor-core bodies; kernels A and C against their
   plain versions on the inputs the ranks recorded; each rank's loss and
   grad norm within 1e-2 relative of world 1's, D's frames equal to world
   1's, the trainable tensors bit-identical across the ranks, every frozen
   fingerprint unchanged; 23b ``flow_features`` + ``generate_blip2`` (16
   new tokens) and ``generate_instructblip`` (80) on phase 22's 4
   requests, each rank's launches world 1's (A 39, or 71 with Vicuna's
   whole cached prefill, B 20, D 1), frames equal to world 1's, the LLM's
   visual tokens and logits under phase 22's bounds, the ranks' tokens
   bit-identical; 23c Vicuna's forward without caches (the path of
   ``trainer=sp`` with the InstructBLIP recipes) on 23b's split model at
   phase 17's IV length (4 rows of 192 tokens: 23b's 32 visual tokens and
   a right-padded 160-token prompt), forward and backward to its input
   embeddings, each rank's launches exactly A 32 and C 32 at the split
   (4, 32, 96, 192, 128) under the (4, 1, 96, 192) local-row causal and
   padding bias, held against the whole forward on the rank; each rank's
   step or answer wall and the share of it in the sp collectives (and, in
   23a, the all-reduces); then kernels A and C at the split encoder's
   shape timed beside the plain versions and SDPA;
24. pipeline parallelism (``pipeline_parallel_paths``) at flagship width,
   held to phase 21's world-1 references: two gloo ranks on the one card at
   pp=2, each first probing the hop (gloo's ``all_gather_into_tensor`` on
   bf16 and f32 CUDA tensors, then ``parallel.pipeline``'s ring permute
   built from it, and its time at a T5-xl microbatch): 24a E2E with the T5
   tower's ``scan_layers`` (``Trainer.init_state`` stages its 24 encoder
   and 24 decoder layers, 12 of each a rank) at a global batch of 8, a
   uniform step then a ``selection=tgb`` step, each rank's launches A 63
   (ViT-g's 39 and 24 = 12 layers x 2 microbatches at (4, 32, 160, 160,
   64)) and C 24 a step, D 1 on the tgb step, 8 hops a step, on the
   tensor-core bodies; kernels A and C against their plain versions on
   the recorded inputs; losses and grad norms within 1e-2 relative of
   world 1's, D's frames equal to world 1's, trainable tensors
   bit-identical across the ranks, frozen fingerprints unchanged, each
   rank's parameter bytes against world 1's and its peak memory; 24b
   Vicuna-7B's forward without caches (32 layers, 16 a stage) on 4 rows of
   192 tokens and its backward to the input embeddings, A 32 and C 32 a
   rank at (2, 32, 192, 192, 128), logits and input gradient against the
   whole forward on the rank under phase 22's bound; each step's or pass's
   wall with the hops' and all-reduces' shares; then 24c in this process:
   one E2E step from phase 21's world-1 start with the T5 tower's
   ``remat`` (A 87: 24 more in the recomputed forward; C 24) and without,
   against phase 21's first step, with their peak memory; then kernels A
   and C timed at the stage shapes and 23c's split Vicuna (4, 32, 96, 192,
   128) beside the plain versions and SDPA.

Every counted run of a path also checks that each launch of kernels A, G
and C ran the tensor-core body (``kernels.MMA_LAUNCHES``) and each launch
of B and E the tile body (``kernels.TILE_LAUNCHES``): the paths hand them
bf16 with 16-byte rows only. The last three lines are a JSON object of
per-kernel numbers, the card's name and power limit, and a JSON object
``{"ok": true, "device": {...}}``.
Needs one CUDA card; exits non-zero without one, or without the package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              "int8": 1979e12}  # dense, no sparsity; int8 in TOP/s


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fns: dict, calls=200, reps=5) -> dict:
    """Host time per call of each of ``fns`` in µs: ``calls`` calls issued
    back to back without a sync, on the host's clock, the median of ``reps``
    rounds that take the functions in turn (a device that keeps up with the
    host adds nothing to it)."""
    import statistics

    import torch

    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t) / calls * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(v) for name, v in times.items()}


def eager_ms(fns: dict, calls=20, reps=5) -> dict:
    """Eager wall time per call of each of ``fns`` in ms: ``calls`` calls
    after a synchronised warm-up, up to the synchronise after the last, the
    median of ``reps`` rounds that take the functions in turn."""
    import statistics

    import torch

    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) / calls * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def graph_ms(fn, iters=50, reps=3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, its replays timed with CUDA events (the median of ``reps``), so
    the host's launch overhead, which exceeds a short kernel's time, is not
    in it."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def check_close(name, got, want, atol, rtol, reason) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    log(f"  {name}: max_abs_err {max_err:.3e} (tolerance atol {atol:g} + "
        f"rtol {rtol:g}: {reason}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_err


def check_to_largest(name, got, want, tol, reason) -> float:
    """|got - want| <= tol * max|want| (gradients: the error of an entry is
    set by the largest terms of its sums, not by its own size)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    max_err = float((got - want).abs().max())
    bound = tol * float(want.abs().max())
    ok = max_err <= bound
    log(f"  {name}: max_abs_err {max_err:.3e} (tolerance {tol:g} x max "
        f"|plain| = {bound:.3e}: {reason}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_err


# Tile<DP, MT>::kBytes of csrc/flash_mma.cuh: 64 MT rows of Q and two
# stages of 64 rows of K and V, each DP bf16 padded by 16 bytes (dynamic, so
# ptxas does not see it)
def flash_mma_smem(dp: int, mt: int) -> int:
    return (64 * mt + 4 * 64) * (2 * dp + 16)


# Tile<BM, BN, STAGES, _>::kSmemBytes of csrc/wgmma_gemm.cuh: the stages of
# BM + BN rows of 128 bytes, 1024 bytes of alignment slack, two mbarriers a
# stage
def wgmma_gemm_smem(bm: int, bn: int, stages: int) -> int:
    return stages * (bm + bn) * 128 + 1024 + 16 * stages


# the tile body's dynamic shared bytes at the serving shape (16 pairs of
# 28 x 28, 4 levels, r = 4) with the tiling rule's block
def lookup_serving_smem(dtype: str) -> int:
    import torch

    from videotgb_torch.ops.correlation_pallas import (
        lookup_tile,
        lookup_tile_bytes,
    )

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    tile = lookup_tile(16, 28, 28, 4, 4, dt)
    return lookup_tile_bytes(tile.qb, 4, 4, 4 if dtype == "f32" else 2,
                             tile.stage_bytes)


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel instantiation of an ``nvcc -Xptxas -v`` report:
    its name (kernel<dtype, head-dim chunks of 32>, flash_mma_kernel<DP,
    m-tiles, bias>, bwd_{one_pass,rows,cols}<DP> (kernel C's tensor-core
    body), tile_kernel<dtype> or corr_gather_kernel<dtype> (kernels B and
    E) or
    gemm_kernel<type, tile, stages, blocks a SM> where the mangled name
    reads so), registers, spills and shared memory (static, as ptxas
    counts it; beside it the dynamic share of kernel A's tensor-core body,
    of kernel H, of kernel C's one-pass block at 160 x 160 and of the
    lookup's tile body at the serving shape)."""
    from videotgb_torch.ops.attention import (
        flash_bwd_one_pass_bytes,
        flash_bwd_passes,
    )

    out, fn, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn, dyn = m.group(1), ""
            t = re.search(r"\d+([a-z_]+)I(f|13__nv_bfloat16)Li(\d+)E", fn)
            u = re.search(r"\d+([a-z_]+)ILi(\d+)ELi(\d)ELi([012])E", fn)
            h = re.search(r"\d+(S8|Bf16)ENS_4TileILi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELi(\d)E", fn)
            c = re.search(r"\d+(bwd_[a-z_]+)ILi(\d+)EE", fn)
            b = re.search(r"\d+((?:tile|corr_gather)_kernel)I(f|13__nv_bfloat16)E",
                          fn)
            if b:
                dtype = "f32" if b.group(2) == "f" else "bf16"
                fn = f"{b.group(1)}<{dtype}>"
                if b.group(1) == "tile_kernel":
                    dyn = f" + {lookup_serving_smem(dtype)} bytes dynamic " \
                          "at the serving shape"
            elif c:
                fn = f"{c.group(1)}<{c.group(2)}>"
                dp = int(c.group(2))
                if c.group(1) == "bwd_one_pass" and flash_bwd_passes(
                        160, 160, dp) == 1:
                    dyn = (f" + {flash_bwd_one_pass_bytes(160, 160, dp)} "
                           "bytes dynamic at 160 x 160")
            elif h:
                bm, bn, stages = (int(h.group(i)) for i in (2, 3, 4))
                fn = (f"gemm_kernel<{h.group(1)}, {bm}x{bn}, {stages} stages,"
                      f" {h.group(5)} block(s) a SM>")
                dyn = (f" + {wgmma_gemm_smem(bm, bn, stages)} bytes "
                       "dynamic")
            elif t:
                dtype = "f32" if t.group(2) == "f" else "bf16"
                fn = f"{t.group(1)}<{dtype}, {t.group(3)}>"
            elif u:
                dp, mt = int(u.group(2)), int(u.group(3))
                bias = ("no bias", "row bias",
                        "full bias")[int(u.group(4))]
                fn = f"{u.group(1)}<{dp}, {mt} m-tiles, {bias}>"
                dyn = f" + {flash_mma_smem(dp, mt)} bytes dynamic"
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{fn}: {regs.group(1) if regs else '?'} registers, "
                       f"{spill}, shared memory "
                       f"{smem.group(1) if smem else 0} bytes static{dyn}")
            fn, spill = None, ""
    return out


def check_bodies(name: str, launches: dict) -> None:
    """Fail unless every launch of kernels A, G and C in ``launches`` ran
    the tensor-core body (``kernels.MMA_LAUNCHES``) and every launch of B
    and E the tile body (``kernels.TILE_LAUNCHES``; both reset with the
    counts)."""
    from videotgb_torch.ops import kernels

    for what, counts in (("tensor-core", kernels.MMA_LAUNCHES),
                         ("tile", kernels.TILE_LAUNCHES)):
        got = dict(counts)
        want = {k: launches.get(k, 0) for k in got}
        if any(want.values()):
            log(f"  {what} body launches in {name}: {got} (expected {want})")
        if got != want:
            fail(f"{name}: launches off the {what} body: {got} != {want}")


def rel_diff(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------------------------ kernel A
def check_flash(card: str) -> dict:
    import torch

    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.attention import NEG_INF, dot_product_attention, flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.bfloat16: (2e-2, 2e-2, "bf16 output rounding (ulp 2^-8) "
                            "plus a different f32 summation order"),
           torch.float32: (1e-4, 1e-4, "f32 summation order only")}

    def qkv(b, h, s, d, dtype):
        # the main path hands (B, S, H, D) projections over as strided views
        return [torch.randn((b, s, h, d), generator=gen, device=dev).to(
            dtype).transpose(1, 2) for _ in range(3)]

    def body_of(q, k, v, bias):
        """One launch of kernel A; returns (out, the body that ran)."""
        before = kernels.MMA_LAUNCHES["flash_fwd"]
        out = flash_attention(q, k, v, bias)
        return out, ("mma" if kernels.MMA_LAUNCHES["flash_fwd"] > before
                     else "fma")

    def case(name, tensors, bias, want_body):
        q, k, v = tensors
        got, ran = body_of(q, k, v, bias)
        want = dot_product_attention(q, k, v, bias)
        torch.cuda.synchronize()
        if ran != want_body:
            fail(f"flash {name}: ran the {ran} body, not {want_body}")
        atol, rtol, why = tol[q.dtype]
        return check_close(f"flash {name} [{ran} body]", got, want, atol,
                           rtol, why)

    b, h, s, d = 16, 16, 264, 88
    keys = torch.arange(s, device=dev)
    pad_bias = torch.where(keys < 257, 0.0, NEG_INF).float()[None, None, None]
    main_qkv = qkv(b, h, s, d, torch.bfloat16)
    err_main = case("main (16,16,264,88) bf16 pad bias (1,1,1,264)",
                    main_qkv, pad_bias, "mma")
    lens = torch.randint(100, s + 1, (b,), generator=gen, device=dev)
    per_batch = torch.where(keys[None] < lens[:, None], 0.0,
                            NEG_INF).float()[:, None, None]
    case("per-batch padding bias (B,1,1,S)", qkv(b, h, s, d, torch.bfloat16),
         per_batch, "mma")
    case("per-row bias (B,H,S,S)", qkv(2, h, s, d, torch.bfloat16),
         torch.randn((2, h, s, s), generator=gen, device=dev), "mma")
    case("learned bias (1,H,S,S) S=300 D=64", qkv(2, 12, 300, 64,
                                                 torch.bfloat16),
         torch.randn((1, 12, 300, 300), generator=gen, device=dev), "mma")
    case("no bias", qkv(4, h, s, d, torch.bfloat16), None, "mma")
    case("f32 pad bias", qkv(4, h, s, d, torch.float32), pad_bias, "fma")
    # a bf16 view 4 elements (8 bytes) past an allocation: rows not 16-byte
    # aligned, so the CUDA-core body takes it
    flat = torch.randn((3, 4 + 4 * s * h * d), generator=gen,
                       device=dev).to(torch.bfloat16)
    shifted = [t[4:].view(4, s, h, d).transpose(1, 2) for t in flat]
    case("bf16 view offset by 4 elements", shifted, pad_bias, "fma")
    masked = torch.zeros((1, 1, s, s), device=dev)
    masked[..., 10, :] = NEG_INF
    for dtype, want_body in ((torch.float32, "fma"),
                             (torch.bfloat16, "mma")):
        mq, mk, mv = qkv(2, h, s, d, dtype)
        case(f"fully masked row 10 {dtype}", (mq, mk, mv), masked, want_body)
        row = flash_attention(mq, mk, mv, masked)[:, :, 10]
        check_close(f"flash masked row = mean of v, {dtype}", row,
                    mv.float().mean(dim=2), *tol[dtype][:2],
                    "the plain softmax's uniform average")

    def timed(name, tensors, bias):
        return flash_timed(card, name, tensors, bias)

    main = timed("ViT-g serving (16,16,264,88) pad bias (1,1,1,264)",
                 main_qkv, pad_bias)
    timed("ViT-g E2E (32,16,264,88) pad bias (1,1,1,264)",
          qkv(32, h, s, d, torch.bfloat16), pad_bias)
    # the T5-xl encoder: relative positions (1,H,S,S) + padding (B,1,1,S),
    # summed into one (B,H,S,S) f32 bias as the model hands it over
    t5_lens = torch.randint(120, 161, (8,), generator=gen, device=dev)
    t5_keys = torch.arange(160, device=dev)
    t5_bias = (torch.randn((1, 32, 160, 160), generator=gen, device=dev)
               + torch.where(t5_keys[None] < t5_lens[:, None], 0.0,
                             NEG_INF).float()[:, None, None])
    t5_qkv = qkv(8, 32, 160, 64, torch.bfloat16)
    case("T5-xl encoder (8,32,160,64) bias (8,32,160,160)", t5_qkv, t5_bias,
         "mma")
    timed("T5-xl encoder (8,32,160,64) bias (8,32,160,160)", t5_qkv,
          t5_bias)
    # the Vicuna-7B prefill (InstructBLIP, phase 14): 32 visual + 64 prompt
    # tokens into caches of 96 + 128 slots, head dim 128; q from the RoPE, k
    # and v the cache buffers, the cache forward's (B,1,Sq,Skv) bias (k_pos
    # <= q_pos, right-padded prompts, unwritten decode slots) broadcast
    # over the 32 heads
    for sq, skv in ((96, 224), (160, 160)):
        pq, pk, pv = (torch.randn((4, 32, n, 128), generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for n in (sq, skv, skv))
        slot = torch.arange(skv, device=dev)
        lens = torch.tensor([sq, sq - 8, sq - 16, sq - 63], device=dev)
        prefill_bias = torch.where(
            slot[None] <= torch.arange(sq, device=dev)[:, None], 0.0,
            NEG_INF)[None, None] + torch.where(
            slot[None] < lens[:, None], 0.0, NEG_INF)[:, None, None]
        name = f"Vicuna prefill (4,32,{sq},{skv},128) bias (4,1,{sq},{skv})"
        case(name, (pq, pk, pv), prefill_bias, "mma")
        if skv > sq:
            timed(name, (pq, pk, pv), prefill_bias)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "videotgb_torch/csrc/flash_fwd.cu",
            "replaces": "videotgb_tpu/ops/attention.py:54",
            "max_abs_err": err_main, **main}


def flash_timed(card, name, tensors, bias) -> dict:
    """Kernel A, the plain version and SDPA at one shape, each as device
    time per call (``graph_ms``), the kernel also per eager call; the bound
    is q, k, v, out and the bias each moved once, or the products at the
    bf16 peak, the larger. Fails unless the launch ran the tensor-core
    body."""
    import torch.nn.functional as F

    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.attention import (dot_product_attention,
                                              flash_attention)

    q, k, v = tensors
    nb, nh, sq, dh = q.shape
    skv = k.shape[2]
    before = kernels.MMA_LAUNCHES["flash_fwd"]
    flash_attention(q, k, v, bias)
    if kernels.MMA_LAUNCHES["flash_fwd"] == before:
        fail(f"flash {name}: ran the fma body, not mma")
    ms = graph_ms(lambda: flash_attention(q, k, v, bias))
    eager = time_ms(lambda: flash_attention(q, k, v, bias))
    plain_ms = graph_ms(lambda: dot_product_attention(q, k, v, bias),
                        iters=5)
    mask = None if bias is None else bias.to(q.dtype)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=dh ** -0.5))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + (0 if bias is None else bias.numel() * bias.element_size())
    flops = 4 * nb * nh * sq * skv * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"  flash {name} [mma body]: kernel {ms:.4f} ms ({eager:.4f}"
        f" ms a call from eager Python), plain {plain_ms:.4f} ms, SDPA "
        f"{lib_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP) on {card}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------------ kernel B
def lookup_needed_bytes(pyramid, coords, radius) -> int:
    """Bytes the lookup must read: per query, the in-range part of the
    (2r+2)^2 corner window of each level (each query owns its column of the
    query-minor pyramid), plus coords and the output."""
    import torch

    p, h, w, _ = coords.shape
    from videotgb_torch.ops.correlation_pallas import level_sizes

    total = 0
    sizes = level_sizes(h, w, len(pyramid))
    for lvl, (level, (hl, wl)) in enumerate(zip(pyramid, sizes)):
        fx = torch.floor(coords[..., 0] / 2 ** lvl)
        fy = torch.floor(coords[..., 1] / 2 ** lvl)
        nx = (torch.clamp(fx + radius + 1, max=wl - 1)
              - torch.clamp(fx - radius, min=0) + 1).clamp(min=0)
        ny = (torch.clamp(fy + radius + 1, max=hl - 1)
              - torch.clamp(fy - radius, min=0) + 1).clamp(min=0)
        total += int((nx * ny).sum()) * level.element_size()
    k = 2 * radius + 1
    out = p * h * w * len(pyramid) * k * k * pyramid[0].element_size()
    return total + coords.numel() * 4 + out


def lookup_coords(pairs, hw, dev, gen) -> dict:
    """The lookup probe's "raft" and "wild" coordinates and off-map ones
    (uniform over [-8, hw + 8), partly off every border)."""
    import torch

    from videotgb_torch.tools import lookupprobe as LP

    sets = LP.make_coords(pairs, hw, dev, gen)
    sets["off map"] = torch.rand((pairs, hw, hw, 2), generator=gen,
                                 device=dev) * (hw + 16) - 8.0
    return sets


LOOKUP_TOL = {
    "torch.float32": (1e-4, 1e-4, "f32 sums, 2-tap vs dense hat order"),
    "torch.bfloat16": (2e-2, 2e-2, "both round f32 sums to bf16: <= 1 ulp "
                       "(2^-8 relative) apart"),
}


def check_lookup(card: str) -> dict:
    """Kernel B on both bodies against its plain version, and timed."""
    import torch

    from videotgb_torch.ops import correlation_pallas as CP
    from videotgb_torch.ops import kernels
    from videotgb_torch.tools import lookupprobe as LP

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    hw, radius = 28, 4
    out = None
    for pairs in (16, 256):
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol, why = LOOKUP_TOL[str(dtype)]
            pyr = LP.make_pyramid(pairs, hw, dtype, dev, gen)
            coord_sets = lookup_coords(pairs, hw, dev, gen)
            tile = CP.lookup_tile(pairs, hw, hw, 4, radius, dtype)
            if CP.lookup_body(pyr, coord_sets["raft"], radius) != "tile":
                fail(f"lookup {pairs} pairs {dtype}: the rule does not pick "
                     "the tile body")
            err = 0.0
            for cname, coords in coord_sets.items():
                want = CP.lookup_corr_pyramid_t_plain(pyr, coords, radius)
                for body in ("tile", "gather"):
                    kernels.reset_launches()
                    got = CP.corr_lookup_cuda(pyr, coords, radius, body=body)
                    torch.cuda.synchronize()
                    if kernels.TILE_LAUNCHES["corr_lookup"] != int(
                            body == "tile"):
                        fail(f"lookup: the {body} body was not launched")
                    if got.dtype != dtype or tuple(got.shape) != (
                            pairs, hw, hw, 324):
                        fail(f"lookup output {got.dtype} {tuple(got.shape)}")
                    e = check_close(f"lookup {pairs} pairs {dtype} {cname} "
                                    f"{body} body", got, want, atol, rtol,
                                    why)
                    if body == "tile" and cname == "raft":
                        err = e
                del want
            if dtype == torch.bfloat16:  # the serving path's pyramid dtype
                row_b = lookup_times(card, pyr, coord_sets, radius, tile,
                                     pairs)
                if pairs == 16:
                    out = dict(row_b, max_abs_err=err)
            del pyr, coord_sets
            torch.cuda.empty_cache()
    return out


def lookup_times(card, pyr, coord_sets, radius, tile, pairs) -> dict:
    """Kernel B's two bodies timed on one bf16 pyramid: device time per
    call (``graph_ms``), per eager call and the host's time per call
    (``host_us``), beside the bound from this run's inputs and the plain
    version. Returns the row of the serving shape's RAFT coords."""
    import torch

    from videotgb_torch.ops import correlation_pallas as CP

    iters = 50 if pairs <= 16 else 20
    row_b = None
    for cname, coords in coord_sets.items():
        nbytes = lookup_needed_bytes(pyr, coords, radius)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        t, calls = {}, {}
        for body in ("tile", "gather"):
            def call(body=body):
                return CP.corr_lookup_cuda(pyr, coords, radius, body=body)
            t[body] = (graph_ms(call, iters=iters), time_ms(call))
            calls[body] = call
        host = host_us(calls)
        enc = dict(CP.ENCODE_NS)
        n0 = 10
        for _ in range(n0):
            CP.corr_lookup_cuda(pyr, coords, radius)
        enc_us = (CP.ENCODE_NS["corr_lookup"] - enc["corr_lookup"]) / n0 / 1e3
        log(f"  lookup {pairs} pairs bf16 {cname} coords: tile body "
            f"{t['tile'][0]:.4f} ms device time per call ({t['tile'][1]:.4f} "
            f"per eager call; {host['tile']:.1f} us of host time a call, "
            f"TMA encodes {enc_us:.1f} us of it), gather body "
            f"{t['gather'][0]:.4f} ({t['gather'][1]:.4f}; host "
            f"{host['gather']:.1f} us); bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB needed); tile "
            f"{tuple(tile)} on {card}")
        if cname == "raft":
            plain_ms = time_ms(lambda: CP.lookup_corr_pyramid_t_plain(
                pyr, coords, radius), iters=3, warmup=1)
            log(f"  lookup {pairs} pairs bf16 raft coords: plain version "
                f"{plain_ms:.4f} ms on {card}")
            row_b = row("corr_lookup", "videotgb_torch/csrc/corr_lookup.cu",
                        "videotgb_tpu/ops/correlation_pallas.py:73", 0.0,
                        t["tile"][0], plain_ms, nbytes)
    return row_b


# ------------------------------------------------------------- request batch
def _batch(cfg, b, l_flow, text_len, gen, dev):
    import torch

    tgb_vocab = min(cfg.tgb.vocab_size, 5000)
    lm_vocab = min(cfg.blip2.t5.vocab_size, 5000)
    lo = 4 if tgb_vocab < 200 else 100
    return {
        "flow_mask": torch.ones((b, l_flow + 2), device=dev),
        "video_length": torch.full((b,), l_flow, device=dev),
        "sampler_question_ids": torch.randint(lo, tgb_vocab, (b, text_len),
                                              generator=gen, device=dev),
        "sampler_question_mask": torch.ones((b, text_len), device=dev),
        "question_ids": torch.randint(lo, lm_vocab, (b, text_len),
                                      generator=gen, device=dev),
        "question_mask": torch.ones((b, text_len), device=dev),
    }


# --------------------------------------------------------- flagship main path
def main_path(card: str) -> tuple[dict, dict]:
    import torch

    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.decode import DecodeConfig

    dev = torch.device("cuda")
    cfg = V.bf16_param_config(V.VideoTGBConfig.flagship())
    # serving precision: RAFT's convolutions in bf16, params/norms/flow f32
    cfg = dataclasses.replace(
        cfg, raft=dataclasses.replace(cfg.raft, dtype=torch.bfloat16))
    t0 = time.perf_counter()
    model = V.VideoTGB(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  flagship built on the card: {n_params / 1e6:.1f}M params in "
        f"{build_s:.2f} s")

    b, n_flow, text_len, img = 4, 5, 24, cfg.blip2.vit.image_size
    gen = torch.Generator(device=dev).manual_seed(0)
    frames_u8 = torch.randint(0, 256, (b, cfg.num_frames, img, img, 3),
                              generator=gen, device=dev, dtype=torch.uint8)
    fs = cfg.tgb.flow_size
    flow_u8 = torch.randint(0, 256, (b, n_flow, fs, fs, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
    batch = _batch(cfg, b, n_flow - 1, text_len, gen, dev)
    dcfg = DecodeConfig(max_new_tokens=16,
                        eos_token_id=cfg.blip2.t5.eos_token_id,
                        pad_token_id=cfg.blip2.t5.pad_token_id)
    vocab = cfg.blip2.t5.vocab_size
    sel_gen = torch.Generator(device=dev)
    times = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return out

    def counts():
        return dict(kernels.LAUNCHES)

    def check_tokens(name, tokens):
        if tuple(tokens.shape) != (b, 16):
            fail(f"{name}: tokens {tuple(tokens.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= vocab:
            fail(f"{name}: token ids outside the vocabulary")

    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=dev)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=dev)

    def drive():
        """select -> gather -> answer, then flow_features + generate on the
        same batch; launch counts are read after each phase."""
        snaps = {}
        sel_gen.manual_seed(7)
        cand = run("select_phase_blip2", lambda: V.select_phase_blip2(
            model, flow_u8, batch, generator=sel_gen))
        snaps["select"] = counts()
        sel = run("gather", lambda: frames_u8[
            torch.arange(b, device=dev)[:, None], cand])
        tokens = run("answer_phase_blip2", lambda: V.answer_phase_blip2(
            model, sel, batch, dcfg))
        snaps["answer"] = counts()
        flow = run("flow_features", lambda: model.flow_features(
            flow_u8.float()))
        frames = (frames_u8.float() / 255.0 - mean) / std
        full = dict(batch, frames=frames, flow=flow)
        sel_gen.manual_seed(7)
        tokens_g, cand_g = run("generate_blip2", lambda: V.generate_blip2(
            model, full, dcfg, generator=sel_gen))
        snaps["end"] = counts()
        return cand, sel, tokens, flow, tokens_g, cand_g, snaps

    # one untimed, uncounted pass first: cuDNN / cuBLAS plans, lazy kernel
    # loading and the caching allocator's first allocations
    drive()
    cold = dict(times)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    cand, sel, tokens, flow, tokens_g, cand_g, snaps = drive()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    after_select, after_answer, end = snaps["select"], snaps["answer"], \
        snaps["end"]
    if tuple(cand.shape) != (b, cfg.nframe) or int(cand.min()) < 0 or \
            int(cand.max()) >= cfg.num_frames:
        fail(f"cand_index {tuple(cand.shape)} out of range")
    check_tokens("answer_phase_blip2", tokens)
    if not torch.isfinite(flow).all() or tuple(flow.shape) != (
            b, n_flow - 1, fs, fs, 2):
        fail(f"flow features {tuple(flow.shape)} not finite")
    check_tokens("generate_blip2", tokens_g)
    check_bodies("the serving run", end)

    per_phase = {
        "select_phase_blip2": {k: after_select[k] for k in end},
        "answer_phase_blip2": {k: after_answer[k] - after_select[k]
                               for k in end},
        "flow_features + generate_blip2": {k: end[k] - after_answer[k]
                                           for k in end}}
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    expected = {
        "select_phase_blip2": {**zero, "corr_lookup": cfg.raft.iters,
                               "select_frames": 1},
        "answer_phase_blip2": {**zero, "flash_fwd": cfg.blip2.vit.num_layers},
        "flow_features + generate_blip2": {
            **zero, "flash_fwd": cfg.blip2.vit.num_layers,
            "corr_lookup": cfg.raft.iters, "select_frames": 1}}
    for phase, want in expected.items():
        log(f"  launches in {phase}: {per_phase[phase]} (expected {want})")
        if per_phase[phase] != want:
            fail(f"launch counts of {phase}: {per_phase[phase]} != {want}")
    agree = float((tokens_g == tokens).float().mean())
    same_cand = torch.equal(cand_g, cand)
    log(f"  generate_blip2 vs two-phase (same flow, same noise seed): "
        f"cand equal {same_cand}, greedy tokens agree on {agree:.3f}")
    if not same_cand:
        fail("generate_blip2 and the select phase picked other frames from "
             "equally seeded generators")
    for name, ms in times.items():
        log(f"  wall {name}: {ms:.2f} ms warm ({cold[name]:.2f} ms on the "
            f"first pass) on {card}")
    log(f"  peak device memory {peak_gib:.2f} GiB on {card}")

    # kernel paths against the plain paths, end to end
    with torch.no_grad():
        sel_frames = ((sel.float() / 255.0 - mean) / std).reshape(
            b * cfg.nframe, img, img, 3)
        vit = model.model.vision_model
        flash_out = vit(sel_frames)
        for layer in vit.layers:
            layer.attn.use_flash = False
        plain_out = vit(sel_frames)
        for layer in vit.layers:
            layer.attn.use_flash = True
        vit_diff = rel_diff(flash_out, plain_out)
        raft = model.of_extractor
        raft.config = dataclasses.replace(raft.config, fused_lookup=False)
        dense_flow = model.flow_features(flow_u8.float())
        raft.config = dataclasses.replace(raft.config, fused_lookup=None)
    checks = [
        ("ViT-g flash vs use_flash=False", vit_diff, 5e-2,
         "the two attentions differ by bf16 rounding (2^-8) per layer; over "
         "39 residual layers that walks to ~sqrt(39)*2^-8 = 2.4%"),
        ("flow features: kernel path vs fused_lookup=False", rel_diff(
            flow, dense_flow), 2e-2,
         "the dense path keeps an f32 pyramid where the kernel path keeps "
         "bf16 (as in the JAX package), 20 GRU iterations on random weights"),
    ]
    for name, diff, tol, why in checks:
        log(f"  {name}: relative difference {diff:.3e} (tolerance {tol:g}: "
            f"{why}) {'ok' if diff <= tol else 'MISMATCH'}")
        if not diff <= tol:
            fail(name)
    # where the time of one request batch goes, warm, tower by tower
    parts = {}

    def part(name, fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t) * 1e3 / reps
        return out

    with torch.no_grad():
        blip2 = model.model
        lm = blip2.language_model
        part("raft flow_features", lambda: model.flow_features(flow_u8.float()))
        _, start_logits, end_logits = part(
            "tgb span_logits", lambda: model.span_logits(
                flow, batch["flow_mask"], batch["sampler_question_ids"],
                batch["sampler_question_mask"]))
        emb = part("vit", lambda: blip2.vision_model(sel_frames))
        query = blip2.query_tokens.to(emb.dtype).expand(emb.shape[0], -1, -1)
        visual = part("qformer + pool + projection", lambda: (
            blip2.language_projection(blip2.qformer(query, emb).reshape(
                b, cfg.nframe, query.shape[1], -1).mean(dim=1))))
        embeds, mask = blip2.encoder_inputs(visual, batch["question_ids"],
                                            batch["question_mask"])
        enc = part("t5 encode", lambda: lm.encode(embeds, mask))
        part("t5 decode (16 greedy steps)", lambda: V.t5_generate_from_encoder(
            model, enc, mask, dcfg))
    for name, ms in parts.items():
        log(f"  component {name}: {ms:.2f} ms on {card}")
    # before any trace: a profiler run slows the host's later work
    selection_tail(model, flow_u8, batch, start_logits, end_logits, sel_gen,
                   card)
    # one RAFT refine (16 pairs, 20 lookups) by kernel family
    device_breakdown("RAFT flow_features (one refine of 16 pairs)",
                     lambda: model.flow_features(flow_u8.float()), card)
    # the select phase's own span logits, for kernel D in phase 8
    span = {"start": start_logits, "end": end_logits,
            "video_length": batch["video_length"],
            "num_frames": cfg.num_frames, "nframe": cfg.nframe}
    return dict(end), span


def selection_tail(model, flow_u8, batch, start_logits, end_logits, gen,
                   card) -> None:
    """The select phase's tail, ``model.select_frames`` from its span
    logits to the indices (the seed draw and kernel D), against the plain
    route that ran there before (``ops.select.select_frames``) on the same
    logits: the whole select phase against the same phase ending in the
    plain route, in turns; then the tail's eager wall per call and host
    time per call, and its device operations in one traced call."""
    import statistics

    import torch

    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops.select import select_frames

    cfg = model.config
    vl = batch["video_length"]

    def tree():
        return model.select_frames(start_logits, end_logits, vl, gen,
                                   inclusive_end=False)

    def plain():
        return select_frames(start_logits, end_logits, vl, cfg.num_frames,
                             cfg.nframe, gen, cfg.top_k, cfg.gumbel_tau,
                             inclusive_end=False)

    def plain_phase():
        """select_phase_blip2 with the plain tail, as the parent ran it."""
        flow = model.flow_features(flow_u8.float())
        _, sl, el = model.span_logits(flow, batch["flow_mask"],
                                      batch["sampler_question_ids"],
                                      batch["sampler_question_mask"])
        return select_frames(sl, el, vl, cfg.num_frames, cfg.nframe, gen,
                             cfg.top_k, cfg.gumbel_tau, inclusive_end=False)

    runs = {"select_phase_blip2": lambda: V.select_phase_blip2(
        model, flow_u8, batch, generator=gen),
        "the same, plain tail": plain_phase}
    times = {name: [] for name in runs}
    with torch.no_grad():
        for i in range(10):  # in turns: A B B A ...
            for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                runs[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
    log("  select phase wall, synchronised, 10 runs each in turns: " + "; ".join(
        f"{name} median {statistics.median(v):.2f} ms (min {min(v):.2f}, "
        f"max {max(v):.2f})" for name, v in times.items()) + f" on {card}")
    walls = eager_ms({"kernel D": tree, "plain": plain})
    hosts = host_us({"kernel D": tree, "plain": plain})
    ops = {name: traced(fn)["ops"] for name, fn in (("kernel D", tree),
                                                    ("plain", plain))}
    log(f"  selection tail {tuple(start_logits.shape)}: eager "
        f"{walls['kernel D']:.4f} ms a call with kernel D against "
        f"{walls['plain']:.4f} ms on the plain route (the parent's); host "
        f"{hosts['kernel D']:.1f} against {hosts['plain']:.1f} us a call; "
        f"device operations in one call {ops['kernel D']} against "
        f"{ops['plain']} on {card}")


def traced(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``, synchronised
    (``videotgb_torch.utils.profiling.traced``): the device time of its
    kernels in ms, by name and by family (``profiling.FAMILIES``, the rest
    ``profiling.OTHER``), the number of device operations (kernels and
    copies), and the wall time of the traced run (the trace's own cost
    included)."""
    from videotgb_torch.utils import profiling

    r = profiling.traced(fn, "cuda")
    return {"busy": r["device_total_ms"], "wall": r["wall_ms"],
            "families": {f: g["ms"] for f, g in r["families"].items()},
            "by_name": {n: g["ms"] for n, g in r["by_name"].items()},
            "ops": r["ops"]}


# ------------------------------------------------------------------ kernel C
def profiled_ms(fn, iters=20) -> float:
    """Device time per call of ``fn``: the durations of every kernel it
    launches, summed under ``torch.profiler`` over ``iters`` calls (after
    3 untraced ones); nan where the profiler records no device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    busy = traced(lambda: [fn() for _ in range(iters)])["busy"]
    return busy / iters if busy else float("nan")


def check_flash_bwd(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.attention import (
        NEG_INF,
        dot_product_attention,
        flash_attention,
        flash_backward_cuda,
        flash_backward_reference,
        flash_bwd_passes,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = {torch.bfloat16: (2e-2, "ds and the gradients rounded to bf16 "
                            "(2^-8 of an entry), sums in another order"),
           torch.float32: (1e-4, "f32 summation order only")}

    def strided(b, h, s, d, dtype):
        # the (B, H, S, D) views of (B, S, H, D) projections the models pass
        return torch.randn((b, s, h, d), generator=gen, device=dev).to(
            dtype).transpose(1, 2)

    def shifted(b, h, s, d):
        """bf16 (B, H, S, D) views 4 elements (8 bytes) into an allocation:
        rows not 16-byte aligned, so the CUDA-core body takes them."""
        flat = torch.randn(4 + b * s * h * d, generator=gen,
                           device=dev).to(torch.bfloat16)
        return flat[4:].view(b, s, h, d).transpose(1, 2)

    def pad_bias(b, s, lo):
        lens = torch.randint(lo, s + 1, (b,), generator=gen, device=dev)
        keys = torch.arange(s, device=dev)
        return torch.where(keys[None] < lens[:, None], 0.0,
                           NEG_INF).float()[:, None, None]

    def launch(q, k, v, bias, g, need_ds):
        """One launch of kernel C; returns the gradients and the body that
        ran."""
        before = kernels.MMA_LAUNCHES["flash_bwd"]
        got = flash_backward_cuda(q, k, v, bias, g, q.shape[-1] ** -0.5,
                                  bias_needs_grad=need_ds)
        return got, ("mma" if kernels.MMA_LAUNCHES["flash_bwd"] > before
                     else "fma")

    def case(name, b, h, sq, skv, d, dtype, bias, need_ds=False,
             unaligned=False):
        make = (lambda s: shifted(b, h, s, d)) if unaligned else (
            lambda s: strided(b, h, s, d, dtype))
        q, k, v, g = (make(s) for s in (sq, skv, skv, sq))
        want_body = "mma" if dtype == torch.bfloat16 and not unaligned \
            else "fma"
        got, ran = launch(q, k, v, bias, g, need_ds)
        want = flash_backward_reference(q, k, v, bias, g, d ** -0.5,
                                        bias_needs_grad=need_ds)
        torch.cuda.synchronize()
        if ran != want_body:
            fail(f"flash_bwd {name}: ran the {ran} body, not {want_body}")
        passes = flash_bwd_passes(sq, skv, d) if ran == "mma" else 2
        label = f"flash_bwd {name} [{ran} body, {passes} launch(es)]"
        atol, why = tol[dtype]
        errs = []
        for grad, a, e in zip(("dq", "dk", "dv", "dbias"), got, want):
            if e is None or a is None:
                if (a is None) != (e is None):
                    fail(f"flash_bwd {name}: {grad} missing on one side")
                continue
            if a.dtype != e.dtype or a.shape != e.shape:
                fail(f"flash_bwd {name} {grad}: {a.dtype} {tuple(a.shape)} "
                     f"vs {e.dtype} {tuple(e.shape)}")
            errs.append(check_to_largest(f"{label} {grad}", a, e, atol, why))
        return max(errs), (q, k, v, g)

    def same_bits(name, q, k, v, bias, g, need_ds):
        first, _ = launch(q, k, v, bias, g, need_ds)
        second, _ = launch(q, k, v, bias, g, need_ds)
        torch.cuda.synchronize()
        same = all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(first, second))
        log(f"  flash_bwd {name}: two launches bit-identical: {same}")
        if not same:
            fail(f"flash_bwd {name}: two launches on the same inputs differ")

    b, h, s, d = 8, 32, 160, 64
    # the T5 encoder's bias: relative positions (1,H,S,S) + padding (B,1,1,S)
    t5_bias = (torch.randn((1, h, s, s), generator=gen, device=dev)
               + pad_bias(b, s, 120))
    err_main, (q, k, v, g) = case(
        "main (8,32,160,64) bf16 T5 bias (8,32,160,160)", b, h, s, s, d,
        torch.bfloat16, t5_bias)
    learned = torch.randn((1, h, s, s), generator=gen, device=dev)
    _, ds_inputs = case("learned bias (1,32,160,160) with ds", b, h, s, s, d,
                        torch.bfloat16, learned, need_ds=True)
    same_bits("main", q, k, v, t5_bias, g, False)
    same_bits("learned bias with ds", *ds_inputs[:3], learned, ds_inputs[3],
              True)
    case("padding bias (8,1,1,160)", b, h, s, s, d, torch.bfloat16,
         pad_bias(b, s, 100))
    case("no bias", b, h, s, s, d, torch.bfloat16, None)
    case("f32 T5 bias", 2, h, s, s, d, torch.float32, t5_bias[:2])
    case("bf16 view offset by 4 elements, T5 bias", 2, h, s, s, d,
         torch.bfloat16, t5_bias[:2], unaligned=True)
    case("Sq != Skv 32 x 600, padding (2,1,1,600)", 2, 8, 32, 600, d,
         torch.bfloat16, pad_bias(2, 600, 300))
    case("Sq != Skv 1 x 160, T5 bias", 2, h, 1, s, d, torch.bfloat16,
         t5_bias[:2, :, :1])
    case("Sq != Skv 65 x 160, T5 bias", 2, h, 65, s, d, torch.bfloat16,
         t5_bias[:2, :, :65])
    case("D = 128, (2,8,160,160) learned bias with ds", 2, 8, s, s, 128,
         torch.bfloat16, learned[:, :8], need_ds=True)
    masked = torch.zeros((1, 1, s, s), device=dev)
    masked[..., 10, :] = NEG_INF
    case("fully masked row 10, f32", 1, 4, s, s, d, torch.float32, masked)
    case("fully masked row 10, bf16", 1, 4, s, s, d, torch.bfloat16, masked)
    case("S = 1024, padding (1,1,1,1024)", 1, 8, 1024, 1024, d,
         torch.bfloat16, pad_bias(1, 1024, 900))
    case("S = 1536, padding (1,1,1,1536)", 1, 8, 1536, 1536, d,
         torch.bfloat16, pad_bias(1, 1536, 1300))

    # the forward output and the gradients through the autograd.Function
    # (kernels A and C): the T5 encoder's strided (8,32,160,64) views and its
    # bias, relative positions (1,H,S,S) + padding (B,1,1,S), frozen in bf16
    # and learned in f32; then S = 1200, past the JAX kernel's 1024 limit
    fwd_tol = {torch.bfloat16: (2e-2, 2e-2, "bf16 output rounding (ulp "
                                "2^-8) plus a different f32 summation order"),
               torch.float32: (1e-4, 1e-4, "f32 summation order only")}
    pad = pad_bias(b, s, 120)
    long_qkvg = [strided(1, 8, 1200, d, torch.bfloat16) for _ in range(4)]
    for name, dtype, learned_rel, qkvg, pad_ in (
            ("T5 encoder bf16", torch.bfloat16, False, (q, k, v, g), pad),
            ("T5 encoder f32, learned bias", torch.float32, True,
             (q, k, v, g), pad),
            ("S = 1200 bf16", torch.bfloat16, False, long_qkvg,
             pad_bias(1, 1200, 1000))):
        leaves = [t.detach().to(dtype).requires_grad_() for t in qkvg[:3]]
        heads, seq = leaves[0].shape[1:3]
        rel = torch.randn((1, heads, seq, seq), generator=gen,
                          device=dev).requires_grad_(learned_rel)
        wrt = leaves + ([rel] if learned_rel else [])
        gd = qkvg[3].to(dtype)
        launches = kernels.LAUNCHES["flash_bwd"]
        mma = kernels.MMA_LAUNCHES["flash_bwd"]
        out = flash_attention(*leaves, rel + pad_)
        want_out = dot_product_attention(*leaves, rel + pad_)
        check_close(f"flash_attention forward {name}", out, want_out,
                    *fwd_tol[dtype])
        got = torch.autograd.grad(out, wrt, gd)
        want = torch.autograd.grad(want_out, wrt, gd)
        if kernels.LAUNCHES["flash_bwd"] != launches + 1:
            fail(f"flash_attention {name}: the backward did not launch "
                 "flash_bwd once")
        if kernels.MMA_LAUNCHES["flash_bwd"] - mma != int(
                dtype == torch.bfloat16):
            fail(f"flash_attention {name}: the backward ran the wrong body")
        atol, why = tol[dtype]
        for grad, a, e in zip(("dq", "dk", "dv", "dbias"), got, want):
            check_to_largest(f"flash_attention autograd {name} {grad}", a, e,
                             atol, why + "; autograd of the plain version "
                             "rounds its casts' gradients elsewhere")

    # times at the main shape, each as device time per call (graph_ms), the
    # tensor-core body also per eager call; the CUDA-core body on the same
    # values in views 8 bytes off (its rule's case), in the same run
    scale = d ** -0.5
    passes = flash_bwd_passes(s, s, d)
    log(f"  flash_bwd main shape (8,32,160,64): {passes} launch(es) of the "
        f"tensor-core body (flash_bwd_passes)")
    if passes != 1:
        fail("flash_bwd: the main shape is not on the one-pass launch")
    fq, fk, fv, fg = (shifted(b, h, s, d) for _ in range(4))
    for dst, src in zip((fq, fk, fv, fg), (q, k, v, g)):
        dst.copy_(src)
    if launch(fq, fk, fv, t5_bias, fg, False)[1] != "fma":
        fail("flash_bwd: the shifted views did not take the CUDA-core body")

    def kernel_c(*tensors):
        return lambda: flash_backward_cuda(*tensors[:3], t5_bias, tensors[3],
                                           scale, bias_needs_grad=False)

    ms = graph_ms(kernel_c(q, k, v, g))
    eager_ms = time_ms(kernel_c(q, k, v, g))
    fma_ms = graph_ms(kernel_c(fq, fk, fv, fg), iters=10)
    ds_ms = graph_ms(lambda: flash_backward_cuda(
        q, k, v, learned, g, scale, bias_needs_grad=True))
    plain_ms = graph_ms(lambda: flash_backward_reference(
        q, k, v, t5_bias, g, scale, bias_needs_grad=False), iters=5)
    # SDPA's backward alone: the kernels of autograd.grad through one
    # forward, summed under the profiler (a yardstick the port never calls)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    mask = t5_bias.to(torch.bfloat16)
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         scale=scale)
    lib_ms = profiled_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), g, retain_graph=True))
    if not math.isfinite(lib_ms):
        log("  SDPA backward: the profiler recorded no device time")
        lib_ms = None
    elem = q.element_size()
    nbytes = 7 * b * h * s * d * elem + t5_bias.numel() * 4
    flops = 10 * b * h * s * s * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    # with ds: a (1,32,160,160) learned bias read, the (8,32,160,160) f32 ds
    # written
    ds_bytes = 7 * b * h * s * d * elem + (learned.numel() + b * h * s * s) * 4
    ds_bound = max(ds_bytes / HBM_BYTES_PER_S * 1e3, t_ops)
    lib_txt = "not timed" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  flash_bwd main shape, device time per call: tensor-core body "
        f"{ms:.4f} ms ({eager_ms:.4f} ms a call from eager Python), "
        f"CUDA-core body {fma_ms:.4f} ms ({fma_ms / ms:.2f}x), with ds "
        f"(learned bias) {ds_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"backward {lib_txt}; bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), with ds "
        f"{ds_bound:.4f} ms ({ds_bytes / 1e6:.1f} MB) on {card}")
    if ms > 0.15 or ms > fma_ms / 3:
        log(f"  flash_bwd: the tensor-core body misses its target (at most "
            f"0.15 ms and a third of the CUDA-core body's {fma_ms:.4f} ms)")
    return {"name": "flash_bwd", "route": "cuda",
            "source": "videotgb_torch/csrc/flash_bwd.cu",
            "replaces": "videotgb_tpu/ops/attention.py:215",
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


# ----------------------------------------------------------- training paths
def train_steps(name, trainer, state, batch, expected, card,
                trace=False) -> dict:
    """Step 0 uncounted; step 1 through ``Trainer.train_step``, timed; step
    2 the same step split into forward, backward and optimizer. Launch
    counts are read per step against ``expected``. With ``trace``, two more
    uncounted steps, the second under the profiler (device time by kernel
    family). Returns the launches of the counted steps."""
    import torch

    from videotgb_torch.ops import kernels
    from videotgb_torch.training.optim import optimizer_step

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    t = synced()
    state, m0 = trainer.train_step(state, batch)
    first_ms = (synced() - t) * 1e3
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    torch.cuda.reset_peak_memory_stats()

    def counted(step_name, launches):
        log(f"  {name} launches in {step_name}: {launches} (expected "
            f"{expected})")
        if launches != expected:
            fail(f"{name} launch counts of {step_name}: {launches} != "
                 f"{expected}")
        check_bodies(f"{name} {step_name}", launches)
        for k, v in launches.items():
            totals[k] += v

    kernels.reset_launches()
    t = synced()
    state, m1 = trainer.train_step(state, batch)
    step_ms = (synced() - t) * 1e3
    counted("step 1", dict(kernels.LAUNCHES))

    kernels.reset_launches()
    model, opt = state.model, state.optimizer
    dev = next(model.parameters()).device
    t0 = synced()
    loss, _ = trainer.loss_fn(model, batch, trainer.generator(state.step, dev))
    t1 = synced()
    loss.backward()
    t2 = synced()
    grad_norm = optimizer_step(opt, trainer.schedule(state.step),
                               trainer.config.max_grad_norm)
    t3 = synced()
    counted("step 2", dict(kernels.LAUNCHES))
    m2 = {"loss": loss.detach(), "grad_norm": grad_norm}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = [{k: float(v) for k, v in m.items()} for m in (m0, m1, m2)]
    for i, m in enumerate(metrics):
        log(f"  {name} step {i}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            fail(f"{name} step {i}: non-finite loss or grad norm")
    log(f"  {name} wall ms per step, synchronised: step 0 {first_ms:.2f} "
        f"(first), step 1 {step_ms:.2f} (Trainer.train_step), step 2 "
        f"forward {(t1 - t0) * 1e3:.2f} + backward {(t2 - t1) * 1e3:.2f} + "
        f"optimizer {(t3 - t2) * 1e3:.2f} = {(t3 - t0) * 1e3:.2f}; peak "
        f"device memory {peak_gib:.2f} GiB on {card}")
    if trace:  # after the counted steps: its launches are not counted
        device_breakdown(f"{name} Trainer.train_step",
                         lambda: trainer.train_step(state, batch), card)
    return totals


def e2e_batch(cfg, dev, gen) -> dict:
    """An E2E batch of 8: 32 candidate frames at 224^2, 32-token questions
    (the second half padded by 8) and answers of 32 down to 4 tokens."""
    import torch

    b, text_len, ans_len, img = 8, 32, 32, cfg.blip2.vit.image_size
    vocab = min(cfg.blip2.t5.vocab_size, 5000)
    q_mask = torch.ones((b, text_len), device=dev)
    q_mask[b // 2:, -8:] = 0
    answers = torch.randint(100, vocab, (b, ans_len), generator=gen,
                            device=dev)
    a_len = torch.arange(ans_len, 0, -ans_len // b, device=dev)[:b, None]
    answers = torch.where(torch.arange(ans_len, device=dev)[None] < a_len,
                          answers, cfg.blip2.t5.pad_token_id)
    return {"frames": torch.randn((b, cfg.num_frames, img, img, 3),
                                  generator=gen, device=dev),
            "question_ids": torch.randint(100, vocab, (b, text_len),
                                          generator=gen, device=dev),
            "question_mask": q_mask, "answer_ids": answers}


def tg_batch(cfg, dev, gen) -> dict:
    """A TG batch of 32: 64 flow frames at the TGB's flow size, 24-token
    questions, spans inside the flow."""
    import torch

    b, flow_len, text_len, fs = 32, 64, 24, cfg.tgb.flow_size
    starts = torch.randint(0, flow_len, (b,), generator=gen, device=dev)
    ends = torch.clamp(starts + torch.randint(0, flow_len, (b,), generator=gen,
                                              device=dev), max=flow_len - 1)
    tgb_vocab = min(cfg.tgb.vocab_size, 5000)
    return {"flow": torch.randn((b, flow_len, fs, fs, 2), generator=gen,
                                device=dev),
            "flow_mask": torch.ones((b, flow_len + 2), device=dev),
            "sampler_question_ids": torch.randint(
                100, tgb_vocab, (b, text_len), generator=gen, device=dev),
            "sampler_question_mask": torch.ones((b, text_len), device=dev),
            "starts": starts, "ends": ends}


def train_paths(card: str) -> dict:
    import torch

    from videotgb_torch import train as T
    from videotgb_torch.ops import kernels
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    t = time.perf_counter()
    # configs/model/LSTP_blip2_e2e.yaml; f32 parameters, bf16 compute
    model, cfg = T.build_model({"preset": "flagship", "backbone": "blip2"},
                               device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  flagship (f32 parameters) built: {n_params / 1e6:.1f}M params "
        f"in {time.perf_counter() - t:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(1)

    # ---- E2E: batch 8, 32 candidate frames at 224^2, 32-token Q and A
    batch = e2e_batch(cfg, dev, gen)
    recipe = T.build_recipe({"recipe": "e2e", "tgb_mode": "multi_modal",
                             "selection": "uniform"})
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), recipe.loss_fn,
                      recipe.filter_fn)
    state = trainer.init_state(model)
    params = dict(model.named_parameters())
    trainable = set(trainer.trainable)
    t = time.perf_counter()
    frozen = {n: p.detach().cpu() for n, p in params.items()
              if n not in trainable}
    groups = ("model.qformer.", "model.language_projection.",
              "model.query_tokens")
    before = {n: p.detach().clone() for n, p in params.items()
              if n.startswith(groups)}
    log(f"  E2E: {sum(params[n].numel() for n in trainable) / 1e6:.1f}M "
        f"trainable parameters; frozen ones copied to the host in "
        f"{time.perf_counter() - t:.2f} s")
    expected = {**dict.fromkeys(kernels.LAUNCHES, 0),
                "flash_fwd": cfg.blip2.vit.num_layers
                + cfg.blip2.t5.num_encoder_layers,
                "flash_bwd": cfg.blip2.t5.num_encoder_layers}
    e2e_launches = train_steps("E2E", trainer, state, batch, expected, card,
                               trace=True)
    for group in groups:
        if not any(not torch.equal(params[n], before[n])
                   for n in before if n.startswith(group)):
            fail(f"E2E: no parameter of {group} moved")
    changed = [n for n, p in frozen.items()
               if not torch.equal(params[n].detach().cpu(), p)]
    if changed:
        fail(f"E2E: frozen parameters changed: {changed[:5]}")
    log(f"  E2E: {', '.join(g.rstrip('.') for g in groups)} moved; all "
        f"{len(frozen)} frozen parameters bit-identical")
    del trainer, state, frozen, before, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- TG: batch 32, 64 flow frames at 224^2, 24-token questions
    batch = tg_batch(cfg, dev, gen)
    recipe = T.build_recipe({"recipe": "tg", "tgb_mode": "fusion"})
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), recipe.loss_fn,
                      recipe.filter_fn)
    state = trainer.init_state(model)
    log(f"  TG: {sum(params[n].numel() for n in trainer.trainable) / 1e6:.1f}"
        f"M trainable parameters, dropout on")
    tg_launches = train_steps("TG", trainer, state, batch,
                              dict.fromkeys(expected, 0), card)
    return {k: e2e_launches[k] + tg_launches[k] for k in e2e_launches}


def counted(name, drive, expected, bodies=True) -> dict:
    """Run ``drive`` with every launch count set to 0 just before it; fail
    unless the counts read just after are ``expected`` (0 for every kernel
    not named) and, with ``bodies``, every launch of A, G and C ran the
    tensor-core body and every launch of B and E the tile body."""
    from videotgb_torch.ops import kernels

    want = {**dict.fromkeys(kernels.LAUNCHES, 0), **expected}
    kernels.reset_launches()
    drive()
    got = dict(kernels.LAUNCHES)
    log(f"  launches in {name}: {got} (expected {want})")
    if got != want:
        fail(f"launch counts of {name}: {got} != {want}")
    if bodies:
        check_bodies(name, got)
    return got


def row(name, source, replaces, err, ms, plain_ms, nbytes, flops=0.0,
        dtype="bfloat16", library_ms=None) -> dict:
    """One kernel's entry of the JSON line; the bound is the larger of the
    bytes over the HBM rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"name": name, "route": "triton" if source.endswith(".py")
            else "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# ------------------------------------------------------------------ kernel D
# an empty kernel in kernel D's block (128 threads): the floor that D's
# device time per call is read against, built beside phase 1's libraries
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def start_empty_build():
    """Start ``nvcc`` on ``EMPTY_CU`` into ``build/``; returns the process
    and the library's path."""
    from videotgb_torch.ops import kernels

    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD / "empty_kernel.cu"
    src.write_text(EMPTY_CU)
    lib = kernels.BUILD / f"libempty_kernel.{os.getpid()}.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                             str(lib), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def empty_launcher(proc, lib):
    """Wait for the empty kernel's build; returns a function that launches
    it once on the current stream."""
    import ctypes

    import torch

    out, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc of the empty kernel:\n{out}")
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        rc = fn(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"empty kernel launch failed: cudaError_t {rc}")
    return launch


def check_select(card: str, span: dict, empty) -> dict:
    import torch

    from videotgb_torch.ops.select_pallas import (
        select_frames_cuda,
        select_frames_pallas,
        select_frames_pallas_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    f, nf = span["num_frames"], span["nframe"]

    def batch(b, l):
        """Random logits in the TGB head's (B, L, 2) layout, handed over as
        its strided [..., 0] and [..., 1] views, with the edge rows
        planted: lengths 1 and 2, degenerate (0, 0) peaks, a NaN logit, an
        all-tied row."""
        sl, el = torch.randn((b, l, 2), generator=gen, device=dev).unbind(-1)
        vl = torch.randint(1, l + 1, (b,), generator=gen, device=dev)
        vl[:4] = torch.tensor([1, 2, 1, 2], device=dev)
        sl[4], el[4] = -10.0, -10.0
        sl[4, 0], el[4, 0] = 10.0, 10.0
        sl[5, 3] = float("nan")
        el[6, l - 1] = float("nan")
        sl[7], el[7] = 0.0, 0.0
        return sl, el, vl

    big = batch(1024, 256)
    tg = batch(32, 66)  # the TG recipe: batch 32, 64 flow frames + 2
    # (name, (start, end, lengths), F, nframe): the select phase's own span
    # logits, the JAX benchmark's batch 64 x 4 flow frames, the TG shape,
    # and the long-video widths
    shapes = [
        ("serving", (span["start"], span["end"], span["video_length"]), f,
         nf),
        ("bench batch 64", batch(64, 4), f, nf),
        ("TG", tg, f, nf),
        ("F=128", big, 128, 8),
        ("F=1024", big, 1024, 8),
    ]

    def same(name, got, want):
        ok = torch.equal(got, want)
        log(f"  select {name}: equal to the plain version {ok}")
        if not ok:
            fail(f"select {name} differs from its plain version")

    for name, args, ff, n in shapes:
        kw = dict(num_frames=ff, nframe=n)
        same(f"{name} {tuple(args[0].shape)} F={ff} noise 0",
             select_frames_pallas(*args, 0, noise_scale=0.0, **kw),
             select_frames_pallas_reference(*args, noise_scale=0.0, **kw))
        # handed noise through the route VideoTGB.select_frames takes
        noise = torch.randn((2, 2, *args[0].shape), generator=gen,
                            device=dev)
        same(f"{name} {tuple(args[0].shape)} F={ff} handed noise, int64",
             select_frames_cuda(*args, 0, ff, n, 2, 1.0, False, "minus1",
                                noise=noise, out_dtype=torch.int64),
             select_frames_pallas_reference(*args, noise=noise, **kw).long())
    for ff in (128, 1024):
        for rescale in ("minus1", "ratio"):
            for inclusive in (False, True):
                kw = dict(num_frames=ff, nframe=8, rescale=rescale,
                          inclusive_end=inclusive, noise_scale=0.0)
                same(f"F={ff} nframe=8 {rescale} inclusive_end={inclusive}",
                     select_frames_pallas(*big, 0, **kw),
                     select_frames_pallas_reference(*big, **kw))

    # noise: reproducible per seed, by value or from a device tensor, and
    # the Gumbel law of the plain version
    a, a2, c = (select_frames_pallas(*tg, s, f, nf) for s in (5, 5, 6))
    on_card = select_frames_pallas(*tg, torch.tensor(
        [5], dtype=torch.int32, device=dev), f, nf)
    if not torch.equal(a, a2) or torch.equal(a, c) or not torch.equal(
            a, on_card):
        fail("select with noise: not reproducible per seed, seeds agree, or "
             "a device seed differs from the same seed by value")
    for name, args, ff, _ in shapes[:3]:
        noisy = select_frames_pallas(*args, 11, ff, nf)
        if int(noisy.min()) < 0 or int(noisy.max()) >= ff:
            fail(f"select {name} with noise: frame index out of range")
    b, l = 65536, 66
    zeros = torch.zeros((b, l), device=dev)
    vl = torch.full((b,), l - 2, device=dev)
    got = select_frames_pallas(zeros, zeros, vl, 12, f, nf)
    want = select_frames_pallas_reference(zeros, zeros, vl, f, nf,
                                          generator=gen)
    freq = [torch.bincount(x.flatten().long(), minlength=f).double()
            / x.numel() for x in (got, want)]
    dfreq = float((freq[0] - freq[1]).abs().max())
    log(f"  select noise histogram over {b} zero-logit rows: max |dfreq| "
        f"{dfreq:.2e} (tolerance 0.01: each frequency is ~1/{f} of "
        f"{b * nf} draws, sd ~7e-4) {'ok' if dfreq <= 0.01 else 'MISMATCH'}")
    if not dfreq <= 0.01:
        fail("select noise histogram differs from the plain version's")

    # device time per call (graph_ms) against an empty kernel's, host time
    # per call, the plain version's eager time, the bytes bound
    floor_ms = graph_ms(empty)
    calls = {name: (lambda a=args, ff=ff, n=n: select_frames_pallas(
        *a, 11, ff, n)) for name, args, ff, n in shapes}
    hosts = host_us(calls)
    timed = {}
    for name, args, ff, n in shapes:
        ms = graph_ms(calls[name])
        plain_ms = time_ms(lambda a=args, ff=ff, n=n:
                           select_frames_pallas_reference(
                               *a, ff, n, generator=gen))
        bsz, length = args[0].shape
        nbytes = (8 * bsz * length + args[2].element_size() * bsz
                  + 4 * bsz * n)
        timed[name] = (ms, plain_ms, nbytes)
        log(f"  select {name} {(bsz, length)} F={ff}: kernel D {ms:.4f} ms "
            f"device time per call ({ms / floor_ms:.2f}x the empty "
            f"kernel's {floor_ms:.4f}), host {hosts[name]:.1f} us a call; "
            f"plain {plain_ms:.4f} ms eager; bytes bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.2e} ms ({nbytes} B) on {card}")
    ms, plain_ms, nbytes = timed["serving"]
    return row("select_frames", "videotgb_torch/csrc/select_frames.cu",
               "videotgb_tpu/ops/select_pallas.py:32", 0.0, ms, plain_ms,
               nbytes)


# ------------------------------------------------------------------ kernel E
def check_blocked_lookup(card: str) -> dict:
    import torch

    from videotgb_torch.ops import correlation_pallas as CP
    from videotgb_torch.tools import lookupprobe as LP

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    pairs, hw, radius, n_loop = 256, 28, 4, 20
    out = None
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol, why = LOOKUP_TOL[str(dtype)]
        pyr = LP.make_pyramid(pairs, hw, dtype, dev, gen)
        coord_sets = lookup_coords(pairs, hw, dev, gen)
        err = 0.0
        # the probe's block (qb 128) on every coordinate set; in bf16 every
        # qb the entry takes on RAFT's
        qbs = (32, 64, 96, 128) if dtype == torch.bfloat16 else (128,)
        for cname, coords in coord_sets.items():
            want = CP.lookup_corr_pyramid_t_plain(pyr, coords, radius)
            for qb in qbs if cname == "raft" else (128,):
                for skip in (False, True):
                    got = LP.blocked_lookup(pyr, coords, radius, qb=qb,
                                            skip=skip)
                    torch.cuda.synchronize()
                    if got.dtype != dtype or tuple(got.shape) != (
                            pairs, hw, hw, 324):
                        fail(f"blocked lookup {got.dtype} "
                             f"{tuple(got.shape)}")
                    e = check_close(
                        f"blocked lookup {dtype} {cname} qb={qb} "
                        f"skip={skip}", got, want, atol, rtol, why)
                    err = max(err, e)
            del want
        if dtype == torch.bfloat16:  # the probe's pyramid dtype
            coords = coord_sets["raft"]
            nbytes = lookup_needed_bytes(pyr, coords, radius)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            times = {}
            for cname in ("raft", "wild"):
                for qb in qbs:
                    for skip in (False, True):
                        def call(qb=qb, skip=skip, c=coord_sets[cname]):
                            return LP.blocked_lookup(pyr, c, radius, qb=qb,
                                                     skip=skip)
                        times[cname, qb, skip] = (graph_ms(call, iters=20),
                                                  time_ms(call))
                b_ms = graph_ms(lambda c=coord_sets[cname]:
                                CP.lookup_corr_pyramid_t(pyr, c, radius),
                                iters=20)
                log(f"  one lookup, {pairs} pairs bf16, {cname} coords, ms "
                    "device time per call (per eager call): kernel E " +
                    "; ".join(f"qb {qb} " + ("qskip" if skip else "qblock")
                              + f" {times[cname, qb, skip][0]:.4f} "
                              f"({times[cname, qb, skip][1]:.4f})"
                              for qb in qbs for skip in (False, True))
                    + f"; kernel B (rule's block) {b_ms:.4f} on {card}")
            plain_ms = time_ms(lambda: CP.lookup_corr_pyramid_t_plain(
                pyr, coords, radius), iters=3, warmup=1)
            log(f"  one lookup, {pairs} pairs bf16, raft coords: plain "
                f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f}"
                f" MB needed) on {card}")
            launches = 0
            for skip in (False, True):
                launches += counted(
                    f"{n_loop} chained lookups, skip={skip}",
                    lambda skip=skip: float(LP.chained(
                        lambda p, c: LP.blocked_lookup(p, c, radius,
                                                       skip=skip),
                        pyr, coords, n_loop)),
                    {"corr_lookup_blocked": n_loop})["corr_lookup_blocked"]
            out = row("corr_lookup_blocked",
                      "videotgb_torch/csrc/corr_lookup_blocked.cu",
                      "tools/lookupprobe.py:51", err,
                      times["raft", 128, True][0], plain_ms, nbytes)
            out["launches"] = launches
        del pyr, coord_sets
        torch.cuda.empty_cache()
    log("  the probe tool: python -m videotgb_torch.tools.lookupprobe "
        "--iters 3")
    LP.main(["--iters", "3"])
    return out


# ------------------------------------------------------------------ kernel F
def check_ln(card: str) -> list:
    import torch
    import torch.nn.functional as F

    from videotgb_torch.tools import lnprobe as LN

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    frames, layers = 256, 4
    width = LN.HEADS * LN.HEAD_DIM
    shape = (frames, LN.TOKENS, width)
    tol = {torch.bfloat16: (2e-2, 2e-2, "one bf16 rounding (<= 2^-7 "
                            "relative) of f32 stats summed in another order"),
           torch.float32: (1e-4, 1e-4, "f32 summation order only")}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        res, delta = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for _ in range(2))
        g = 1.0 + 0.1 * torch.randn((width,), generator=gen, device=dev)
        b = 0.1 * torch.randn((width,), generator=gen, device=dev)
        summed, normed = LN.add_ln(res, delta, g, b)
        alone = LN.ln(res, g, b)
        want_sum, want_norm = LN.add_ln_reference(res, delta, g, b)
        torch.cuda.synchronize()
        if not torch.equal(summed, want_sum):
            fail(f"add_ln {dtype}: the sum output differs from res + delta")
        errs["add_ln", dtype] = check_close(f"add_ln {dtype} {shape}", normed,
                                            want_norm, *tol[dtype])
        errs["ln", dtype] = check_close(f"ln {dtype} {shape}", alone,
                                        LN.ln_reference(res, g, b),
                                        *tol[dtype])
        del summed, normed, alone, want_sum, want_norm

    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = LN.make_weights(width, LN.MLP, x.dtype, dev, gen)
    runs = LN.stacks(x, w, layers, LN.HEADS, 4)
    launches = {}
    with torch.no_grad():
        for v, kern in (("a", None), ("b", "add_ln"), ("c", "ln")):
            want = {"flash_fwd": layers, **({kern: 2 * layers} if kern
                                            else {})}
            got = counted(f"the {layers}-layer stack, variant ({v})",
                          lambda v=v: float(runs[v]().float().sum()), want)
            if kern:
                launches[kern] = got[kern]
        delta = torch.randn(shape, generator=gen, device=dev).to(x.dtype)
        g, b = w["g1"], w["b1"]
        g_lib, b_lib = g.to(x.dtype), b.to(x.dtype)
        t = {"add_ln": time_ms(lambda: LN.add_ln(x, delta, g, b)),
             "add_ln plain": time_ms(lambda: LN.add_ln_reference(
                 x, delta, g, b)),
             "ln": time_ms(lambda: LN.ln(x, g, b)),
             "ln plain": time_ms(lambda: LN.ln_reference(x, g, b)),
             "F.layer_norm": time_ms(lambda: F.layer_norm(
                 x, (width,), g_lib, b_lib, 1e-6)),
             "F.layer_norm of res + delta": time_ms(lambda: F.layer_norm(
                 x + delta, (width,), g_lib, b_lib, 1e-6))}
    n = x.numel() * x.element_size()
    nbytes = {"add_ln": 4 * n + 2 * width * 4, "ln": 2 * n + 2 * width * 4}
    log(f"  F at {shape} bf16: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in t.items()) + "; bounds " + ", ".join(
        f"{k} {v / HBM_BYTES_PER_S * 1e3:.4f} ms ({v / 1e6:.1f} MB)"
        for k, v in nbytes.items()) + f" on {card}")
    rows = []
    for name in ("add_ln", "ln"):
        r = row(name, "videotgb_torch/tools/lnprobe.py",
                "tools/lnprobe.py:93" if name == "add_ln"
                else "tools/lnprobe.py:129",
                errs[name, torch.bfloat16], t[name], t[name + " plain"],
                nbytes[name], library_ms=t["F.layer_norm"])
        r["launches"] = launches[name]
        rows.append(r)
    del runs, x, w, delta
    torch.cuda.empty_cache()
    log("  the probe tool: python -m videotgb_torch.tools.lnprobe --iters 3")
    LN.main(["--iters", "3"])
    return rows


# ------------------------------------------------------------------ kernel G
def check_bshd(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.attention import flash_attention
    from videotgb_torch.tools import attnlayoutprobe as AL

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    frames, layers, h, d = 128, 4, AL.HEADS, AL.HEAD_DIM
    width = h * d
    scale = d ** -0.5
    tol = {torch.bfloat16: (2e-2, 2e-2, "bf16 output rounding (ulp 2^-8) "
                            "plus a different f32 summation order"),
           torch.float32: (1e-4, 1e-4, "f32 summation order only")}
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((frames, AL.TOKENS, width), generator=gen,
                        device=dev).to(dtype)
        w = AL.make_weights(width, dtype, dev, gen)
        q, k, v = AL._project(x, w, h)
        kernels.reset_launches()
        got = AL.flash_bshd(q, k, v, scale)
        want = AL.flash_bshd_reference(q, k, v, scale)
        via_a = flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                scale=scale).transpose(1, 2)
        torch.cuda.synchronize()
        body = "mma" if dtype == torch.bfloat16 else "fma"
        ran = {k: kernels.MMA_LAUNCHES[k] for k in ("flash_fwd",
                                                     "flash_bshd")}
        log(f"  flash_bshd {dtype}: tensor-core body launches {ran} "
            f"(expected the {body} body for G and for A)")
        if ran != dict.fromkeys(ran, int(body == "mma")):
            fail(f"flash_bshd {dtype}: not on the {body} body")
        e = check_close(f"flash_bshd {dtype} {tuple(q.shape)}", got, want,
                        *tol[dtype])
        check_close(f"flash_bshd {dtype} vs kernel A on the transposes", got,
                    via_a, *tol[dtype])
        if dtype == torch.bfloat16:
            err = e
        del got, want, via_a
    launches = None
    with torch.no_grad():
        for v_, kern in (("a", "flash_fwd"), ("b", "flash_bshd"),
                         ("c", None)):
            got = counted(
                f"the {layers}-layer stack, variant ({v_})",
                lambda v_=v_: float(AL.stack(AL.LAYERS[v_], x, w, layers,
                                             h).float().sum()),
                {kern: layers} if kern else {})
            if v_ == "b":
                launches = got["flash_bshd"]
        # device time per call (graph_ms), without a call's host overhead
        ms = graph_ms(lambda: AL.flash_bshd(q, k, v, scale))
        plain_ms = graph_ms(lambda: AL.flash_bshd_reference(q, k, v, scale),
                            iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        a_ms = graph_ms(lambda: flash_attention(qt, kt, vt, scale=scale))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * frames * h * AL.TOKENS ** 2 * d
    out = row("flash_bshd", "videotgb_torch/csrc/flash_bshd.cu",
              "tools/attnlayoutprobe.py:90", err, ms, plain_ms, nbytes,
              flops, library_ms=lib_ms)
    log(f"  flash_bshd {tuple(q.shape)} bf16: kernel G {ms:.4f} ms, kernel "
        f"A on the transposes {a_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"on the transposes {lib_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) on {card}")
    out["launches"] = launches
    del x, w, q, k, v
    torch.cuda.empty_cache()
    log("  the probe tool: python -m videotgb_torch.tools.attnlayoutprobe "
        "--iters 3")
    AL.main(["--iters", "3"])
    return out



# ------------------------------------------------------------------ kernel H
# the int8 ViT-g's products at 16 images x 264 tokens: (M, K, N, per layer)
VIT_GEMMS = ((4224, 1408, 1408, 4), (4224, 1408, 6144, 1),
             (4224, 6144, 1408, 1))
# the same products for one image (264 tokens): small M
ONE_IMAGE_GEMMS = tuple((264, k, n, c) for _, k, n, c in VIT_GEMMS)


def check_gemms(card: str) -> list:
    import torch

    from videotgb_torch.device import configure_precision
    from videotgb_torch.ops import quant as Q

    configure_precision()  # the bf16 plain version: a full-f32 product
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    tiles = range(len(Q.TILES))

    def tile_name(tile):
        return "rule's pick" if tile is None else Q.TILES[tile]

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def exact(name, x, w_t):
        for out_dtype in (torch.int32, torch.bfloat16):
            want = Q.int8_mm_reference(x, w_t, out_dtype)
            for tile in (*tiles, None):
                got = Q.int8_mm(x, w_t, out_dtype, tile=tile)
                torch.cuda.synchronize()
                same = got.dtype == out_dtype and torch.equal(got, want)
                log(f"  int8_mm {name} {tile_name(tile)} -> {out_dtype}: "
                    f"equal to the plain version {same}")
                if not same:
                    fail(f"int8_mm {name} tile {tile_name(tile)} {out_dtype} "
                         "differs from its plain version")

    cube = 8192
    x8, w8 = ints(cube, cube), ints(cube, cube)
    exact(f"{cube}^3", x8, w8)
    for m, k, n, _ in VIT_GEMMS:
        exact(f"ViT-g {m}x{k}x{n}", ints(m, k), ints(n, k))
    exact("odd 1001x1424x999", ints(1001, 1424), ints(999, 1424))
    sign = torch.randint(0, 2, (4224 + 1408, cube), generator=gen,
                         device=dev) * 2 - 1
    xs, ws = (sign * 127).to(torch.int8).split([4224, 1408])
    exact("+-127 4224x8192x1408", xs, ws)
    full = torch.full((256, cube), 127, dtype=torch.int8, device=dev)
    exact("all 127 256x8192x256 (accumulators 127^2 * 8192)", full, full)
    del sign, xs, ws, full

    xb = torch.randn((cube, cube), generator=gen, device=dev).to(
        torch.bfloat16)
    wb = torch.randn((cube, cube), generator=gen, device=dev).to(
        torch.bfloat16)
    want = Q.bf16_mm_reference(xb, wb).float()
    order = cube * 2.0 ** -24 * float(xb.float().abs().max()
                                      * wb.float().abs().max())
    ulp = Q.bf16_ulp(want)
    bf16_err = 0.0
    for tile in (*tiles, None):
        got = Q.bf16_mm(xb, wb, tile=tile)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        ok = got.dtype == torch.bfloat16 and bool((err <= ulp + order).all())
        worst = float((err / (ulp + order)).max())
        bf16_err = max(bf16_err, float(err.max()))
        log(f"  bf16_mm {cube}^3 {tile_name(tile)}: max_abs_err "
            f"{float(err.max()):.3e}, at most {worst:.3f} of the tolerance "
            f"(one bf16 ulp of the entry + the f32 summation order's "
            f"{order:.3e}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"bf16_mm tile {tile_name(tile)} disagrees with its plain "
                 "version")
    del want, ulp

    # device time per call (graph_ms: captured launches, no host issue
    # time) of every tiling, the rule's pick also per eager call (CUDA
    # events over back-to-back calls), the plain version and
    # the library's one call
    def gemm_times(label, kern, plain, lib, flops, unit, iters, pick):
        tile_ms = {t: graph_ms(lambda t=t: kern(t), iters=iters)
                   for t in tiles}
        eager_ms = time_ms(lambda: kern(pick))
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = graph_ms(lib, iters=iters)
        best = min(tile_ms, key=tile_ms.get)
        peak = PEAK_FLOPS["int8" if unit == "TOP/s" else "bfloat16"]
        log(f"  {label}: kernel " + ", ".join(
            f"{Q.TILES[t]} {ms:.4f} ms ({flops / ms / 1e9:.1f} {unit})"
            for t, ms in tile_ms.items()) + f"; fastest {Q.TILES[best]}")
        log(f"    rule's pick {Q.TILES[pick]} {tile_ms[pick]:.4f} ms, "
            f"{eager_ms:.4f} ms a call from eager Python; plain "
            f"{plain_ms:.4f} ms; library {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.1f} {unit}); bound "
            f"{flops / peak * 1e3:.4f} ms (operations) on {card}")
        return tile_ms[pick], plain_ms, lib_ms

    rows = []
    for i, (m, k, n, _) in enumerate(VIT_GEMMS + ONE_IMAGE_GEMMS):
        xv, wv = ints(m, k), ints(n, k)
        whose = "the W8A8 path's" if i < len(VIT_GEMMS) else "one image"
        times = gemm_times(
            f"int8_mm {m}x{k}x{n} -> int32 ({whose})",
            lambda t: Q.int8_mm(xv, wv, tile=t),
            lambda: Q.int8_mm_reference(xv, wv),
            lambda: torch._int_mm(xv, wv.t()), 2 * m * k * n, "TOP/s", 20,
            Q.gemm_tile(m, n, k, torch.int8))
        if i == 1:  # the path's largest product, MLP in
            rows.append(row("int8_mm", "videotgb_torch/csrc/int8_mm.cu",
                            "tools/int8pallas_probe.py:22", 0.0, *times[:2],
                            m * k + n * k + 4 * m * n, 2 * m * k * n,
                            "int8", times[2]))
    del xv, wv
    flops = 2 * cube ** 3
    gemm_times(f"int8_mm {cube}^3 -> bf16 (the probe's)",
               lambda t: Q.int8_mm(x8, w8, torch.bfloat16, tile=t),
               lambda: Q.int8_mm_reference(x8, w8, torch.bfloat16),
               lambda: torch._int_mm(x8, w8.t()).to(torch.bfloat16), flops,
               "TOP/s", 10, Q.gemm_tile(cube, cube, cube, torch.int8))
    ms, plain_ms, lib_ms = gemm_times(
        f"bf16_mm {cube}^3", lambda t: Q.bf16_mm(xb, wb, tile=t),
        lambda: Q.bf16_mm_reference(xb, wb), lambda: xb @ wb.t(), flops,
        "TF/s", 10, Q.gemm_tile(cube, cube, cube, torch.bfloat16))
    rows.append(row("bf16_mm", "videotgb_torch/csrc/bf16_mm.cu",
                    "tools/int8pallas_probe.py:80", bf16_err, ms, plain_ms,
                    6 * cube * cube, flops, "bfloat16", lib_ms))
    for r in rows:
        log(f"  {r['name']} row: {r['ms']:.4f} ms at the rule's pick, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']:.4f} ms")
    del x8, w8, xb, wb
    torch.cuda.empty_cache()
    return rows


def device_breakdown(name, fn, card) -> None:
    """One traced run of ``fn`` (after an untraced one): device time by
    kernel family and the device's idle share of the synchronised wall
    time (the trace's own cost included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    r = traced(fn)
    if not r["busy"]:
        log(f"  {name}: the profiler recorded no device time (traced wall "
            f"{r['wall']:.2f} ms)")
        return
    top = sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:5]
    log(f"  {name}, traced: device busy {r['busy']:.2f} ms of "
        f"{r['wall']:.2f} ms wall (idle share {1 - r['busy'] / r['wall']:.3f});"
        " by family " + ", ".join(f"{f} {ms:.2f} ms"
                                  for f, ms in r["families"].items())
        + "; top kernels " + "; ".join(f"{k[:48]} {ms:.2f} ms"
                                       for k, ms in top) + f" on {card}")


def int8_serving_path(card: str) -> int:
    """The W8A8 flagship for 4 requests; returns int8_mm's launches in the
    counted select -> answer run."""
    import torch

    from videotgb_torch.models import videotgb as V
    from videotgb_torch.models.vit import ViTModel
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops import quant as Q
    from videotgb_torch.ops.decode import DecodeConfig

    dev = torch.device("cuda")
    cfg = V.bf16_param_config(V.VideoTGBConfig.flagship())
    blip2 = dataclasses.replace(cfg.blip2, vit=dataclasses.replace(
        cfg.blip2.vit, quant="int8"))  # bench.py's BENCH_INT8 configuration
    cfg = dataclasses.replace(cfg, blip2=blip2, raft=dataclasses.replace(
        cfg.raft, dtype=torch.bfloat16))
    t0 = time.perf_counter()
    model = V.VideoTGB(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"  W8A8 flagship built in {time.perf_counter() - t0:.2f} s")
    b, n_flow, text_len, img = 4, 5, 24, cfg.blip2.vit.image_size
    gen = torch.Generator(device=dev).manual_seed(0)
    frames_u8 = torch.randint(0, 256, (b, cfg.num_frames, img, img, 3),
                              generator=gen, device=dev, dtype=torch.uint8)
    fs = cfg.tgb.flow_size
    flow_u8 = torch.randint(0, 256, (b, n_flow, fs, fs, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
    batch = _batch(cfg, b, n_flow - 1, text_len, gen, dev)
    dcfg = DecodeConfig(max_new_tokens=16,
                        eos_token_id=cfg.blip2.t5.eos_token_id,
                        pad_token_id=cfg.blip2.t5.pad_token_id)
    sel_gen = torch.Generator(device=dev)
    times = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return out

    def drive():
        sel_gen.manual_seed(7)
        cand = run("select_phase_blip2", lambda: V.select_phase_blip2(
            model, flow_u8, batch, generator=sel_gen))
        after_select = dict(kernels.LAUNCHES)
        sel = frames_u8[torch.arange(b, device=dev)[:, None], cand]
        tokens = run("answer_phase_blip2 (int8 ViT-g)",
                     lambda: V.answer_phase_blip2(model, sel, batch, dcfg))
        return cand, sel, tokens, after_select

    drive()  # warm, uncounted
    kernels.reset_launches()
    Q.ENCODE_NS["int8_mm"] = 0
    cand, sel, tokens, after_select = drive()
    end = dict(kernels.LAUNCHES)
    check_bodies("the W8A8 serving run", end)
    encode_us = Q.ENCODE_NS["int8_mm"] / 1e3
    log(f"  host time of kernel H's TMA descriptor encodes (two a call) in "
        f"the counted run: {encode_us / max(end['int8_mm'], 1):.3f} us a "
        f"call, {encode_us:.1f} us over its {end['int8_mm']} calls")
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    layers = cfg.blip2.vit.num_layers
    for phase, got, want in (
            ("select_phase_blip2", after_select,
             {**zero, "corr_lookup": cfg.raft.iters, "select_frames": 1}),
            ("answer_phase_blip2", {k: end[k] - after_select[k] for k in end},
             {**zero, "flash_fwd": layers, "int8_mm": 6 * layers})):
        log(f"  W8A8 launches in {phase}: {got} (expected {want})")
        if got != want:
            fail(f"W8A8 launch counts of {phase}: {got} != {want}")
    if tuple(tokens.shape) != (b, 16) or int(tokens.min()) < 0 or int(
            tokens.max()) >= cfg.blip2.t5.vocab_size:
        fail(f"W8A8 answer tokens {tuple(tokens.shape)} out of range")

    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=dev)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=dev)
    frames = ((sel.float() / 255.0 - mean) / std).reshape(
        b * cfg.nframe, img, img, 3)
    vit_q = model.model.vision_model
    denses = [m for m in vit_q.modules() if hasattr(m, "use_kernel")]
    with torch.no_grad():
        out_k = vit_q(frames)
        for m in denses:
            m.use_kernel = False
        out_p = vit_q(frames)
        for m in denses:
            m.use_kernel = True
        same = torch.equal(out_k, out_p)
        log(f"  ViT-g W8A8 over {b * cfg.nframe} images: kernel H route "
            f"bit-identical to the plain route {same}")
        if not same:
            fail("the W8A8 ViT-g differs between kernel H and its plain "
                 "version")
        vit_b = ViTModel(dataclasses.replace(cfg.blip2.vit, quant=None),
                         device=dev)
        vit_b.load_state_dict(vit_q.state_dict())
        out_b = vit_b(frames)
        a, q = out_b.float(), out_k.float()
        rel = rel_diff(q, a)
        cos = float(((a * q).sum(-1) / (a.norm(dim=-1) * q.norm(dim=-1)
                                         + 1e-8)).min())
        ok = rel < 0.08 and cos > 0.99
        log(f"  ViT-g W8A8 against bf16, same weights and images: relative "
            f"{rel:.4e} (gate < 0.08), min token cosine {cos:.6f} (gate > "
            f"0.99; the JAX package's tests/test_quant.py) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("the W8A8 ViT-g is outside the int8 gate of the bf16 tower")
        vit_ms = {"int8": time_ms(lambda: vit_q(frames), iters=5, warmup=1),
                  "bf16": time_ms(lambda: vit_b(frames), iters=5, warmup=1)}
        device_breakdown(f"ViT-g W8A8 over {b * cfg.nframe} images",
                         lambda: vit_q(frames), card)
        device_breakdown(f"ViT-g bf16 over {b * cfg.nframe} images",
                         lambda: vit_b(frames), card)
        # the int8 tower's parts at its own shapes, summed over 39 layers
        parts = dict.fromkeys(("int8_mm", "weight quantize",
                               "activation quantize", "dequant + bias",
                               "int8_matmul + bias (whole)",
                               "bf16 F.linear"), 0.0)
        layer = vit_q.layers[0]
        for (m, k, n, per_layer), dense in zip(
                VIT_GEMMS, (layer.attn.q, layer.mlp.wi, layer.mlp.wo)):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            w = dense.weight
            bias = dense.bias.to(torch.bfloat16)
            xq, xs = Q.quantize_rows(x)
            wq, ws = Q.quantize_cols(w.T)
            acc = Q.int8_mm(xq, wq.T)
            reps = per_layer * layers
            for name, fn in (
                    ("int8_mm", lambda: Q.int8_mm(xq, wq.T)),
                    ("weight quantize", lambda: Q.quantize_cols(w.T)),
                    ("activation quantize", lambda: Q.quantize_rows(x)),
                    ("dequant + bias", lambda: (acc.float() * xs * ws).to(
                        torch.bfloat16) + bias),
                    ("int8_matmul + bias (whole)", lambda: dense(x)),
                    ("bf16 F.linear", lambda: torch.nn.functional.linear(
                        x, w, bias))):
                parts[name] += time_ms(fn, iters=10, warmup=2) * reps
        del vit_b
    log(f"  ViT-g over {b * cfg.nframe} images: int8 {vit_ms['int8']:.2f} "
        f"ms, bf16 {vit_ms['bf16']:.2f} ms on {card}")
    log("  the int8 tower's products, each part timed alone at its shapes x "
        f"its count per pass: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in parts.items()) + f" on {card}")

    # the answer phase with the bf16 ViT-g in the same model
    model.model.vision_model = ViTModel(dataclasses.replace(
        cfg.blip2.vit, quant=None), device=dev)
    model.model.vision_model.load_state_dict(vit_q.state_dict())
    for _ in range(2):  # the first one warm-up
        run("answer_phase_blip2 (bf16 ViT-g)",
            lambda: V.answer_phase_blip2(model, sel, batch, dcfg))
    model.model.vision_model = vit_q
    for name, ms in times.items():
        log(f"  wall {name}: {ms:.2f} ms on {card}")
    del model
    return end["int8_mm"]


def check_int8_tools(card: str) -> int:
    """The three int8 tools; returns bf16_mm's launches in the GEMM
    probe's counted run."""
    from videotgb_torch.ops import quant as Q
    from videotgb_torch.tools import int8pallas_probe, int8probe, int8sweep

    iters = 3
    calls = len(Q.TILES) * (iters + 1)  # one warm-up call per line
    log(f"  the GEMM probe: python -m videotgb_torch.tools.int8pallas_probe "
        f"--iters {iters}")
    got = counted("the GEMM probe at 8192^3",
                  lambda: int8pallas_probe.main(["--iters", str(iters)]),
                  {"int8_mm": calls, "bf16_mm": calls})
    log(f"  the sweep: python -m videotgb_torch.tools.int8sweep --iters "
        f"{iters}")
    int8sweep.main(["--iters", str(iters)])
    log("  the tower probe: python -m videotgb_torch.tools.int8probe "
        "--iters 2")
    int8probe.main(["--iters", "2"])
    return got["bf16_mm"]


# ------------------------------------------------ InstructBLIP-Vicuna path
def vicuna_requests(cfg, dev, seed=14):
    """4 Vicuna requests: frames (4, 32, 224, 224, 3) and flow frames (4, 5,
    fs, fs, 3) uint8, and a batch of 64-token prompts right-padded from 40
    to 64 real tokens, the Q-Former reading the sampler's question."""
    import torch

    b, n_flow, text_len, img = 4, 5, 64, cfg.vit.image_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames_u8 = torch.randint(0, 256, (b, cfg.num_frames, img, img, 3),
                              generator=gen, device=dev, dtype=torch.uint8)
    fs = cfg.tgb.flow_size
    flow_u8 = torch.randint(0, 256, (b, n_flow, fs, fs, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
    lengths = torch.tensor([64, 56, 48, 40], device=dev)
    mask = (torch.arange(text_len, device=dev)[None]
            < lengths[:, None]).float()
    batch = {
        "flow_mask": torch.ones((b, n_flow + 1), device=dev),
        "video_length": torch.full((b,), n_flow - 1, device=dev),
        "sampler_question_ids": torch.randint(100, 5000, (b, text_len),
                                              generator=gen, device=dev),
        "sampler_question_mask": mask,
        "question_ids": torch.randint(100, 5000, (b, text_len),
                                      generator=gen, device=dev),
        "question_mask": mask}
    batch["qformer_input_ids"] = batch["sampler_question_ids"]
    batch["qformer_attention_mask"] = mask
    return frames_u8, flow_u8, batch


def vicuna_path(card: str) -> dict:
    """Phase 14: InstructBLIP-Vicuna-7B at flagship width, built on the card
    without a ``device`` (bf16 parameters, RAFT's convolutions in bf16 as in
    phase 4), random weights from a seed, 4 requests: 64-token prompts
    (right-padded to 64, 40 to 64 real tokens), 4 flow pairs, 32 candidate
    frames at 224^2, 128 new tokens. (a) ``select_phase_blip2`` in
    "multi_modal" mode with the "ratio" rule -> gather ->
    ``answer_phase_instructblip``, with exact launches per phase (B 20 on
    the tile body and D 1; A 39 on the ViT-g and 32 on the prefill, whose
    96 x 224 scores pass the 128^2 dispatch rule; none in a decode step);
    (b) ``flow_features`` + ``generate_instructblip`` on the same batch and
    noise seed: the same frames and tokens as (a). Then the wall time of
    each part, warm. Returns the launches of the counted run."""
    import torch

    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.decode import DecodeConfig

    dev = torch.device("cuda")
    cfg = V.bf16_param_config(V.VideoTGBConfig.flagship("instructblip"))
    cfg = dataclasses.replace(
        cfg, raft=dataclasses.replace(cfg.raft, dtype=torch.bfloat16))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = V.VideoTGB(cfg, seed=0)
    torch.cuda.synchronize()
    if model.device.type != "cuda":
        fail(f"VideoTGB without a device built on {model.device}")
    llm, vit = cfg.instructblip.llm, cfg.vit
    n_params = sum(p.numel() for p in model.parameters())
    n_llm = sum(p.numel() for p in model.model.language_model.parameters())
    log(f"  InstructBLIP-Vicuna-7B built on the card: {n_params / 1e9:.3f}B "
        f"params ({n_llm / 1e9:.3f}B in the LLM), "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, in "
        f"{time.perf_counter() - t0:.2f} s; random weights from seed 0")

    b, n_flow, img = 4, 5, vit.image_size
    max_new = 128
    frames_u8, flow_u8, batch = vicuna_requests(cfg, dev)
    dcfg = DecodeConfig(max_new_tokens=max_new,
                        eos_token_id=llm.eos_token_id,
                        pad_token_id=llm.pad_token_id)
    sel_gen = torch.Generator(device=dev)
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=dev)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=dev)
    times = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return out

    def drive():
        snaps = {}
        sel_gen.manual_seed(7)
        cand = run("select_phase_blip2 (multi_modal, ratio)",
                   lambda: V.select_phase_blip2(
                       model, flow_u8, batch, generator=sel_gen,
                       mode="multi_modal", rescale="ratio"))
        snaps["select"] = dict(kernels.LAUNCHES)
        sel = frames_u8[torch.arange(b, device=dev)[:, None], cand]
        tokens = run("answer_phase_instructblip (128 new tokens)",
                     lambda: V.answer_phase_instructblip(model, sel, batch,
                                                         dcfg))
        snaps["answer"] = dict(kernels.LAUNCHES)
        flow = model.flow_features(flow_u8.float())
        full = dict(batch, flow=flow,
                    frames=(frames_u8.float() / 255.0 - mean) / std)
        sel_gen.manual_seed(7)
        tokens_g, cand_g = run("generate_instructblip (128 new tokens)",
                               lambda: V.generate_instructblip(
                                   model, full, dcfg, generator=sel_gen))
        snaps["end"] = dict(kernels.LAUNCHES)
        return cand, sel, tokens, tokens_g, cand_g, snaps

    drive()  # cold: plans, lazy loading, the allocator's first blocks
    kernels.reset_launches()
    cand, sel, tokens, tokens_g, cand_g, snaps = drive()
    end = snaps["end"]
    for name, toks in (("two-phase", tokens), ("generate_instructblip",
                                               tokens_g)):
        if tuple(toks.shape) != (b, max_new) or int(toks.min()) < 0 or \
                int(toks.max()) >= llm.vocab_size:
            fail(f"Vicuna {name}: tokens {tuple(toks.shape)} outside "
                 "(B, 128) or the vocabulary")
    if tuple(cand.shape) != (b, cfg.nframe) or int(cand.min()) < 0 or \
            int(cand.max()) >= cfg.num_frames:
        fail(f"Vicuna cand_index {tuple(cand.shape)} out of range")
    check_bodies("the Vicuna serving run", end)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    prefill = llm.num_layers  # 96 x (96 + 128) > 128^2
    per_phase = {
        "select_phase_blip2 (multi_modal, ratio)": dict(snaps["select"]),
        "answer_phase_instructblip": {
            k: snaps["answer"][k] - snaps["select"][k] for k in end},
        "flow_features + generate_instructblip": {
            k: end[k] - snaps["answer"][k] for k in end}}
    expected = {
        "select_phase_blip2 (multi_modal, ratio)": {
            **zero, "corr_lookup": cfg.raft.iters, "select_frames": 1},
        "answer_phase_instructblip": {
            **zero, "flash_fwd": vit.num_layers + prefill},
        "flow_features + generate_instructblip": {
            **zero, "corr_lookup": cfg.raft.iters, "select_frames": 1,
            "flash_fwd": vit.num_layers + prefill}}
    for phase, want in expected.items():
        log(f"  launches in {phase}: {per_phase[phase]} (expected {want})")
        if per_phase[phase] != want:
            fail(f"Vicuna launch counts of {phase}: {per_phase[phase]} != "
                 f"{want}")
    if not torch.equal(cand_g, cand) or not torch.equal(tokens_g, tokens):
        fail("generate_instructblip and the two phases gave other frames or "
             "tokens from equally seeded generators")
    eos = (tokens == llm.eos_token_id).any(dim=1).tolist()
    log(f"  generate_instructblip equals the two phases: frames "
        f"{cand.tolist()}, all {b} x {max_new} greedy tokens (rows ending in "
        f"eos: {eos})")
    for name, ms in times.items():
        log(f"  wall {name}: {ms:.2f} ms warm on {card}")

    # where the time goes, warm: select, ViT-g + Q-Former, the prefill, one
    # decode step
    parts = {}

    def part(name, fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t) * 1e3 / reps
        return out

    ib = model.model
    with torch.no_grad():
        part("select (RAFT + TGB multi_modal + kernel D)",
             lambda: V.select_phase_blip2(model, flow_u8, batch,
                                          generator=sel_gen,
                                          mode="multi_modal",
                                          rescale="ratio"))
        visual = part("ViT-g + Q-Former + projection (16 images)",
                      lambda: V._encode_selected_u8(model, sel, batch))
        embeds, emask = ib.decoder_inputs(visual, batch["question_ids"],
                                          batch["question_mask"])
        s = embeds.shape[1]
        pos = (emask.cumsum(dim=1).long() - 1).clamp(min=0)
        valid = torch.cat([emask, torch.zeros((b, max_new), device=dev)], 1)
        caches = model.init_llama_caches(b, s + max_new)
        kernels.reset_launches()
        part("LLaMA prefill (4 x 96 into 224 slots)", lambda: model.llama_step(
            inputs_embeds=embeds, positions=pos, caches=caches,
            cache_index=0, cache_positions_valid=valid), reps=1)
        if kernels.LAUNCHES["flash_fwd"] != 2 * prefill:
            fail(f"the prefill launched {kernels.LAUNCHES['flash_fwd']} "
                 f"flash_fwd in 2 calls, not {2 * prefill}")
        valid[:, s] = 1.0
        tok = tokens[:, :1]
        step_pos = batch["question_mask"].sum(1).long()[:, None] + 32
        part("LLaMA decode step (1 token, 225 slots)", lambda: model.llama_step(
            tokens=tok, positions=step_pos, caches=caches, cache_index=s,
            cache_positions_valid=valid), reps=16)
    for name, ms in parts.items():
        log(f"  component {name}: {ms:.2f} ms on {card}")
    with torch.no_grad():
        device_breakdown("Vicuna decode step (1 token, 225 slots)",
                         lambda: model.llama_step(
                             tokens=tok, positions=step_pos, caches=caches,
                             cache_index=s, cache_positions_valid=valid),
                         card)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory {peak_gib:.2f} GiB on {card}")
    log("  the Vicuna rows are random-weight runs (seed 0): no released "
        "Vicuna / InstructBLIP weights are in the repository")
    del model, caches
    return dict(end)


# ---------------------------------------------------------- serving engine
def serving_engine(card: str, backbone: str = "blip2",
                   arrivals: int = 8) -> dict:
    """Phases 13 and 14: the port's ``ServingEngine`` of ``backbone`` at
    flagship width (bf16 residency, batch 4, 4 flow pairs, 16 new tokens),
    fed through ``submit`` with random uint8 frames from a seed: a warm-up
    request, 4 requests one at a time, a burst of 8 (two identical pairs
    among them) and ``arrivals`` Poisson arrivals at 4 req/s. Its two
    workers launch kernels B and D (select) and A (answer) from two threads
    on two streams. Every future must resolve; the launch counts over the
    engine's run must be the batches times (B 20 on the tile body, D 1, A
    39 on the tensor-core body); then every batch is run again by direct
    ``select_phase_blip2`` + gather + answer-phase calls (the engine's
    pair for the backbone) on the same padded batch with the generator of
    its step, and its indices and tokens must be equal bit for bit
    (identical requests agree where their rows' noise picks the same
    frames). Returns the engine's launches per kernel."""
    import statistics

    import numpy as np
    import torch

    from videotgb_torch import serve
    from videotgb_torch.device import step_generator
    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = serve.ServingEngine(
        "random:flagship", preset="flagship", batch_size=4, flow_frames=4,
        max_new_tokens=16, max_delay_ms=30, backbone=backbone)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"  engine built on the card: {n_params / 1e6:.1f}M params in "
        f"{time.perf_counter() - t0:.2f} s (select and answer workers on "
        f"their own CUDA streams)")

    # the engine's batches as its workers see them: padded requests, step,
    # generator state, indices and tokens, and host-clock intervals of each
    # phase up to its stream's completion
    rec = {"padded": [], "steps": [], "select": [], "answer": []}
    host_batch, make_gen = engine.host_batch, serve.step_generator
    answer_name = ("answer_phase_instructblip" if engine.decoder_only
                   else "answer_phase_blip2")
    select, answer = serve.select_phase_blip2, getattr(serve, answer_name)

    def rec_batch(padded):
        rec["padded"].append(list(padded))
        return host_batch(padded)

    def rec_gen(seed, step, device):
        rec["steps"].append(step)
        return make_gen(seed, step, device)

    def rec_select(model, flow_u8, bd, generator=None, **kw):
        state = generator.get_state()
        t = time.perf_counter()
        cand = select(model, flow_u8, bd, generator=generator, **kw)
        torch.cuda.current_stream().synchronize()
        rec["select"].append({"t": (t, time.perf_counter()), "state": state,
                              "cand": cand.cpu()})
        return cand

    def rec_answer(model, frames, bd, dcfg, generator=None):
        t = time.perf_counter()
        tokens = answer(model, frames, bd, dcfg, generator=generator)
        torch.cuda.current_stream().synchronize()
        rec["answer"].append({"t": (t, time.perf_counter()),
                              "tokens": tokens.cpu()})
        return tokens

    engine.host_batch = rec_batch
    serve.step_generator, serve.select_phase_blip2 = rec_gen, rec_select
    setattr(serve, answer_name, rec_answer)

    img, fs = cfg.vit.image_size, cfg.tgb.flow_size
    rng = np.random.default_rng(0)

    def request(i):
        frames = rng.integers(0, 256, (cfg.num_frames, img, img, 3),
                              np.uint8)
        flow = rng.integers(0, 256, (engine.flow_frames + 1, fs, fs, 3),
                            np.uint8)
        return frames, flow, f"request {i}: what happens in the video?"

    frames_of, replies, done_at = {}, {}, {}

    def submit(req):
        fut = engine.submit(*req)
        frames_of[fut] = req[0]
        fut.add_done_callback(lambda f: done_at.setdefault(
            f, time.perf_counter()))
        return fut

    def result(fut, what):
        try:
            replies[fut] = fut.result(timeout=300)
        except Exception as e:  # an exception or a timeout fails the run
            fail(f"serving engine: {what} did not resolve: {e!r}")
        return replies[fut]

    def percentiles(lat):
        return {q: float(np.percentile(lat, q)) for q in (50, 90, 99)}

    try:
        kernels.reset_launches()
        result(submit(request(0)), "the warm-up request")
        seq = []
        for i in range(1, 5):  # each awaited: a padded batch of its own
            fut = submit(request(i))
            seq.append(result(fut, f"sequential request {i}"))
        n_seq_batches = len(rec["steps"])
        burst_reqs = [request(10 + i) for i in range(6)]
        burst_reqs.insert(1, burst_reqs[0])  # identical pairs
        burst_reqs.insert(5, burst_reqs[4])
        t_load = time.perf_counter()
        loaded = [submit(r) for r in burst_reqs]
        gaps = np.random.default_rng(1).exponential(1 / 4.0, arrivals)
        for i, gap in enumerate(gaps):
            time.sleep(float(gap))
            loaded.append(submit(request(20 + i)))
        for i, fut in enumerate(loaded):
            result(fut, f"loaded request {i}")
        t_end = time.perf_counter()
        stats = engine.stats()
    finally:
        engine.close()
        engine.host_batch = host_batch
        serve.step_generator, serve.select_phase_blip2 = make_gen, select
        setattr(serve, answer_name, answer)
    if engine._worker.is_alive() or engine._answer_worker.is_alive():
        fail("serving engine: a worker outlived close()")
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    batches = stats["batches"]
    per_batch = {"corr_lookup": cfg.raft.iters, "select_frames": 1,
                 "flash_fwd": cfg.vit.num_layers}
    want = {**dict.fromkeys(kernels.LAUNCHES, 0),
            **{k: v * batches for k, v in per_batch.items()}}
    log(f"  launches over the engine's {batches} batches: {launches} "
        f"(expected {want})")
    if launches != want:
        fail(f"serving engine launch counts: {launches} != {want}")
    check_bodies("the serving engine", launches)
    if not (len(rec["steps"]) == len(rec["padded"]) == len(rec["select"])
            == len(rec["answer"]) == batches):
        fail(f"serving engine: {batches} batches but "
             f"{[len(v) for v in rec.values()]} recorded")

    # every batch again, single-threaded on the default stream
    model, dev = engine.model, engine.device
    agree = pairs = 0
    direct = {"select": [], "answer": []}
    for k, (step, padded) in enumerate(zip(rec["steps"], rec["padded"])):
        gen = step_generator(engine.seed, step, dev)
        if not torch.equal(gen.get_state(), rec["select"][k]["state"]):
            fail(f"batch {k}: the engine's generator is not step {step}'s")
        flow_u8, bd = engine.host_batch(padded)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cand = V.select_phase_blip2(model, flow_u8, bd, generator=gen,
                                    **engine.select_kw)
        torch.cuda.synchronize()
        direct["select"].append((time.perf_counter() - t) * 1e3)
        if not torch.equal(cand.cpu(), rec["select"][k]["cand"]):
            fail(f"batch {k} (step {step}): frame indices differ from a "
                 "direct select_phase_blip2 call")
        idx = cand.cpu().numpy()
        sel = torch.from_numpy(np.stack([
            frames_of[r.future][idx[i]] for i, r in enumerate(padded)]))
        sel = sel.to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens = getattr(V, answer_name)(model, sel, bd,
                                         engine.decode_config, generator=gen)
        torch.cuda.synchronize()
        direct["answer"].append((time.perf_counter() - t) * 1e3)
        if not torch.equal(tokens.cpu(), rec["answer"][k]["tokens"]):
            fail(f"batch {k} (step {step}): tokens differ from a direct "
                 f"{answer_name} call")
        answers = engine.tok.batch_decode(tokens.cpu().numpy())
        for i, r in enumerate(padded):
            if i and r is padded[i - 1]:
                continue  # a pad row
            reply = replies[r.future]
            if reply.selected_frames != idx[i].tolist() or \
                    reply.answer != answers[i]:
                fail(f"batch {k} row {i}: the reply is not its row's")
        rows = {}
        for i, r in enumerate(padded):
            if i and r is padded[i - 1]:
                continue
            key = (id(frames_of[r.future]), r.question)
            if key in rows:
                pairs += 1
                other = replies[rows[key]]
                same = other.selected_frames == replies[r.future] \
                    .selected_frames
                agree += same
                if same and other.answer != replies[r.future].answer:
                    fail(f"batch {k}: identical requests with the same "
                         "frames got different answers")
            rows[key] = r.future
    log(f"  all {batches} batches equal to direct select + gather + answer "
        f"calls with their steps' generators (indices and tokens bit for "
        f"bit); {pairs} identical pairs shared a batch, {agree} of them "
        f"drew the same frames (each row draws its own Gumbel noise)")

    # latency, throughput, the phases, and select(N+1) against answer(N)
    seq_lat = [r.latency_ms for r in seq]
    loaded_lat = [replies[f].latency_ms for f in loaded]
    sel_t = [x["t"] for x in rec["select"]]
    ans_t = [x["t"] for x in rec["answer"]]

    def overlap(a, b):
        return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))

    loaded_sel = sel_t[n_seq_batches:]
    sel_ms = sum(b - a for a, b in loaded_sel) * 1e3
    over_ms = sum(overlap(s, a) for s in loaded_sel for a in ans_t) * 1e3
    alone = [(b - a) * 1e3 for (a, b) in sel_t[1:n_seq_batches]]
    busy = [(s[1] - s[0]) * 1e3 for s in loaded_sel
            if any(overlap(s, a) > 0 for a in ans_t)]
    ans_alone = [(b - a) * 1e3 for (a, b) in ans_t[1:n_seq_batches]]
    ans_busy = [(a[1] - a[0]) * 1e3 for a in ans_t[n_seq_batches:]
                if any(overlap(s, a) > 0 for s in sel_t)]
    burst_s = max(done_at[f] for f in loaded[:8]) - t_load
    log(f"  one at a time (4 requests, each its own batch): latency_ms "
        f"{seq_lat}; select {alone} ms, answer {ans_alone} ms on {card}")
    log(f"  the same batches called directly, one thread, default stream "
        f"(after the engine closed): select median "
        f"{statistics.median(direct['select']):.2f} ms, answer median "
        f"{statistics.median(direct['answer']):.2f} ms "
        f"(select {[round(x, 2) for x in direct['select']]}, answer "
        f"{[round(x, 2) for x in direct['answer']]}) on {card}")
    log(f"  the burst of 8: served in {burst_s:.3f} s, "
        f"{8 / burst_s:.3f} req/s (one batch at a time, one request after "
        f"another: 4 / (select + answer alone) = "
        f"{4e3 / (statistics.median(alone) + statistics.median(ans_alone)):.3f}"
        f" req/s) on {card}")
    log(f"  loaded (burst of 8 + {arrivals} Poisson arrivals at 4 req/s, "
        f"{batches - n_seq_batches} batches of "
        f"{[len({id(r) for r in p}) for p in rec['padded'][n_seq_batches:]]}"
        f" requests): latency_ms p50 / p90 / p99 {percentiles(loaded_lat)}, "
        f"throughput {len(loaded) / (t_end - t_load):.3f} req/s over "
        f"{t_end - t_load:.3f} s on {card}")
    log(f"  select(N+1) against answer(N) under one interpreter lock: "
        f"{over_ms:.1f} of {sel_ms:.1f} ms of loaded select wall overlapped "
        f"an answer ({over_ms / max(sel_ms, 1e-9):.3f}); select median "
        f"{statistics.median(alone):.2f} ms alone, "
        f"{statistics.median(busy) if busy else float('nan'):.2f} ms "
        f"overlapping; answer median {statistics.median(ans_alone):.2f} ms "
        f"alone, {statistics.median(ans_busy) if ans_busy else float('nan'):.2f}"
        f" ms overlapping a select on {card}")
    log(f"  engine stats(): batches {batches}, served {stats['served']}, "
        f"latency p50 / p90 / p99 {stats.get('p50_ms')} / "
        f"{stats.get('p90_ms')} / {stats.get('p99_ms')} ms (all requests), "
        f"throughput_req_s {stats['throughput_req_s']} (over the uptime), "
        f"phase_ms {json.dumps(stats['phase_ms'])} on {card}")
    log(f"  peak device memory {peak_gib:.2f} GiB on {card}")
    log("  not run on the card: run_inference and submit_video (they decode "
        "video with cv2, which this machine may lack; held on the CPU by "
        "tests/test_torch_evalsuite.py and tests/test_torch_serve.py)")
    del engine, model
    return launches


# ------------------------------------------------- phase 15: the two CLIs
E2E_CLI = ["experiment=smoke_e2e_synthetic", "model.preset=flagship",
           "data.batch_size=8", "data.train_size=32", "data.val_size=8",
           "data.max_flow_len=64", "data.flow_len_range=[8,64]",
           "data.max_txt_len=32", "data.answer_len=32",
           "trainer.max_steps=3", "trainer.eval_every=3",
           "trainer.log_every=1", "model.eval_max_new=16",
           "callbacks.model_checkpoint.save_last=false",
           "extras.print_config=false"]
TG_CLI = ["experiment=smoke_tg_synthetic", "model.preset=flagship",
          "data.batch_size=32", "data.train_size=64", "data.val_size=32",
          "data.max_flow_len=64", "data.flow_len_range=[8,64]",
          "trainer.max_steps=2", "trainer.eval_every=2",
          "callbacks.model_checkpoint.save_last=false",
          "extras.print_config=false"]


class CliProbe:
    """Wrappers around the pieces the CLIs call, installed for phase 15
    only: the train loader's ``next`` (the data wait), ``Trainer.train_step``
    (synchronised wall, launches and bodies), ``evaluate_tg`` /
    ``evaluate_generative`` (wall, batches, launches), checkpoint saves and
    restores (walls, bytes), ``build_model`` (the model; with ``frozen``, a
    host copy of the parameters that ``frozen`` says are frozen, and with
    ``moving`` one of those it names), ``Trainer.fit`` (its trainer and
    final state); for phase 16 also the SF pseudo-label pass
    (``train.sf_pseudo_scores``: wall, launches, scores and the span
    targets they give), kernel C's wrapper (the shape of each call, whether
    it wrote ds, its passes) and the optimizer step (the memory it adds);
    for phase 17 the stage-3 dataset's row reads (a row that fails, which
    the dataset would replace by another). A step's data wait sums the
    waits of its loader batches (``accumulate_grad_batches`` of them).
    The wrappers only read; every kernel launch stays the CLI's."""

    def __init__(self):
        self.frozen = self.moving = None
        self.snapshot_device = None  # None: frozen snapshots on the host
        # a save made but not written, recorded with 0 bytes: the 40.9 GB
        # SF and 33.7 GB Vicuna IV saves give their time to phase 21
        self.skip_saves = False
        # a save made, counted and held in host memory, not written (phase
        # 15's four 18.1 GB saves give their time to phase 22): each file
        # is an empty placeholder, and a restore reads the held copy
        self.hold_saves = False
        self.held = {}  # (root, step, item file) -> the host copy
        self.clear()
        self._undo = []

    def clear(self):
        self.waits, self.val_waits, self.steps, self.evals = [], [], [], []
        self.saves, self.restores, self.models, self.fits = [], [], [], []
        self.pseudo, self.bwd, self.opt, self.row_faults = [], [], [], []
        self.snapshot = self.moving_snapshot = None
        self.peak = 0
        self.step_peak = (0, 0)  # allocated, reserved
        self.waits_seen = 0
        self.keep_args = False

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        import torch

        from videotgb_torch import train as T
        from videotgb_torch.data.datasets import IVInstructDataset
        from videotgb_torch.data.loader import PrefetchLoader
        from videotgb_torch.ops import attention, kernels
        from videotgb_torch.ops.attention import flash_bwd_passes
        from videotgb_torch.ops.span import (largest_rectangle_span,
                                             rescale_index)
        from videotgb_torch.training import checkpoint as CK
        from videotgb_torch.training import trainer as TR
        from videotgb_torch.training.trainer import Trainer

        probe = self

        def counts():
            torch.cuda.synchronize()
            return dict(kernels.LAUNCHES), dict(kernels.MMA_LAUNCHES)

        def diff(after, before):
            return {k: after[k] - before[k] for k in after}

        def loader_iter(orig):
            def timed(loader):
                it = orig(loader)
                try:
                    while True:
                        t = time.perf_counter()
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                        # the train loader shuffles, the val loader does not
                        (probe.waits if loader.shuffle else
                         probe.val_waits).append((t, time.perf_counter()))
                        yield item
                finally:
                    it.close()
            return timed

        def train_step(orig):
            def timed(trainer, state, batch):
                before, mma = counts()
                probe.peak = max(probe.peak, torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                probe.step_peak = (0, 0)
                t = time.perf_counter()
                state, metrics = orig(trainer, state, batch)
                host = {k: float(v) for k, v in metrics.items()}
                after, mma_after = counts()
                end = time.perf_counter()
                # the step's peak, allocated and reserved: the first step of
                # a batch signature runs eagerly, the second captures its
                # CUDA graph, whose pool stays reserved
                alloc = max(torch.cuda.max_memory_allocated(),
                            probe.step_peak[0])
                reserved = max(torch.cuda.max_memory_reserved(),
                               probe.step_peak[1])
                # the loader batches of this step (several when it
                # accumulates micro-batches)
                mine = probe.waits[probe.waits_seen:] or [(t, t)]
                probe.waits_seen = len(probe.waits)
                widths = batch.get("widths")
                probe.steps.append({
                    "step": state.step, "metrics": host,
                    "step_ms": (end - t) * 1e3,
                    "wait_ms": sum(g - r for r, g in mine) * 1e3,
                    "wall_ms": (end - mine[0][0]) * 1e3,
                    "widths": None if widths is None else widths.tolist(),
                    "launches": diff(after, before),
                    "mma": diff(mma_after, mma),
                    "peak_alloc": alloc, "peak_reserved": reserved})
                return state, metrics
            return timed

        def evaluate(orig):
            def timed(model, recipe, loader, *args, **kwargs):
                before, mma = counts()
                first = len(probe.val_waits)
                t = time.perf_counter()
                out = orig(model, recipe, loader, *args, **kwargs)
                after, mma_after = counts()
                probe.evals.append({
                    "ms": (time.perf_counter() - t) * 1e3,
                    "wait_ms": sum(b - a for a, b in probe.val_waits[first:])
                    * 1e3,
                    "batches": len(loader), "metrics": out,
                    "launches": diff(after, before),
                    "mma": diff(mma_after, mma)})
                return out
            return timed

        def save(orig):
            def timed(mgr, step, state, metrics=None):
                if probe.skip_saves:
                    probe.saves.append({"step": step, "bytes": 0, "s": 0.0,
                                        "skipped": True})
                    return
                written, real = [], torch.save

                def counting(obj, path, *args, **kwargs):
                    real(obj, path, *args, **kwargs)
                    written.append(os.path.getsize(path))

                def holding(obj, path, *args, **kwargs):
                    copy, nbytes = held_copy(obj)
                    probe.held[held_key(path)] = (copy, nbytes)
                    open(path, "wb").close()
                    written.append(nbytes)

                torch.cuda.synchronize()
                torch.save = holding if probe.hold_saves else counting
                t = time.perf_counter()
                try:
                    orig(mgr, step, state, metrics)
                finally:
                    torch.save = real
                probe.saves.append({"step": step, "bytes": sum(written),
                                    "s": time.perf_counter() - t,
                                    "held": probe.hold_saves})
                for key in [k for k in probe.held if not any(
                        os.path.exists(os.path.join(k[0], pool, k[1], k[2]))
                        for pool in ("best", "last"))]:
                    del probe.held[key]  # a step the manager dropped
            return timed

        def load(orig):
            def held_or_read(path, *args, **kwargs):
                got = probe.held.get(held_key(path))
                return orig(path, *args, **kwargs) if got is None else got[0]
            return held_or_read

        def restore(orig):
            def timed(mgr, step=None, items=None):
                t = time.perf_counter()
                out = orig(mgr, step, items)
                step = step if step is not None else mgr.latest_step()
                d = mgr.step_dir(step)
                sizes = [probe.held.get(held_key(os.path.join(d, n + ".pt")),
                                        (None, None))[1]
                         for n in out]
                probe.restores.append({
                    "step": step, "items": sorted(out),
                    "bytes": sum(size if size is not None else
                                 os.path.getsize(os.path.join(d, n + ".pt"))
                                 for n, size in zip(out, sizes)),
                    "held": any(size is not None for size in sizes),
                    "s": time.perf_counter() - t})
                return out
            return timed

        def restore_into(orig):
            def timed(restored, model, optimizer=None):
                t = time.perf_counter()
                out = orig(restored, model, optimizer)
                torch.cuda.synchronize()
                probe.restores[-1]["s"] += time.perf_counter() - t
                return out
            return timed

        def build_model(orig):
            def capture(model_cfg, device=None, seed=0):
                model, mcfg = orig(model_cfg, device=device, seed=seed)
                probe.models.append(model)
                if probe.frozen is not None and probe.snapshot is None:
                    t = time.perf_counter()
                    dev = probe.snapshot_device or "cpu"
                    probe.snapshot = {
                        n: p.detach().to(dev, copy=True)
                        for n, p in model.named_parameters()
                        if probe.frozen(n)}
                    log(f"  {len(probe.snapshot)} frozen parameters copied to "
                        f"{dev} in {time.perf_counter() - t:.2f} s")
                if probe.moving is not None and probe.moving_snapshot is None:
                    probe.moving_snapshot = {
                        n: p.detach().to("cpu", copy=True)
                        for n, p in model.named_parameters()
                        if probe.moving(n)}
                return model, mcfg
            return capture

        def pseudo(orig):
            def timed(model, db, answers, tok, max_new_tokens=16):
                before, mma = counts()
                t = time.perf_counter()
                scores = orig(model, db, answers, tok,
                              max_new_tokens=max_new_tokens)
                after, mma_after = counts()
                starts, ends = largest_rectangle_span(scores)
                lengths = db["video_length"].cpu()
                probe.pseudo.append({
                    "ms": (time.perf_counter() - t) * 1e3, "scores": scores,
                    "starts": rescale_index(starts, scores.shape[1], lengths),
                    "ends": rescale_index(ends, scores.shape[1], lengths),
                    "lengths": lengths, "launches": diff(after, before),
                    "mma": diff(mma_after, mma)})
                return scores
            return timed

        def flash_bwd(orig):
            def record(q, k, v, bias, g, scale, bias_needs_grad=True):
                out = orig(q, k, v, bias, g, scale, bias_needs_grad)
                probe.bwd.append({
                    "shape": (*q.shape, k.shape[2]),
                    "ds": bias is not None and bias_needs_grad,
                    "passes": flash_bwd_passes(q.shape[2], k.shape[2],
                                               q.shape[3])})
                if probe.keep_args:
                    probe.bwd[-1]["args"] = (q, k, v, bias, g, scale,
                                             bias_needs_grad)
                    probe.bwd[-1]["dbias"] = out[3]
                return out
            return record

        def opt_step(orig):
            def measured(optimizer, lr, max_grad_norm):
                if torch.cuda.is_current_stream_capturing():
                    # inside a step's CUDA-graph capture: nothing runs, and
                    # a synchronisation would break the capture
                    return orig(optimizer, lr, max_grad_norm)
                torch.cuda.synchronize()
                probe.peak = max(probe.peak, torch.cuda.max_memory_allocated())
                probe.step_peak = (
                    max(probe.step_peak[0], torch.cuda.max_memory_allocated()),
                    max(probe.step_peak[1], torch.cuda.max_memory_reserved()))
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = orig(optimizer, lr, max_grad_norm)
                torch.cuda.synchronize()
                top = torch.cuda.max_memory_allocated()
                probe.opt.append({"held": held, "add": top - held})
                return out
            return measured

        def row_get(orig):
            def recorded(dataset, index):
                try:
                    return orig(dataset, index)
                except Exception as e:
                    probe.row_faults.append((index, repr(e)))
                    raise
            return recorded

        def fit(orig):
            def capture(trainer, state, *args, **kwargs):
                state = orig(trainer, state, *args, **kwargs)
                probe.fits.append((trainer, state))
                return state
            return capture

        self._patch(PrefetchLoader, "__iter__", loader_iter)
        self._patch(Trainer, "train_step", train_step)
        self._patch(Trainer, "fit", fit)
        self._patch(T, "evaluate_tg", evaluate)
        self._patch(T, "evaluate_generative", evaluate)
        self._patch(T, "build_model", build_model)
        self._patch(CK.CheckpointManager, "save", save)
        self._patch(CK.CheckpointManager, "restore", restore)
        self._patch(torch, "load", load)
        self._patch(CK, "restore_into", restore_into)
        self._patch(T, "sf_pseudo_scores", pseudo)
        self._patch(attention, "flash_backward_cuda", flash_bwd)
        self._patch(TR, "optimizer_step", opt_step)
        self._patch(IVInstructDataset, "_get", row_get)

    def remove(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()
        self.held.clear()


def held_key(path: str) -> tuple:
    """(checkpoint root, step, item file) of a file a ``CheckpointManager``
    writes: ``<root>/<best|last>/<step or .<step>.tmp-<pid>>/<item>.pt``."""
    step_dir, item = os.path.split(os.path.abspath(path))
    pool, name = os.path.split(step_dir)
    step = name[1:].split(".tmp")[0] if name.startswith(".") else name
    return os.path.dirname(pool), step, item


def held_copy(obj):
    """A host copy of a checkpoint item (tensors copied off the card,
    containers rebuilt, other values as they are) and its tensors' bytes."""
    import torch

    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
            return x.detach().to("cpu", copy=True)
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(obj), total


def cli_run(name, probe, drive, step_want, eval_want, card,
            pseudo_want=None) -> dict:
    """One CLI call: every count set to 0 just before, read just after;
    each step's, each eval batch's and each SF pseudo pass's launches (and
    tensor-core bodies) against ``step_want`` / ``eval_want`` /
    ``pseudo_want``, the total against their sum. Prints the walls; returns
    (the CLI's result, the launches)."""
    import torch

    from videotgb_torch.ops import kernels

    probe.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t = time.perf_counter()
    result = drive()
    wall = time.perf_counter() - t
    got = dict(kernels.LAUNCHES)
    peak_gib = max(probe.peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    zero = dict.fromkeys(got, 0)
    step_want = {**zero, **step_want}
    eval_want = {**zero, **eval_want}
    pseudo_want = {**zero, **(pseudo_want or {})}
    mma_names = ("flash_fwd", "flash_bwd", "flash_bshd")
    for what, runs, want, per in (("step", probe.steps, step_want, 1),
                                  ("eval", probe.evals, eval_want, None),
                                  ("pseudo pass", probe.pseudo, pseudo_want,
                                   1)):
        for i, r in enumerate(runs):
            n = per or r["batches"]
            expect = {k: v * n for k, v in want.items()}
            if r["launches"] != expect:
                fail(f"{name} {what} {i + 1}: launches {r['launches']} != "
                     f"{expect}")
            mma = {k: r["mma"][k] for k in mma_names}
            if mma != {k: expect[k] for k in mma_names}:
                fail(f"{name} {what} {i + 1}: tensor-core launches {mma} != "
                     f"{ {k: expect[k] for k in mma_names} }")
    total = {k: len(probe.steps) * step_want[k]
             + sum(r["batches"] for r in probe.evals) * eval_want[k]
             + len(probe.pseudo) * pseudo_want[k]
             for k in got}
    def nz(d):
        return {k: v for k, v in d.items() if v}

    log(f"  {name} launches: {nz(got)} (expected {nz(total)}: "
        f"{len(probe.steps)} steps x {nz(step_want)} + "
        f"{sum(r['batches'] for r in probe.evals)} eval batches x "
        f"{nz(eval_want)}"
        + (f" + {len(probe.pseudo)} pseudo passes x {nz(pseudo_want)}"
           if probe.pseudo else "") + "; every other kernel 0)")
    if got != total:
        fail(f"{name} launch counts: {got} != {total}")
    check_bodies(name, got)
    for r in probe.steps:
        m = r["metrics"]
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"{name} step {r['step']}: non-finite metrics {m}")
        log(f"  {name} step {r['step']}: wall {r['wall_ms']:.2f} ms = data "
            f"wait {r['wait_ms']:.2f} + upload and train_step; train_step "
            f"{r['step_ms']:.2f} ms; loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, lr {m['lr']:.6g}; peak device memory "
            f"{r['peak_alloc'] / 2 ** 30:.2f} GiB allocated, "
            f"{r['peak_reserved'] / 2 ** 30:.2f} GiB reserved on {card}")
    if len(probe.steps) >= 2:
        eager, graphed = probe.steps[:2]
        log(f"  {name} peak memory, eager (step {eager['step']}) against "
            f"graphed (step {graphed['step']}, the capture): allocated "
            f"{eager['peak_alloc'] / 2 ** 30:.2f} / "
            f"{graphed['peak_alloc'] / 2 ** 30:.2f} GiB, reserved "
            f"{eager['peak_reserved'] / 2 ** 30:.2f} / "
            f"{graphed['peak_reserved'] / 2 ** 30:.2f} GiB on {card}")
    for r in probe.evals:
        log(f"  {name} eval: {r['ms']:.2f} ms over {r['batches']} batch(es) "
            f"({r['wait_ms']:.2f} of them waiting for data), "
            f"{(r['ms'] - r['wait_ms']) / max(r['batches'], 1):.2f} ms a batch "
            f"without the wait; {r['metrics']} on {card}")
    for r in probe.saves:
        log(f"  {name} save of step {r['step']}: {r['bytes'] / 1e9:.3f} GB "
            f"in {r['s']:.2f} s"
            + (" (held in host memory, not written: the tensors' bytes)"
               if r.get("held") and r["bytes"] else
               f" ({r['bytes'] / 1e9 / r['s']:.2f} GB/s)" if r["bytes"]
               else " (not written: the phase skips this save)"
               if r.get("skipped") else
               " (nothing written: not above the newest kept step)"))
    for r in probe.restores:
        log(f"  {name} restore of step {r['step']} {r['items']}: "
            f"{r['bytes'] / 1e9:.3f} GB in {r['s']:.2f} s ("
            + ("the held copy" if r.get("held") else "open")
            + " + load into the live model)")
    log(f"  {name}: {wall:.2f} s for the call; peak device memory "
        f"{peak_gib:.2f} GiB on {card}")
    return result, got


def read_csv(path) -> list[dict]:
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def best_steps(ckpt_dir) -> list[str]:
    return sorted(os.listdir(os.path.join(ckpt_dir, "best")))


def cli_paths(card: str) -> dict:
    """Phase 15: ``videotgb_torch.train.main`` and
    ``videotgb_torch.evaluate.main`` as a user calls them, at flagship
    width on the card; returns the launches of the counted CLI runs."""
    import shutil

    import torch

    from videotgb_torch import evaluate as EV
    from videotgb_torch import train as T
    from videotgb_torch.config import compose
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.models.videotgb import VideoTGBConfig
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, restore_into, train_state_items)
    from videotgb_torch.training.optim import cosine_warmup_schedule
    from videotgb_torch.training.trainer import Trainer

    root = os.path.join(HERE, "build", "phase15")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    mcfg = VideoTGBConfig.flagship()
    vit, enc = mcfg.blip2.vit.num_layers, mcfg.blip2.t5.num_encoder_layers
    e2e_step = {"flash_fwd": vit + enc, "flash_bwd": enc}
    # the eval loss (the step's forward) + generate_blip2's ViT-g and one
    # selection; its mean-pooled 64-token T5 encoder goes plain
    e2e_eval = {"flash_fwd": 2 * vit + enc, "select_frames": 1}
    probe = CliProbe()
    probe.hold_saves = True  # made and counted, not written: phase 22's time
    probe.install()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    try:
        # ---- E2E: train 3 steps, eval at step 3, save to best/
        out = os.path.join(root, "e2e")
        ckpt_dir = os.path.join(out, "checkpoints")
        args = E2E_CLI + [f"paths.output_dir={out}"]
        recipe = T.build_recipe(compose(T.CONFIG_DIR, "train", args).model)
        probe.frozen = lambda n: not recipe.filter_fn(n)
        final, got = cli_run("E2E train.main", probe,
                             lambda: T.main(args), e2e_step, e2e_eval, card)
        add(got)
        probe.frozen = None
        if len(probe.steps) != 3:
            fail(f"E2E: {len(probe.steps)} steps, not 3")
        trainer, state = probe.fits[-1]
        changed = [n for n, p in probe.snapshot.items()
                   if not torch.equal(
                       dict(state.model.named_parameters())[n].detach().cpu(),
                       p)]
        if changed:
            fail(f"E2E: frozen parameters changed: {changed[:5]}")
        log(f"  E2E: all {len(probe.snapshot)} frozen parameters "
            f"bit-identical after fit")
        rows = read_csv(os.path.join(out, "csv", "metrics.csv"))
        train_rows = [r for r in rows if r.get("loss")]
        if [int(r["step"]) for r in train_rows] != [1, 2, 3]:
            fail(f"E2E metrics.csv: train rows at steps "
                 f"{[r['step'] for r in train_rows]}, not 1-3")
        if not all(math.isfinite(float(r["loss"])) for r in train_rows):
            fail("E2E metrics.csv: non-finite loss")
        for key in ("val/loss", "val/score"):
            if key not in final or not math.isfinite(final[key]):
                fail(f"E2E: {key} missing or non-finite in {final}")
        if best_steps(ckpt_dir) != ["3"]:
            fail(f"E2E: best/ holds {best_steps(ckpt_dir)}, not one step 3")
        del trainer, state
        probe.clear()

        # ---- resume: ckpt_path, max_steps 4 -> exactly one more step
        args_r = args + [f"ckpt_path={ckpt_dir}", "trainer.max_steps=4"]
        _, got = cli_run("E2E resume", probe, lambda: T.main(args_r),
                         e2e_step, e2e_eval, card)
        add(got)
        new = read_csv(os.path.join(out, "csv", "metrics.csv"))[len(rows):]
        if [int(r["step"]) for r in new] != [4] or len(probe.steps) != 1:
            fail(f"E2E resume: metrics.csv gained rows at steps "
                 f"{[r['step'] for r in new]}, not one row at step 4")
        lr_want = cosine_warmup_schedule(5e-5, 4, 0.05)(3)
        if float(new[0]["lr"]) != lr_want:
            fail(f"E2E resume: lr {new[0]['lr']} at step 4, the schedule "
                 f"gives {lr_want} at step index 3")
        trainer, state = probe.fits[-1]
        opt_steps = {float(s["step"]) for s in state.optimizer.state.values()}
        if state.step != 4 or opt_steps != {4.0}:
            fail(f"E2E resume: step {state.step}, optimizer step counts "
                 f"{opt_steps}, not 4")
        if len(probe.restores) != 1 or probe.restores[0]["items"] != [
                "opt_state", "params", "step"]:
            fail(f"E2E resume: restores {probe.restores}")
        log(f"  E2E resume: one step (4), lr {lr_want:.6g} = the schedule "
            f"at step index 3, optimizer step count 4; best/ holds "
            f"{best_steps(ckpt_dir)}")
        if len(best_steps(ckpt_dir)) != 1:
            fail(f"E2E resume: best/ holds {best_steps(ckpt_dir)}")

        # ---- library round trip at flagship: save the live state, step,
        # rebuild, restore, the same step on the same batch
        tcfg = dataclasses.replace(trainer.config, max_steps=8)
        cfg = compose(T.CONFIG_DIR, "train", args)
        _, val_loader, _ = T.build_data(cfg, mcfg)
        dev = state.model.device
        batch = device_batch(next(iter(val_loader)), dev)
        lib = CheckpointManager(CheckpointConfig(
            directory=os.path.join(root, "lib")))
        probe.clear()
        lib.save(state.step, train_state_items(state))
        ta = Trainer(tcfg, recipe.loss_fn, recipe.filter_fn)
        _, m_a = ta.train_step(state, batch)
        names = trainer.trainable
        params = dict(state.model.named_parameters())
        want_p = {n: params[n].detach().cpu() for n in names}
        want_m = {(n, k): state.optimizer.state[params[n]][k].detach().cpu()
                  for n in names for k in ("exp_avg", "exp_avg_sq", "step")}
        want = (m_a["loss"].cpu(), m_a["grad_norm"].cpu())
        del trainer, state, ta, params, m_a
        probe.models.clear()
        probe.fits.clear()
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        model, _ = T.build_model(cfg.model, device=dev, seed=cfg.seed + 1)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        tb = Trainer(tcfg, recipe.loss_fn, recipe.filter_fn)
        sb = tb.init_state(model)
        sb.step = restore_into(lib.restore(), model, sb.optimizer)
        _, m_b = tb.train_step(sb, batch)
        params = dict(model.named_parameters())
        bad = [n for n in names if not torch.equal(
            params[n].detach().cpu(), want_p[n])]
        bad += [f"{n}:{k}" for (n, k), v in want_m.items() if not torch.equal(
            sb.optimizer.state[params[n]][k].detach().cpu(), v)]
        if not (torch.equal(m_b["loss"].cpu(), want[0])
                and torch.equal(m_b["grad_norm"].cpu(), want[1])):
            bad.append(f"loss/grad_norm {float(m_b['loss'])}, "
                       f"{float(m_b['grad_norm'])} != {float(want[0])}, "
                       f"{float(want[1])}")
        if bad:
            fail(f"library round trip: not bit-identical after restore: "
                 f"{bad[:6]} ({len(bad)} differ)")
        log(f"  library round trip (save at step 4, one step, a fresh "
            f"model built in {build_s:.2f} s from another seed, full restore, "
            f"the same step on the same batch): loss {float(want[0]):.6f}, "
            f"grad_norm {float(want[1]):.6f}, {len(names)} trainable "
            f"parameters and their Adam moments bit-identical")
        for r in probe.saves:
            log(f"  library save: {r['bytes'] / 1e9:.3f} GB in {r['s']:.2f} s"
                + (" (held in host memory, not written)" if r["held"] else
                   f" ({r['bytes'] / 1e9 / r['s']:.2f} GB/s)"))
        for r in probe.restores:
            log(f"  library restore: {r['bytes'] / 1e9:.3f} GB in "
                f"{r['s']:.2f} s (the manager's restore alone)")
        del model, tb, sb, params, want_p, want_m, batch, m_b
        shutil.rmtree(os.path.join(root, "lib"))

        # ---- evaluate.main on the resumed run's checkpoint
        metrics, got = cli_run(
            "E2E evaluate.main", probe,
            lambda: EV.main(args + [f"ckpt_path={ckpt_dir}"]), {}, e2e_eval,
            card)
        add(got)
        for key in ("test/loss", "test/score"):
            if key not in metrics or not math.isfinite(metrics[key]):
                fail(f"evaluate: {key} missing or non-finite in {metrics}")
        shutil.rmtree(out)

        # ---- TG: 2 steps, eval at step 2; no kernel on this path
        out = os.path.join(root, "tg")
        final, got = cli_run(
            "TG train.main", probe,
            lambda: T.main(TG_CLI + [f"paths.output_dir={out}"]), {}, {}, card)
        add(got)
        if len(probe.steps) != 2 or "val/iou_score" not in final:
            fail(f"TG: {len(probe.steps)} steps, final metrics {final}")
        if len(best_steps(os.path.join(out, "checkpoints"))) != 1:
            fail("TG: best/ does not hold one step")
        shutil.rmtree(out)
    finally:
        probe.remove()
        probe.clear()
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------- phase 16: SF and the InstructBLIP training paths
SF_SHAPES = ["data.batch_size=2", "data.max_flow_len=64",
             "data.flow_len_range=[8,64]", "data.max_txt_len=128",
             "data.answer_len=32", "extras.print_config=false"]
SF_CLI = ["experiment=smoke_sf_synthetic", "model.preset=flagship",
          "data.train_size=4", "data.val_size=2", "model.pseudo_max_new=32",
          "model.eval_max_new=16", "trainer.max_steps=2",
          "trainer.eval_every=10", "trainer.log_every=1",
          "callbacks.model_checkpoint.save_last=false"] + SF_SHAPES


def flash_on(s_q: int, s_kv: int) -> int:
    """1 where the dispatch rule of ``models/common.py`` sends an attention
    of Sq x Skv to the flash kernels (Sq * Skv > 128^2), else 0."""
    return int(s_q * s_kv > 128 * 128)


def expected_launches(mcfg, kind: str, text_len: int, answer_len: int,
                      packed_len: int = 0) -> dict:
    """Launches of one ``kind`` of run, derived from the config and the
    dispatch rule: "pseudo" (the SF pass over B*F single frames), "sf" (an
    SF step; everything but the ViT trains, so every flash attention after
    it has a backward), "e2e" (a Vicuna E2E step; the LLaMA frozen but on
    the gradient's way to the Q-Former), "eval" (an SF eval batch,
    ``generate_blip2``). The ViT-g and the Q-Former (self-attention over
    its queries and, instruction-aware, the instruction; cross-attention
    into the image tokens) run in every kind; the T5 encoder over [visual |
    question], its decoder's self- and cross-attention over the answer in
    a step (one token a step when generating: never flash); the LLaMA over
    [visual | packed prompt and answer]."""
    vit = mcfg.vit
    n_img = (vit.image_size // vit.patch_size) ** 2 + 1
    qf = (mcfg.blip2 or mcfg.instructblip).qformer
    q = qf.num_query_tokens
    q_self = q + (text_len if mcfg.instruction_aware else 0)
    qformer = (qf.num_layers * flash_on(q_self, q_self)
               + len(range(0, qf.num_layers, qf.cross_attention_frequency))
               * flash_on(q, n_img))
    a = vit.num_layers * flash_on(n_img, n_img) + qformer
    c = 0
    if kind == "e2e":
        llm = mcfg.instructblip.llm
        s = mcfg.nframe * q + packed_len
        a += llm.num_layers * flash_on(s, s)
        c = qformer + llm.num_layers * flash_on(s, s)
        return {"flash_fwd": a, "flash_bwd": c, "select_frames": 1}
    t5 = mcfg.blip2.t5
    frames = mcfg.nframe if kind == "sf" else 1
    enc = frames * q + text_len
    a += t5.num_encoder_layers * flash_on(enc, enc)
    if kind == "sf":
        dec = t5.num_decoder_layers * (flash_on(answer_len, answer_len)
                                       + flash_on(answer_len, enc))
        a += dec
        c = qformer + t5.num_encoder_layers * flash_on(enc, enc) + dec
    out = {"flash_fwd": a}
    if kind in ("sf", "eval"):
        out["select_frames"] = 1
    if c:
        out["flash_bwd"] = c
    return out


def check_bwd_calls(name, calls, s_q, want_calls, want_passes, want_ds):
    """The kernel-C calls of ``s_q`` queries that a run recorded: their
    number, passes each and whether they wrote ds."""
    mine = [c for c in calls if c["shape"][2] == s_q]
    shapes = sorted({c["shape"] for c in mine})
    log(f"  {name}: {len(mine)} kernel C calls at Sq = {s_q}, shapes "
        f"(B, H, Sq, D, Skv) {shapes}, passes "
        f"{sorted({c['passes'] for c in mine})}, ds written by "
        f"{sum(c['ds'] for c in mine)}")
    if len(mine) != want_calls:
        fail(f"{name}: {len(mine)} kernel C calls at Sq = {s_q}, not "
             f"{want_calls}")
    if any(c["passes"] != want_passes for c in mine):
        fail(f"{name}: a kernel C call at Sq = {s_q} not on {want_passes} "
             f"pass(es)")
    if sum(c["ds"] for c in mine) != (want_calls if want_ds else 0):
        fail(f"{name}: kernel C wrote ds in {sum(c['ds'] for c in mine)} of "
             f"{want_calls} calls (want {'all' if want_ds else 'none'})")
    return shapes


def check_bwd_groups(name, calls, mcfg, steps, text_len, packed_len=0,
                     visual=None, t5_ds=True):
    """Every kernel-C call of ``steps`` backward passes: the Q-Former's
    (instruction-aware: Sq = queries + instruction; no ds), the T5
    encoder's (Sq = ``visual`` tokens, 4 x 32 by default, + question; ds
    where its relative-position bias trains, ``t5_ds``) or the LLaMA's (Sq
    = ``visual`` + the packed text, head dim 128, no ds), each on the
    passes ``flash_bwd_passes`` gives its shape. Returns the shapes by
    group."""
    from videotgb_torch.ops.attention import flash_bwd_passes

    qf = (mcfg.blip2 or mcfg.instructblip).qformer
    q = qf.num_query_tokens
    visual = mcfg.nframe * q if visual is None else visual
    groups = {}
    n = 0
    if mcfg.instruction_aware:
        s_q = q + text_len
        groups["qformer"] = check_bwd_calls(
            f"{name} (Q-Former)", calls, s_q,
            steps * qf.num_layers * flash_on(s_q, s_q),
            flash_bwd_passes(s_q, s_q, qf.hidden_size // qf.num_heads),
            False)
        n += steps * qf.num_layers * flash_on(s_q, s_q)
    if mcfg.backbone == "blip2":
        t5 = mcfg.blip2.t5
        s_q = visual + text_len
        layers = t5.num_encoder_layers
        groups["t5"] = check_bwd_calls(
            f"{name} (T5 encoder)", calls, s_q, steps * layers,
            flash_bwd_passes(s_q, s_q, t5.d_kv), t5_ds)
    else:
        llm = mcfg.instructblip.llm
        s_q = visual + packed_len
        layers = llm.num_layers
        groups["llama"] = check_bwd_calls(
            f"{name} (LLaMA)", calls, s_q, steps * layers,
            flash_bwd_passes(s_q, s_q, llm.head_dim), False)
    n += steps * layers
    if len(calls) != n:
        fail(f"{name}: {len(calls)} kernel C calls, {n} in the groups")
    return groups


def c_at(card, label, b, h, s_q, s_kv, d, bias, need_ds) -> dict:
    """Kernel C at one of phase 16's shapes against its plain version (dq,
    dk, dv and, with ds, the bias's gradient), then timed as device time
    per call beside the plain version and SDPA's backward (its kernels
    summed under the profiler; with ds the mask's gradient too), with the
    bound of this call's bytes and operations."""
    import torch
    import torch.nn.functional as F

    from videotgb_torch.ops.attention import (
        flash_backward_cuda,
        flash_backward_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2) for s in (s_q, s_kv, s_kv, s_q))
    scale = d ** -0.5
    got = flash_backward_cuda(q, k, v, bias, g, scale, need_ds)
    want = flash_backward_reference(q, k, v, bias, g, scale, need_ds)
    err = 0.0
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        if y is not None:
            err = max(err, check_to_largest(
                f"flash_bwd {label} {name}", x, y, 2e-2,
                "ds and the gradients rounded to bf16 (2^-8 of an entry), "
                "sums in another order"))
    ms = graph_ms(lambda: flash_backward_cuda(q, k, v, bias, g, scale,
                                              need_ds))
    plain_ms = graph_ms(lambda: flash_backward_reference(
        q, k, v, bias, g, scale, need_ds), iters=5)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    mask = bias.to(torch.bfloat16).requires_grad_(need_ds)
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         scale=scale)
    wrt = (qs, ks, vs, mask) if need_ds else (qs, ks, vs)
    lib_ms = profiled_ms(lambda: torch.autograd.grad(out, wrt, g,
                                                     retain_graph=True))
    lib_ms = lib_ms if math.isfinite(lib_ms) else None
    elem = q.element_size()
    nbytes = (4 * b * h * s_q * d + 3 * b * h * s_kv * d) * elem \
        + bias.numel() * 4 + (b * h * s_q * s_kv * 4 if need_ds else 0)
    flops = 10 * b * h * s_q * s_kv * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    lib_txt = "not timed" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  flash_bwd {label} ({b},{h},{s_q},{s_kv},{d}), bias "
        f"{tuple(bias.shape)}{' with ds' if need_ds else ''}: device time per "
        f"call {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward {lib_txt}; "
        f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP) on {card}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops), "max_abs_err": err}


def snapshot_changed(model, snap) -> list:
    """Names of the snapshot's tensors that differ from the model's, each
    compared on the snapshot's device."""
    import torch

    params = dict(model.named_parameters())
    return [n for n, p in snap.items()
            if not torch.equal(params[n].detach().to(p.device), p)]


def library_sf_steps(name, card, model, recipe, trainer, db, answers, tok,
                     max_new, pseudo_want, step_want, steps=2) -> dict:
    """``steps`` SF steps as ``train.main`` takes them (the pseudo pass with
    the live parameters, then ``Trainer.train_step``) on one batch; the
    launches of each pass and step counted against the derived ones."""
    import torch

    from videotgb_torch import train as T
    from videotgb_torch.ops import kernels

    state = trainer.init_state(model)
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    for i in range(steps):
        for what, want, run in (
                ("pseudo pass", pseudo_want, lambda: T.sf_pseudo_scores(
                    state.model, db, answers, tok, max_new_tokens=max_new)),
                ("train_step", step_want, lambda: trainer.train_step(
                    state, {**db, "scores": scores}))):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got = dict(kernels.LAUNCHES)
            nz = {k: v for k, v in got.items() if v}
            log(f"  {name} step {i} {what}: {ms:.2f} ms, launches {nz}")
            if got != {**zero, **want}:
                fail(f"{name} step {i} {what}: launches {nz} != {want}")
            check_bodies(f"{name} step {i} {what}", got)
            for k, v in got.items():
                total[k] += v
            if what == "pseudo pass":
                scores = out
                if not bool(((scores >= 0) & (scores <= 1)).all()):
                    fail(f"{name}: scores outside [0, 1]")
            else:
                state, metrics = out
                m = {k: float(v) for k, v in metrics.items()}
                log(f"  {name} step {i}: {m}")
                if not all(math.isfinite(v) for v in m.values()):
                    fail(f"{name} step {i}: non-finite metrics")
    return total, state


def sf_paths(card: str) -> dict:
    """Phase 16: the SF CLI at flagship width (16a), SF with RAFT in the
    step on InstructBLIP-Flan-T5 (16b) and an E2E step on
    InstructBLIP-Vicuna-7B (16c); returns the launches of the counted
    runs."""
    import shutil

    import torch

    from videotgb_torch import train as T
    from videotgb_torch.config import compose
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.models.videotgb import VideoTGBConfig
    from videotgb_torch.ops import attention
    from videotgb_torch.ops.attention import (
        flash_backward_reference,
        make_causal_bias,
        make_padding_bias,
    )
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    text_len, answer_len, max_new, b = 128, 32, 32, 2
    root = os.path.join(HERE, "build", "phase16")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    probe = CliProbe()
    probe.install()
    t16 = time.perf_counter()
    try:
        # ---- 16a: train.main, SF on BLIP2-Flan-T5, 2 steps, 1 eval, 1 save
        mcfg = VideoTGBConfig.flagship()
        pseudo_want = expected_launches(mcfg, "pseudo", text_len, answer_len)
        step_want = expected_launches(mcfg, "sf", text_len, answer_len)
        eval_want = expected_launches(mcfg, "eval", text_len, answer_len)
        log(f"  16a derived launches: pseudo pass {pseudo_want}, step "
            f"{step_want}, eval batch {eval_want} (the reckoning before the "
            f"run: pseudo 39 + 24 A; step 39 + 24 A, 24 C with ds, 1 D)")
        out = os.path.join(root, "sf")
        args = SF_CLI + [f"paths.output_dir={out}"]
        recipe = T.build_recipe(compose(T.CONFIG_DIR, "train", args).model)
        probe.frozen = lambda n: not recipe.filter_fn(n)
        watch = ("model.language_model.enc_rel_bias",
                 "model.language_model.encoder_blocks.0.",
                 "temporal_encoder.mrc_head", "model.qformer.layers.0.")
        probe.moving = lambda n: n.startswith(watch)
        probe.skip_saves = True  # not written: phase 21 takes its time
        final, got = cli_run("SF train.main", probe, lambda: T.main(args),
                             step_want, eval_want, card,
                             pseudo_want=pseudo_want)
        add(got)
        probe.frozen = probe.moving = None
        probe.skip_saves = False
        if len(probe.steps) != 2 or len(probe.pseudo) != 2:
            fail(f"SF: {len(probe.steps)} steps and {len(probe.pseudo)} "
                 "pseudo passes, not 2 and 2")
        enc = mcfg.blip2.t5.num_encoder_layers
        check_bwd_groups("SF steps", probe.bwd, mcfg, 2, text_len)
        trainer, state = probe.fits[-1]
        changed = snapshot_changed(state.model, probe.snapshot)
        if changed:
            fail(f"SF: frozen parameters changed: {changed[:5]}")
        moved = snapshot_changed(state.model, probe.moving_snapshot)
        still = sorted(set(probe.moving_snapshot) - set(moved))
        if still:
            fail(f"SF: trainable parameters did not move: {still[:5]}")
        log(f"  SF: all {len(probe.snapshot)} frozen parameters (ViT-g, "
            f"RAFT) bit-identical after fit; all {len(moved)} watched T5, "
            f"TGB and Q-Former tensors moved")
        for i, (st, r) in enumerate(zip(probe.steps, probe.pseudo)):
            m = st["metrics"]
            for key in ("loss", "lm_loss", "mrc_loss"):
                if key not in m or not math.isfinite(m[key]):
                    fail(f"SF step {i + 1}: {key} missing or non-finite {m}")
            sc = r["scores"]
            if not bool(((sc >= 0) & (sc <= 1)).all()):
                fail(f"SF pseudo pass {i + 1}: scores outside [0, 1]")
            last = r["lengths"] - 1
            if not bool(((r["starts"] >= 0) & (r["starts"] <= r["ends"])
                         & (r["ends"] <= last)).all()):
                fail(f"SF pseudo pass {i + 1}: spans {r['starts'].tolist()} "
                     f"- {r['ends'].tolist()} outside the flow lengths "
                     f"{r['lengths'].tolist()}")
            log(f"  SF step {i + 1}: pseudo pass {r['ms']:.2f} ms + "
                f"train_step {st['step_ms']:.2f} ms; loss {m['loss']:.6f} = "
                f"lm {m['lm_loss']:.6f} + mrc {m['mrc_loss']:.6f}; scores in "
                f"[{float(sc.min()):.4f}, {float(sc.max()):.4f}], spans "
                f"{list(zip(r['starts'].tolist(), r['ends'].tolist()))} in "
                f"flow lengths {r['lengths'].tolist()} on {card}")
        for r in probe.opt:
            log(f"  SF optimizer step: {r['held'] / 2 ** 30:.2f} GiB held "
                f"before it (parameters, gradients, moments, the step's "
                f"leftovers), clip_grad_norm_ and the fused AdamW add "
                f"{r['add'] / 2 ** 30:.2f} GiB at their peak on {card}")
        if set(final) != {"val/score"}:
            fail(f"SF: final metrics {final}, want val/score alone")
        if len(probe.saves) != 1 or not probe.saves[0].get("skipped"):
            fail(f"SF: saves {probe.saves}, want one, not written")

        # kernel C's ds through autograd: one backward on kernel C keeps
        # every call's inputs; each call's ds against C's plain version on
        # the same inputs, then their sum over the 24 layers carried into
        # the T5 relative-position embedding's gradient both ways
        batch = device_batch(next(iter(T.build_data(compose(
            T.CONFIG_DIR, "train", args), mcfg)[1])), state.model.device)
        batch["scores"] = torch.rand((b, mcfg.num_frames),
                                     generator=torch.Generator().manual_seed(1))
        state.model.zero_grad(set_to_none=True)
        probe.bwd.clear()
        probe.keep_args = True
        try:
            loss, _ = recipe.loss_fn(
                state.model, batch,
                torch.Generator(device="cuda").manual_seed(5),
                deterministic=True)
            loss.backward()
        finally:
            probe.keep_args = False
        state.model.zero_grad(set_to_none=True)
        calls = [c for c in probe.bwd if c["ds"]]
        if len(calls) != enc:
            fail(f"SF: {len(calls)} kernel C calls wrote ds, not {enc}")
        sums, worst = [0, 0], 0.0
        for c in calls:
            plain = flash_backward_reference(*c["args"])[3]
            worst = max(worst, float((c["dbias"] - plain).abs().max())
                        / float(plain.abs().max()))
            sums[0] = sums[0] + c["dbias"].sum(0, keepdim=True)
            sums[1] = sums[1] + plain.sum(0, keepdim=True)
        log(f"  SF kernel C ds per call against its plain version on the "
            f"same inputs: largest max_abs_err / max |plain| "
            f"{worst:.3e} over the {enc} calls")
        if worst > 2e-2:
            fail(f"SF: kernel C's ds disagrees with its plain version "
                 f"({worst:.3e} of the largest entry)")
        check_to_largest(f"SF ds summed over the {enc} encoder layers",
                         sums[0], sums[1], 2e-2,
                         "ds through bf16 products, summed in another order")
        t5m = state.model.model.language_model
        s_enc = calls[0]["shape"][2]
        pos = torch.arange(s_enc, device=state.model.device)
        emb = [p for p in t5m.enc_rel_bias.parameters()]
        rel = t5m.enc_rel_bias(pos, pos)
        grads = [torch.autograd.grad(rel, emb, x.to(rel.dtype),
                                     retain_graph=True) for x in sums]
        for n, (x, y) in enumerate(zip(*grads)):
            check_to_largest(
                f"SF T5 relative-position embedding {n} gradient from "
                f"kernel C's ds vs its plain version's", x, y, 2e-2,
                "the 24 layers' ds rounded through bf16 products, summed "
                "in another order")
        for c in calls:
            c.pop("args")
            c.pop("dbias")
        del calls, rel, sums, emb, t5m, pos, plain, x, y
        del trainer, state, batch, grads, loss
        probe.bwd.clear()
        probe.models.clear()
        probe.fits.clear()
        shutil.rmtree(out)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 16b: SF with online flow on InstructBLIP-Flan-T5, 2 steps
        held("before 16b")
        t = time.perf_counter()
        cfg = compose(T.CONFIG_DIR, "train", [
            "model=LSTP_SF_small", "trainer.max_steps=2"] + SF_SHAPES)
        model, mcfg = T.build_model(cfg.model, device="cuda", seed=cfg.seed)
        recipe = T.build_recipe(cfg.model)
        if not recipe.online_flow or not mcfg.instruction_aware:
            fail(f"16b: {recipe}, instruction-aware {mcfg.instruction_aware}")
        _, val_loader, tok = T.build_data(cfg, mcfg)
        host = next(iter(val_loader))
        db = device_batch(host, model.device)
        l_flow = cfg.data.max_flow_len
        gen = torch.Generator(device="cuda").manual_seed(16)
        fs = mcfg.tgb.flow_size
        db["flow_frames"] = torch.randint(
            0, 256, (b, l_flow + 1, fs, fs, 3), generator=gen,
            device="cuda").float()
        db["flow_mask"] = torch.ones_like(db["flow_mask"])
        db["video_length"] = torch.full_like(db["video_length"], l_flow)
        pseudo_b = expected_launches(mcfg, "pseudo", text_len, answer_len)
        step_b = {**expected_launches(mcfg, "sf", text_len, answer_len),
                  "corr_lookup": mcfg.raft.iters}
        log(f"  16b derived launches: pseudo pass {pseudo_b}, step {step_b}")
        trainer = Trainer(TrainerConfig(max_steps=2), recipe.loss_fn,
                          recipe.filter_fn)
        probe.bwd.clear()
        torch.cuda.reset_peak_memory_stats()
        got, state = library_sf_steps(
            "SF online flow", card, model, recipe, trainer, db,
            host["_text_answer"], tok, max_new, pseudo_b, step_b)
        add(got)
        check_bwd_groups("SF online flow steps", probe.bwd, mcfg, 2,
                         text_len)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  16b: {got['corr_lookup']} lookups over 2 steps; peak device "
            f"memory {peak:.2f} GiB; {time.perf_counter() - t:.1f} s with the "
            f"build on {card}")
        del model, trainer, state, db
        probe.models.clear()  # its CUDA graphs' pools go with the model
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 16c: E2E on InstructBLIP-Vicuna-7B, 2 steps (step 0 has lr 0)
        held("before 16c")
        t = time.perf_counter()
        cfg = compose(T.CONFIG_DIR, "train", [
            "model=LSTP_instructblip_e2e", "trainer.max_steps=2"] + SF_SHAPES)
        model, mcfg = T.build_model(cfg.model, device="cuda", seed=cfg.seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        recipe = T.build_recipe(cfg.model)
        _, val_loader, tok = T.build_data(cfg, mcfg)
        db = device_batch(next(iter(val_loader)), model.device)
        packed = db["instruction_ids"].shape[1]
        step_c = expected_launches(mcfg, "e2e", text_len, answer_len, packed)
        log(f"  16c derived launches per step: {step_c}")
        params = dict(model.named_parameters())
        llama = [n for n in params if n.startswith("model.language_model.")]
        watch = [n for n in params
                 if n.startswith(("model.qformer.layers.0.",
                                  "model.query_tokens"))]
        frozen_watch = llama[:4] + llama[-2:]
        before = {n: params[n].detach().cpu() for n in watch + frozen_watch}
        trainer = Trainer(TrainerConfig(max_steps=2), recipe.loss_fn,
                          recipe.filter_fn)
        state = trainer.init_state(model)
        probe.bwd.clear()
        torch.cuda.reset_peak_memory_stats()
        from videotgb_torch.ops import kernels

        for i in range(2):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t1 = time.perf_counter()
            state, metrics = trainer.train_step(state, db)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            got = dict(kernels.LAUNCHES)
            nz = {k: v for k, v in got.items() if v}
            m = {k: float(v) for k, v in metrics.items()}
            log(f"  Vicuna E2E step {i}: {ms:.2f} ms, launches {nz}, {m}")
            if got != {**dict.fromkeys(got, 0), **step_c}:
                fail(f"Vicuna E2E step {i}: launches {nz} != {step_c}")
            check_bodies(f"Vicuna E2E step {i}", got)
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"Vicuna E2E step {i}: non-finite metrics")
            add(got)
        (shapes,) = check_bwd_groups("Vicuna E2E steps", probe.bwd, mcfg,
                                     2, text_len, packed)["llama"]
        after = {n: p.detach().cpu() for n, p in model.named_parameters()
                 if n in before}
        if any(params[n].grad is not None or params[n].requires_grad
               for n in llama):
            fail("Vicuna E2E: a LLaMA parameter takes a gradient")
        if any(not torch.equal(after[n], before[n]) for n in frozen_watch):
            fail("Vicuna E2E: a LLaMA parameter changed")
        if all(torch.equal(after[n], before[n]) for n in watch):
            fail("Vicuna E2E: the Q-Former did not move")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  16c: the {len(llama)} LLaMA tensors frozen (no gradient; "
            f"{len(frozen_watch)} watched bit-identical), the Q-Former moved; "
            f"model built in {build_s:.2f} s; peak device memory {peak:.2f} "
            f"GiB; {time.perf_counter() - t:.1f} s on {card}")
        del model, trainer, state, db, params, after, before
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        probe.remove()
        probe.clear()
        shutil.rmtree(root, ignore_errors=True)

    # ---- kernel C at the two shapes this phase gave it, beside SDPA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    s = 4 * 32 + text_len
    t5_bias = torch.randn((b, 32, s, s), generator=gen, device=dev)
    rows = {"ds": c_at(card, "T5-xl encoder with ds", b, 32, s, s, 64,
                       t5_bias, True)}
    bb, hh, sq, dd, skv = shapes
    mask = torch.ones((bb, skv), device=dev)
    mask[1, skv - 20:] = 0
    causal = make_causal_bias(sq, skv, device=dev) + make_padding_bias(mask)
    rows["hd128"] = c_at(card, "LLaMA head dim 128, two passes", bb, hh, sq,
                         skv, dd, causal, False)
    log(f"  phase 16 ran in {time.perf_counter() - t16:.1f} s")
    return launches, rows


# ----------------------- phase 17: stage 3 (IV, IVT) and its checkpoint served
S3_TEXT, S3_ANSWER, S3_NEW = 128, 32, 16
S3_CLI = ["model.preset=flagship", "data.num_workers=4",
          f"data.max_txt_len={S3_TEXT}", f"data.answer_len={S3_ANSWER}",
          f"model.eval_max_new={S3_NEW}", "trainer.max_steps=2",
          "trainer.eval_every=10", "trainer.log_every=1",
          "extras.print_config=false"]


def write_stage3_data(root: str) -> dict:
    """The stage-3 ``text_dir`` of phase 17, written from a seed with cv2:
    3 JPEGs and 2 mp4 videos (mp4v, 320 x 240, 48 frames); train.json (8
    rows: 3 image, 4 video, 1 text-only), val.json (1 image, 1 video),
    pseudo_label.json (spans inside (0, 1)) and nlp_tune.json (2 text-only
    rows, IVT's). Fails if cv2 cannot write the mp4 or read it back."""
    import numpy as np

    try:
        import cv2
    except ImportError as e:
        fail(f"phase 17 writes its images and videos with cv2, which does "
             f"not import here ({e})")
    td = os.path.join(root, "data", "ivinstruct")
    os.makedirs(td)
    rng = np.random.default_rng(17)
    w, h, n = 320, 240, 48
    for i in range(3):
        if not cv2.imwrite(os.path.join(td, f"img{i}.jpg"), rng.integers(
                0, 255, (h, w, 3), np.uint8)):
            fail("phase 17: cv2 cannot write a JPEG here")
    for i in range(2):
        path = os.path.join(td, f"vid{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                                 (w, h))
        if not writer.isOpened():
            fail(f"phase 17: cv2 {cv2.__version__} cannot write an mp4 "
                 f"(mp4v) here; the video rows need one")
        base = rng.integers(0, 255, (h, w, 3), np.uint8)
        for f in range(n):  # a moving pattern: the frames differ
            writer.write(np.roll(base, 7 * f, axis=1))
        writer.release()
        cap = cv2.VideoCapture(path)
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        ok, frame = cap.read()
        cap.release()
        if not ok or frame.shape != (h, w, 3) or count < n:
            fail(f"phase 17: cv2 {cv2.__version__} cannot read back the mp4 "
                 f"it wrote (opened {ok}, {count} frames of {n})")

    def row(rid, q, a, **media):
        return {"id": rid, **media, "conversations": [
            {"from": "human", "value": q}, {"from": "gpt", "value": a}]}

    train = [
        row("i0", "<image>\nwhat is shown?", "a field of noise", image="img0.jpg"),
        row("v0", "<video>\nwhat moves?", "the pattern slides right",
            video="vid0.mp4"),
        row("i1", "<image>\ndescribe the colours.", "many small dots",
            image="img1.jpg"),
        row("v1", "<video>\nwhat happens first?", "stripes shift",
            video="vid1.mp4"),
        row("t0", "name a primary colour.", "red"),
        row("v2", "<video>\nhow fast is it?", "a few pixels a frame",
            video="vid0.mp4"),
        row("i2", "<image>\nis it a photo?", "no it is random",
            image="img2.jpg"),
        row("v3", "<video>\nwhen does it stop?", "it does not stop",
            video="vid1.mp4", pseudo_label=[0.1, 0.6]),
    ]
    val = [row("i9", "<image>\nwhat is this?", "noise", image="img2.jpg"),
           row("v9", "<video>\nwhat changes?", "the offset",
               video="vid1.mp4")]
    nlp = [row("n0", "what is two plus two?", "four"),
           row("n1", "say hello.", "hello")]
    spans = {"v0": [0.25, 0.75], "v1": [0.5, 1.0], "v2": [0.0, 0.4],
             "v9": [0.2, 0.9]}
    for name, obj in (("train", train), ("val", val), ("nlp_tune", nlp),
                      ("pseudo_label", spans)):
        with open(os.path.join(td, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return {"text_dir": td, "train": train, "val": val, "nlp": nlp,
            "spans": spans}


def check_stage3_rows(data, nframe, image_size) -> None:
    """Every row of the phase's data read by the port's dataset without
    its resampling: image rows width 1, video rows width ``nframe`` with
    frames cropped to their span (distinct frames), text rows width 0."""
    import numpy as np

    from videotgb_torch.data.datasets import IVInstructDataset

    td = data["text_dir"]
    for split in ("train", "val"):
        ds = IVInstructDataset(
            os.path.join(td, f"{split}.json"), td, td, nframe=nframe,
            image_size=image_size, include_text_only=True,
            text_only_path=os.path.join(td, "nlp_tune.json"),
            pseudo_label_path=os.path.join(td, "pseudo_label.json"))
        widths = []
        for i in range(len(ds)):
            try:
                got = ds._get(i)
            except Exception as e:  # noqa: BLE001
                what = (ds.data[i].get("video") or ds.data[i].get("image")
                        or "text")
                fail(f"phase 17: {split} row {i} ({what}) does not load: "
                     f"{e!r}")
            d = ds.data[i]
            want = nframe if "video" in d else 1 if "image" in d else 0
            if got["width"] != want:
                fail(f"phase 17: {split} row {i} has width {got['width']}, "
                     f"not {want}")
            if want and not np.isfinite(got["frames"]).all():
                fail(f"phase 17: {split} row {i}: non-finite frames")
            if "video" in d and len({f.tobytes() for f in got["frames"]}) < 2:
                fail(f"phase 17: {split} row {i}: the sampled video frames "
                     "are all alike")
            widths.append(got["width"])
        log(f"  stage-3 {split} rows read without resampling: widths "
            f"{widths} ({len(ds)} rows, with nlp_tune.json's)")


def expected_stage3(mcfg, text_len, answer_len, max_new) -> tuple:
    """(a micro-batch's launches, an eval batch's) of IV / IVT, derived
    from the config and the dispatch rule: the ViT-g over the pre-selected
    frames and the Q-Former (instruction-aware: its self-attention over the
    queries and the instruction) mean-pooled to Q visual tokens, then the
    T5 encoder over [Q | question] and its decoder over the answer, or the
    LLaMA over [Q | packed prompt and answer]. The backward (kernel C) runs
    through every flash attention after the ViT, whose parameters are
    frozen and whose input needs no gradient. An eval batch is the loss
    pass and ``generate_iv`` (the encoder or the LLaMA prefill over [Q |
    question]; single-token decode steps go plain)."""
    vit = mcfg.vit
    n_img = (vit.image_size // vit.patch_size) ** 2 + 1
    qf = (mcfg.blip2 or mcfg.instructblip).qformer
    q = qf.num_query_tokens
    q_self = q + (text_len if mcfg.instruction_aware else 0)
    qformer = (qf.num_layers * flash_on(q_self, q_self)
               + len(range(0, qf.num_layers, qf.cross_attention_frequency))
               * flash_on(q, n_img))
    frames = vit.num_layers * flash_on(n_img, n_img) + qformer
    if mcfg.backbone == "blip2":
        t5 = mcfg.blip2.t5
        enc = q + text_len
        encoder = t5.num_encoder_layers * flash_on(enc, enc)
        dec = t5.num_decoder_layers * (flash_on(answer_len, answer_len)
                                       + flash_on(answer_len, enc))
        step_a, step_c = frames + encoder + dec, qformer + encoder + dec
        generate = frames + encoder
    else:
        llm = mcfg.instructblip.llm
        s = q + text_len + answer_len
        step_a = frames + llm.num_layers * flash_on(s, s)
        step_c = qformer + llm.num_layers * flash_on(s, s)
        generate = frames + llm.num_layers * flash_on(q + text_len,
                                                      q + text_len + max_new)
    step = {"flash_fwd": step_a}
    if step_c:
        step["flash_bwd"] = step_c
    return step, {"flash_fwd": step_a + generate}


def stage3_paths(card: str) -> tuple:
    """Phase 17: IVT on BLIP2-Flan-T5-xl through ``train.main`` (17a), its
    checkpoint served through ``load_model`` and scored by
    ``evaluate.main`` (17b), IV on InstructBLIP-Vicuna-7B through
    ``train.main`` (17c); then kernel C at the phase's two shapes. Returns
    (the launches of the counted runs, C's rows)."""
    import shutil
    from types import SimpleNamespace

    import torch

    from videotgb_torch import evaluate as EV
    from videotgb_torch import train as T
    from videotgb_torch.config import compose
    from videotgb_torch.data.datasets import IVInstructDataset, collate_iv
    from videotgb_torch.data.loader import device_batch
    from videotgb_torch.data.tokenizer import load_tokenizer
    from videotgb_torch.evalsuite.inference import load_model
    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.attention import make_causal_bias, make_padding_bias
    from videotgb_torch.ops.decode import DecodeConfig

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    t17 = time.perf_counter()
    root = os.path.join(HERE, "build", "phase17")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    import cv2

    t = time.perf_counter()
    data = write_stage3_data(root)
    mcfg = V.with_lora(V.VideoTGBConfig.flagship(), 8)
    check_stage3_rows(data, mcfg.nframe, mcfg.vit.image_size)
    log(f"  stage-3 data (cv2 {cv2.__version__}): {len(data['train'])} train, "
        f"{len(data['val'])} val and {len(data['nlp'])} nlp_tune rows, 3 "
        f"JPEGs, 2 mp4 videos of 48 frames at 320x240, spans "
        f"{data['spans']}, written and read in {time.perf_counter() - t:.2f} "
        f"s")
    probe = CliProbe()
    probe.install()
    try:
        # ---- 17a: IVT on BLIP2-Flan-T5-xl: batch 1 x 4 micro-batches a step
        micro, eval_want = expected_stage3(mcfg, S3_TEXT, S3_ANSWER, S3_NEW)
        accum = 4
        step_want = {k: accum * v for k, v in micro.items()}
        log(f"  17a derived launches: a micro-batch {micro} (the reckoning "
            f"before the run: 39 + 24 A, 24 C), {accum} a step; an eval "
            f"batch {eval_want} (126 A)")
        out = os.path.join(root, "ivt")
        args = (["experiment=LSTP_blip2flant5xl_ivtinstruct",
                 "data.batch_size=1", f"trainer.accumulate_grad_batches={accum}",
                 f"paths.root_dir={root}", f"paths.output_dir={out}"] + S3_CLI)
        cfg = compose(T.CONFIG_DIR, "train", args)
        recipe = T.build_recipe(cfg.model)
        probe.frozen = lambda n: not recipe.filter_fn(n)
        probe.snapshot_device = "cuda"
        probe.moving = lambda n: recipe.filter_fn(n) and (
            n.endswith("lora_b") or n.startswith((
                "model.qformer.layers.0.", "model.language_projection",
                "model.query_tokens")))
        # made, counted and held in host memory, not written: the 17.2 GB
        # write gives its time to phase 24; 17b restores the held copy
        probe.hold_saves = True
        final, got = cli_run("IVT train.main", probe, lambda: T.main(args),
                             step_want, eval_want, card)
        add(got)
        probe.frozen = probe.moving = None
        if len(probe.steps) != 2 or len(probe.saves) != 1 \
                or not probe.saves[0]["bytes"]:
            fail(f"IVT: {len(probe.steps)} steps, saves {probe.saves}; want "
                 "2 steps and one save")
        if probe.row_faults:
            fail(f"IVT: rows failed to load and were replaced: "
                 f"{probe.row_faults}")
        check_bwd_groups("IVT micro-batches", probe.bwd, mcfg, 2 * accum,
                         S3_TEXT, visual=mcfg.blip2.qformer.num_query_tokens,
                         t5_ds=False)
        trainer, state = probe.fits[-1]
        trained = state.model
        changed = snapshot_changed(trained, probe.snapshot)
        if changed:
            fail(f"IVT: frozen parameters changed: {changed[:5]}")
        moved = snapshot_changed(trained, probe.moving_snapshot)
        still = sorted(set(probe.moving_snapshot) - set(moved))
        if still:
            fail(f"IVT: trainable tensors did not move: {still[:5]}")
        n_lora = sum(n.endswith("lora_b") for n in moved)
        log(f"  IVT: all {len(probe.snapshot)} frozen tensors (ViT-g, T5, "
            f"TGB, RAFT, the adapters' A aside) bit-identical after fit; all "
            f"{len(moved)} watched tensors moved, {n_lora} of them the "
            f"adapters' B (their A take no gradient while B is 0, so they "
            f"move from step 3 on)")
        for r in probe.steps:
            log(f"  IVT step {r['step']}: micro-batch widths {r['widths']}")
        probe.snapshot = probe.moving_snapshot = None
        torch.cuda.empty_cache()

        # a text-only row's loss does not depend on its frame slab
        tok = load_tokenizer(cfg.data.get("tokenizer"))
        td = data["text_dir"]
        ds = IVInstructDataset(os.path.join(td, "train.json"), td, td,
                               nframe=mcfg.nframe,
                               image_size=mcfg.vit.image_size)
        rows = [ds._get(1), ds._get(4)]  # a video row, a text-only row
        host = collate_iv(rows, tok, mcfg.nframe, mcfg.vit.image_size,
                          S3_TEXT, S3_ANSWER)
        db = device_batch(host, trained.device)
        with torch.no_grad():
            l1, _ = recipe.loss_fn(trained, db)
            db["frames"][1] = 99.0
            l2, _ = recipe.loss_fn(trained, db)
        l1, l2 = float(l1), float(l2)
        log(f"  IVT text-only row: loss {l1!r} with a zero slab, {l2!r} with "
            f"99.0 in it (widths {host['widths'].tolist()}; "
            f"{'bit-identical' if l1 == l2 else 'differ'}) on {card}")
        if not math.isclose(l1, l2, rel_tol=1e-5):
            fail(f"IVT: a text-only row's loss depends on its frames: {l1} "
                 f"vs {l2}")
        val_score = final["val/score"]

        # ---- 17b: the checkpoint through load_model, against the trained
        # model held in memory (the same bf16 residency), then evaluate.main
        ref = V.VideoTGB(V.bf16_param_config(mcfg), device="cuda", seed=0)
        ref.load_state_dict(trained.state_dict())
        with torch.no_grad():  # the residency rounds RAFT's weights too
            for p in ref.of_extractor.parameters():
                p.copy_(p.to(torch.bfloat16))
        del trainer, state, trained, db
        probe.fits.clear()
        probe.models.clear()
        gc.collect()
        torch.cuda.empty_cache()
        ckpt = os.path.join(out, "checkpoints")
        n_restores = len(probe.restores)
        t = time.perf_counter()
        model, cfg_b = load_model(SimpleNamespace(
            model_path=ckpt, preset="flagship", backbone="blip2", lora=1,
            bf16_params=True), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if cfg_b != ref.config:
            fail(f"17b: load_model's config {cfg_b} != the trained one")
        r = probe.restores[n_restores]
        mine, theirs = model.state_dict(), ref.state_dict()
        if mine.keys() != theirs.keys() or any(
                not torch.equal(mine[k], theirs[k]) for k in mine):
            fail("17b: the restored parameters differ from the trained "
                 "model's at bf16")
        log(f"  17b load_model(--lora 1, bf16): {load_s:.2f} s, of it the "
            f"restore of {r['bytes'] / 1e9:.3f} GB in {r['s']:.2f} s; all "
            f"{len(mine)} tensors bit-identical to the trained model's cast "
            f"to bf16 (RAFT's rounded in f32) on {card}")
        b, n_flow, text_len = 4, 5, 24
        img, fs = mcfg.vit.image_size, mcfg.tgb.flow_size
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(17)
        frames_u8 = torch.randint(0, 256, (b, mcfg.num_frames, img, img, 3),
                                  generator=gen, device=dev,
                                  dtype=torch.uint8)
        flow_u8 = torch.randint(0, 256, (b, n_flow, fs, fs, 3),
                                generator=gen, device=dev, dtype=torch.uint8)
        batch = _batch(mcfg, b, n_flow - 1, text_len, gen, dev)
        dcfg = DecodeConfig(max_new_tokens=16,
                            eos_token_id=mcfg.blip2.t5.eos_token_id,
                            pad_token_id=mcfg.blip2.t5.pad_token_id)
        serve_want = {**dict.fromkeys(kernels.LAUNCHES, 0),
                      "corr_lookup": mcfg.raft.iters, "select_frames": 1,
                      "flash_fwd": mcfg.vit.num_layers}
        served = []
        for name, m in (("restored", model), ("in memory", ref)):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            sel_gen = torch.Generator(device=dev).manual_seed(7)
            cand = V.select_phase_blip2(m, flow_u8, batch, generator=sel_gen)
            sel = frames_u8[torch.arange(b, device=dev)[:, None], cand]
            tokens = V.answer_phase_blip2(m, sel, batch, dcfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got = dict(kernels.LAUNCHES)
            log(f"  17b {name} model: select + answer for {b} requests "
                f"{ms:.2f} ms, launches "
                f"{ {k: v for k, v in got.items() if v} }, frames "
                f"{cand.tolist()}")
            if got != serve_want:
                fail(f"17b {name}: launches {got} != {serve_want}")
            check_bodies(f"17b {name}", got)
            if name == "restored":
                add(got)
            served.append((cand, tokens))
        if not (torch.equal(served[0][0], served[1][0])
                and torch.equal(served[0][1], served[1][1])):
            fail("17b: the restored model's frames or tokens differ from the "
                 "trained model's")
        log(f"  17b: frame indices and all {served[0][1].numel()} tokens "
            f"identical between the restored and the in-memory model")
        del model, ref, served, batch
        gc.collect()
        torch.cuda.empty_cache()
        eval_args = args + [f"ckpt_path={ckpt}"]
        metrics, got = cli_run("IVT evaluate.main", probe,
                               lambda: EV.main(eval_args), {}, eval_want,
                               card)
        add(got)
        log(f"  17b evaluate.main: {metrics}; the run's final eval "
            f"{final}")
        if metrics.get("test/score") != val_score:
            fail(f"17b: evaluate.main's test/score {metrics.get('test/score')}"
                 f" != the run's val/score {val_score}")
        if not math.isclose(metrics["test/loss"], final["val/loss"],
                            rel_tol=1e-5):
            fail(f"17b: test/loss {metrics['test/loss']} != val/loss "
                 f"{final['val/loss']}")
        shutil.rmtree(out)

        # ---- 17c: IV on InstructBLIP-Vicuna-7B, batch 2, 2 steps, an eval
        held("before 17c")
        try:
            import transformers  # noqa: F401

            tok_name, has_tf = "llama-vendored", True
        except ImportError:
            tok_name, has_tf = "byte", False
        log(f"  17c: transformers imports here: {has_tf}")
        if not has_tf:
            log("  17c: llama-vendored needs transformers; this run passes "
                "data.tokenizer=byte")
        vcfg = V.VideoTGBConfig.flagship("instructblip")
        packed = S3_TEXT + S3_ANSWER
        step_c, eval_c = expected_stage3(vcfg, S3_TEXT, S3_ANSWER, S3_NEW)
        log(f"  17c derived launches: a step {step_c} (the reckoning before "
            f"the run: 83 A, 44 C), an eval batch {eval_c}")
        out = os.path.join(root, "iv_vicuna")
        vargs = (["experiment=LSTP_instructblipvicuna7b_ivinstruct",
                  "data.batch_size=2", "trainer.accumulate_grad_batches=1",
                  "callbacks=none", f"data.tokenizer={tok_name}",
                  f"paths.root_dir={root}", f"paths.output_dir={out}"]
                 + S3_CLI)
        vrecipe = T.build_recipe(compose(T.CONFIG_DIR, "train", vargs).model)
        probe.frozen = lambda n: not vrecipe.filter_fn(n)
        probe.snapshot_device = "cpu"  # 8B frozen parameters: the host
        probe.moving = lambda n: n.startswith(("model.qformer.layers.0.",
                                               "model.query_tokens"))
        probe.hold_saves = False
        probe.skip_saves = True  # not written: phase 21 takes its time
        vfinal, got = cli_run("Vicuna IV train.main", probe,
                              lambda: T.main(vargs), step_c, eval_c, card)
        add(got)
        probe.frozen = probe.moving = None
        if len(probe.steps) != 2 or probe.row_faults:
            fail(f"Vicuna IV: {len(probe.steps)} steps, row faults "
                 f"{probe.row_faults}")
        check_bwd_groups("Vicuna IV steps", probe.bwd, vcfg, 2, S3_TEXT,
                         packed, visual=vcfg.instructblip.qformer
                         .num_query_tokens)
        _, vstate = probe.fits[-1]
        changed = snapshot_changed(vstate.model, probe.snapshot)
        if changed:
            fail(f"Vicuna IV: frozen parameters changed: {changed[:5]}")
        moved = snapshot_changed(vstate.model, probe.moving_snapshot)
        if sorted(set(probe.moving_snapshot) - set(moved)):
            fail("Vicuna IV: the Q-Former did not move")
        log(f"  Vicuna IV: all {len(probe.snapshot)} frozen tensors "
            f"bit-identical after fit, the {len(moved)} watched Q-Former "
            f"tensors moved; final {vfinal}; "
            f"generate_iv took the LLaMA branch on {card}")
        for r in probe.steps:
            log(f"  Vicuna IV step {r['step']}: batch widths {r['widths']}")
        del vstate
    finally:
        probe.remove()
        probe.clear()
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- kernel C at the phase's two shapes, beside SDPA's backward
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    s = 32 + S3_TEXT
    t5_bias = torch.randn((1, 32, s, s), generator=gen, device=dev)
    rows = {"t5": c_at(card, "T5-xl encoder at stage 3", 1, 32, s, s, 64,
                       t5_bias, False)}
    s = 32 + S3_TEXT + S3_ANSWER
    mask = torch.ones((2, s), device=dev)
    mask[1, s - 40:] = 0
    causal = make_causal_bias(s, s, device=dev) + make_padding_bias(mask)
    rows["llama"] = c_at(card, "LLaMA at stage 3", 2, 32, s, s, 128, causal,
                         False)
    log(f"  phase 17 ran in {time.perf_counter() - t17:.1f} s")
    return launches, rows


# ------------------------------------------------------------------ phase 18
P18_QUESTION = "what is moving in the video?"


def write_moving_clip(path: str, seed: int, frames: int = 96,
                      size: tuple = (320, 240)) -> str:
    """An mp4 (mp4v) of ``frames`` frames at ``size``: a smooth random
    texture from ``seed`` that slides 2 pixels left every frame, so RAFT
    has motion to find."""
    import cv2
    import numpy as np

    w, h = size
    rng = np.random.default_rng(seed)
    wide = w + 2 * frames
    texture = cv2.resize(rng.integers(0, 255, (h // 8, wide // 8, 3),
                                      np.uint8), (wide, h),
                         interpolation=cv2.INTER_LINEAR)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                             (w, h))
    if not writer.isOpened():
        fail(f"cv2 cannot write {path}")
    for t in range(frames):
        writer.write(np.ascontiguousarray(texture[:, 2 * t:2 * t + w]))
    writer.release()
    return path


def multipart(fields: dict) -> tuple[bytes, str]:
    """A multipart/form-data body of ``fields`` ({name: (bytes or str,
    filename or None)}) and its Content-Type."""
    import uuid

    boundary = uuid.uuid4().hex
    parts = []
    for name, (payload, filename) in fields.items():
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n"
                     .encode())
        parts.append(payload if isinstance(payload, bytes)
                     else payload.encode())
        parts.append(b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def beams_batch_invariant(name, generate, batches, top_k, flow_len) -> None:
    """``generate(batch, noise)`` with beams on the two clips in one batch
    gives each row what the clip gives in a batch of itself twice (the same
    shapes, so the same GEMM algorithms: this holds the beams' reorder and
    the caches' bookkeeping, not batch invariance of cuBLAS), frames and
    tokens; zero Gumbel noise through kernel D."""
    import torch

    def cat(rows):
        return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}

    dev = batches[0]["flow"].device
    noise = torch.zeros((top_k, 2, 2, flow_len), device=dev)
    both, cand = generate(cat(batches), noise)
    for i in (0, 1):
        alone, cand_i = generate(cat([batches[i]] * 2), noise)
        if not (torch.equal(alone[0], alone[1])
                and torch.equal(both[i], alone[0])
                and torch.equal(cand[i], cand_i[0])):
            fail(f"{name}: clip {i}'s beams in a batch with the other clip "
                 f"differ from its beams in a batch of itself")
    log(f"  {name}: batched beams equal per-clip beams, {tuple(both.shape)} "
        f"tokens, frames {cand.tolist()}")


def demo_paths(card: str) -> dict:
    """Phase 18: the chat demo (``videotgb_torch.demo.app``) at flagship
    width, bf16 residency (RAFT f32 on bf16-rounded weights), random
    weights from seed 0, two clips of 96 frames at 320x240 written with cv2
    under ``build/phase18/``, 8 flow frames, the demo's 64-token prompts.
    18a: BLIP2-Flan-T5-xl served by ``make_handler`` on 127.0.0.1 in a
    thread: GET the page; a multipart POST with beams 5 equals
    ``Chat.generate`` called directly; a greedy answer equals
    ``generate_blip2`` on the same batch and generator; nframe 8 through
    the form gives 8 frames on the same parameters (the allocator's bytes
    unchanged); 20 B + 1 D + 39 A per answer, the 96-token T5 encoder
    plain; beams on two clips in one batch equal each clip's. 18b:
    InstructBLIP-Vicuna-7B, beams 5 at 128 new tokens, 20 B + 1 D + 71 A
    (39 ViT-g + 32 on the prefill at batch 5), batched beams as in 18a.
    18c: ``tools.convert_checkpoint`` at the tiny preset from a
    raft-sintel.pth (``torch.save``, DataParallel names) and a sampler in
    safetensors where it imports (else ``torch.save``), restored by
    ``load_model`` on the card with bf16 residency and served. Returns the
    launches of the counted answers."""
    import shutil
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from types import SimpleNamespace

    import numpy as np
    import torch

    from videotgb_torch.demo import app as A
    from videotgb_torch.evalsuite.inference import load_model
    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.decode import DecodeConfig

    t18 = time.perf_counter()
    root = os.path.join(HERE, "build", "phase18")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    clips = [write_moving_clip(os.path.join(root, f"clip{i}.mp4"), seed=i)
             for i in (0, 1)]
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    walls, peaks = {}, {}

    def answer(name, expected, fn):
        """``fn()`` timed and counted against ``expected``."""
        out = []

        def drive():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(fn())
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t) * 1e3

        got = counted(name, drive, expected)
        for k in launches:
            launches[k] += got[k]
        return out[0]

    def build(backbone, **kw):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        chat = A.Chat("random:flagship", preset="flagship",
                      backbone=backbone, flow_frames=8, **kw)
        torch.cuda.synchronize()
        if chat.device.type != "cuda":
            fail(f"Chat without a device built on {chat.device}")
        raft = list(chat.model.of_extractor.parameters())
        if {p.dtype for p in raft} != {torch.float32} or not all(
                torch.equal(p, p.bfloat16().float()) for p in raft):
            fail("bf16 residency left RAFT's weights off the bf16 grid")
        log(f"  Chat({backbone}) built on the card in "
            f"{time.perf_counter() - t:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB; RAFT's "
            f"{len(raft)} tensors f32 on bf16 values")
        return chat

    # ---- 18a: BLIP2-Flan-T5-xl through the HTTP server
    chat = build("blip2")
    vit, raft_cfg = chat.cfg.vit, chat.cfg.raft
    per_answer = {"corr_lookup": raft_cfg.iters, "select_frames": 1,
                  "flash_fwd": vit.num_layers}
    chat.generate(clips[0], P18_QUESTION, do_sample=False)  # cold plans
    greedy = answer("Chat.generate greedy (T5)", per_answer,
                    lambda: chat.generate(clips[0], P18_QUESTION,
                                          do_sample=False))
    _, _, batch = chat.inputs(clips[0], P18_QUESTION)
    tokens, cand = V.generate_blip2(
        chat.model, batch, chat.decode_config(do_sample=False),
        generator=torch.Generator(chat.device).manual_seed(0))
    direct = chat.tok.batch_decode(tokens.cpu().numpy(),
                                   skip_special_tokens=True)[0]
    if direct != greedy[0] or cand[0].tolist() != greedy[1]:
        fail("Chat.generate greedy differs from generate_blip2 on its batch")
    log(f"  greedy Chat.generate equals generate_blip2: frames {greedy[1]}, "
        f"{int((tokens != 0).sum())} tokens before the pad")

    server = ThreadingHTTPServer(("127.0.0.1", 0), A.make_handler(chat))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    with open(clips[0], "rb") as f:
        video = f.read()

    def post(**fields):
        body, ctype = multipart({"video": (video, "clip0.mp4"),
                                 "question": (P18_QUESTION, None),
                                 **{k: (str(v), None)
                                    for k, v in fields.items()}})
        req = urllib.request.Request(base + "/generate", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            if "VideoTGB" not in r.read().decode():
                fail("the demo's page lacks its title")
        reply = answer("POST /generate, beams 5 (T5)", per_answer,
                       lambda: post(num_beams=5, temperature=0.2))
        beams = answer("Chat.generate beams 5 (T5)", per_answer,
                       lambda: chat.generate(clips[0], P18_QUESTION,
                                             num_beams=5))
        if (reply["answer"], reply["cand"]) != beams[:2] or \
                reply["frames"] != [A._png_b64(x) for x in beams[2]] or \
                reply["flows"] != [A._png_b64(x) for x in beams[3]]:
            fail("the POST with beams 5 and Chat.generate(num_beams=5) "
                 "answered differently")
        log(f"  POST /generate with beams 5 equals Chat.generate: frames "
            f"{beams[1]}, {len(beams[3])} flow images, answer of "
            f"{len(beams[0])} characters")
        before = torch.cuda.memory_allocated()
        view, _ = chat._model_for_nframe(8)
        shared = all(p.data_ptr() == q.data_ptr() for p, q in
                     zip(view.parameters(), chat.model.parameters()))
        if torch.cuda.memory_allocated() != before or not shared:
            fail("the nframe view copied parameters")
        del view
        wide = answer("POST /generate, nframe 8 (T5)", per_answer,
                      lambda: post(nframe=8))
        if len(wide["cand"]) != 8 or len(wide["frames"]) != 8:
            fail(f"nframe 8 gave {len(wide['cand'])} frames")
        log(f"  nframe 8 through the form: frames {wide['cand']} on the "
            f"same parameters ({before} bytes allocated before and after "
            f"the view)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("the demo's server thread did not stop")
    del server, thread  # the handler class holds the chat
    batches = [chat.inputs(c, P18_QUESTION)[2] for c in clips]
    dcfg = chat.decode_config(num_beams=5)
    beams_batch_invariant(
        "T5 beams 5", lambda b, n: V.generate_blip2(chat.model, b, dcfg,
                                                    noise=n),
        batches, chat.cfg.top_k, chat.flow_frames)
    peaks["T5"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del chat, batch, tokens, cand, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 18b: InstructBLIP-Vicuna-7B, beams 5 at 128 new tokens
    chat = build("instructblip", max_new_tokens=128)
    prefill = chat.cfg.instructblip.llm.num_layers  # 96 x 224 > 128^2
    vicuna = answer("Chat.generate beams 5, 128 tokens (Vicuna)",
                    {**per_answer, "flash_fwd": vit.num_layers + prefill},
                    lambda: chat.generate(clips[0], P18_QUESTION,
                                          num_beams=5))
    log(f"  Vicuna beams 5: frames {vicuna[1]}, answer of "
        f"{len(vicuna[0])} characters")
    batches = [chat.inputs(c, P18_QUESTION)[2] for c in clips]
    dcfg = chat.decode_config(num_beams=5)
    beams_batch_invariant(
        "Vicuna beams 5, 128 tokens",
        lambda b, n: V.generate_instructblip(chat.model, b, dcfg, noise=n),
        batches, chat.cfg.top_k, chat.flow_frames)
    peaks["Vicuna"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del chat, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 18c: the converter CLI on this machine, served on the card
    # the reference's names for the port's RAFT / TGB, shared with the tests
    sys.path.append(os.path.join(HERE, "tests"))
    import _torch_reference_names as RN
    from videotgb_torch.tools import convert_checkpoint as CC

    src = V.VideoTGB(V.VideoTGBConfig.tiny(), device="cpu",
                     seed=5).state_dict()
    raft_path = os.path.join(root, "raft-sintel.pth")
    torch.save({f"module.{k}": t for k, t in
                RN.raft_to_reference(src).items()}, raft_path)
    try:
        from safetensors.torch import save_file

        sampler = os.path.join(root, "sampler.safetensors")
        save_file(RN.tgb_to_reference(src), sampler)
    except ImportError:
        sampler = os.path.join(root, "sampler.pth")
        torch.save(RN.tgb_to_reference(src), sampler)
    out = CC.main(["--preset", "tiny", "--raft_path", raft_path,
                   "--sampler_path", sampler,
                   "--output", os.path.join(root, "converted")])
    model, cfg = load_model(SimpleNamespace(model_path=out, preset="tiny",
                                            bf16_params=1), device="cuda")
    got = model.state_dict()
    moved = [k for k in src
             if k.startswith(("of_extractor.", "temporal_encoder."))]
    if not all(torch.equal(got[k].cpu().float(),
                           src[k].bfloat16().float()) for k in moved):
        fail("the converted RAFT / TGB did not come back as written")
    gen = torch.Generator(device="cuda").manual_seed(18)
    img, fs = cfg.vit.image_size, cfg.tgb.flow_size
    frames = torch.randint(0, 256, (2, cfg.num_frames, img, img, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    flow_u8 = torch.randint(0, 256, (2, 4, fs, fs, 3), generator=gen,
                            device="cuda", dtype=torch.uint8)
    tiny = _batch(cfg, 2, 3, 8, gen, torch.device("cuda"))
    cand = V.select_phase_blip2(model, flow_u8, tiny, generator=gen)
    sel = frames[torch.arange(2, device="cuda")[:, None], cand]
    t5 = cfg.blip2.t5
    toks = V.answer_phase_blip2(model, sel, tiny, DecodeConfig(
        max_new_tokens=4, eos_token_id=t5.eos_token_id,
        pad_token_id=t5.pad_token_id))
    if tuple(toks.shape) != (2, 4) or int(toks.min()) < 0:
        fail(f"the converted tiny model answered {tuple(toks.shape)}")
    log(f"  convert_checkpoint at tiny: {len(moved)} RAFT / TGB tensors "
        f"from {os.path.basename(raft_path)} and "
        f"{os.path.basename(sampler)} restored by load_model on the card "
        f"(bf16 residency) and served: frames {cand.tolist()}")
    del model
    shutil.rmtree(root, ignore_errors=True)

    for name, ms in walls.items():
        log(f"  wall {name}: {ms:.2f} ms on {card}")
    for name, gib in peaks.items():
        log(f"  peak device memory, {name} demo: {gib:.2f} GiB on {card}")
    log(f"  phase 18 ran in {time.perf_counter() - t18:.1f} s")
    return launches


# ---------------------------------------------------- the tools (phase 19)
def run_counted(name, drive, expected, bodies=True):
    """``counted`` that also returns what ``drive`` returned: (its result,
    the launches). What it prints is logged indented (a tool's own JSON
    lines must not look like this script's)."""
    import contextlib
    import io

    printed, out = io.StringIO(), []

    def quiet():
        with contextlib.redirect_stdout(printed):
            out.append(drive())

    got = counted(name, quiet, expected, bodies)
    for line in printed.getvalue().splitlines():
        log(f"    | {line}")
    return out[0], got


def check_summary(name, s) -> None:
    """A summariser's device total must be positive and not above the
    synchronised wall of the run it traced."""
    log(f"  {name} traced: device {s['device_total_ms']:.3f} ms of "
        f"{s['wall_ms']:.3f} ms wall, {s['ops']} device operations; by "
        "family " + ", ".join(f"{f} {g['ms']:.2f} ms ({g['n']})"
                              for f, g in s["families"].items() if g["n"]))
    if not 0 < s["device_total_ms"] <= s["wall_ms"]:
        fail(f"{name}: device total {s['device_total_ms']} ms outside "
             f"(0, wall {s['wall_ms']} ms]")


def qformer_flash(card: str) -> dict:
    """Kernel A at the Q-Former's shapes (the rule sends them to the plain
    version on the model paths; the attention probe's variant c calls the
    kernel there): 128 frames (traceprobe's batch 32 x 4) x 12 heads x 32
    queries x 64, bf16, as the transposes of (frames, S, 768) projections;
    self-attention over the 32 queries with the Q-Former's (F, 1, 1, 32)
    padding bias, cross-attention over 264 ViT-g tokens without one.
    Against the plain version, timed beside it and SDPA."""
    import torch
    import torch.nn.functional as F

    from videotgb_torch.ops.attention import (dot_product_attention,
                                              flash_attention,
                                              make_padding_bias)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    frames, heads, d, q_len = 128, 12, 64, 32
    rows = {}
    for name, s_kv in (("self 32 x 32", 32), ("cross 32 x 264", 264)):
        def proj(s):
            x = torch.randn((frames, s, heads * d), generator=gen,
                            device=dev).to(torch.bfloat16)
            return x.reshape(frames, s, heads, d).transpose(1, 2)

        q, k, v = proj(q_len), proj(s_kv), proj(s_kv)
        bias = (make_padding_bias(torch.ones((frames, s_kv), device=dev))
                if s_kv == q_len else None)
        with torch.no_grad():
            got = flash_attention(q, k, v, bias)
            want = dot_product_attention(q, k, v, bias)
            err = check_close(
                f"kernel A at the Q-Former's {name} ({frames}, {heads}, "
                f"{q_len}, {s_kv}, {d})", got, want, 2e-2, 2e-2,
                "bf16 output rounding (ulp 2^-8) plus a different f32 "
                "summation order")
            ms = graph_ms(lambda: flash_attention(q, k, v, bias))
            plain = graph_ms(lambda: dot_product_attention(q, k, v, bias))
            mask = None if bias is None else bias.to(q.dtype)
            sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=d ** -0.5))
        nbytes = 2 * (2 * frames * heads * q_len * d
                      + 2 * frames * heads * s_kv * d)
        if bias is not None:
            nbytes += bias.numel() * 4
        flops = 4 * frames * heads * q_len * s_kv * d
        r = row("flash_fwd", "videotgb_torch/csrc/flash_fwd.cu", "", err, ms,
                plain, nbytes, flops, library_ms=sdpa)
        log(f"  kernel A at the Q-Former's {name}: {ms:.4f} ms a call "
            f"(device time, CUDA graph), plain {plain:.4f}, SDPA {sdpa:.4f}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}, {nbytes / 1e6:.2f} "
            f"MB, {flops / 1e9:.2f} GFLOP) on {card}")
        rows[name] = r
    return rows


def tool_paths(card: str) -> dict:
    """Phase 19: the slice's tools, each ``main`` run in the process at
    flagship width (batches, layers and iterations cut to fit the time):
    the native host library and ``clip_transform``; kernel A at the
    Q-Former shapes; ``traceprobe`` (raft, vit, qformer, decode),
    ``traintraceprobe`` (tg, ivt, sf), ``decodeprobe``, ``perfprobe``
    (vit, raft, model, pipe), ``qformerattnprobe``, ``raftencprobe`` and
    ``stemprobe``, each run's launches of A-D exactly as derived from the
    code and every summariser's device total in (0, wall]; a 2-trial sweep
    through ``run_sweep`` on the card; ``evalsuite.debug`` on a written
    file. Returns the launches of the counted runs."""
    import gc
    import shutil
    import statistics

    import numpy as np
    import torch

    from videotgb_torch import train as T
    from videotgb_torch.data import native, transforms
    from videotgb_torch.data.constants import CLIP_MEAN, CLIP_STD
    from videotgb_torch.evalsuite import debug
    from videotgb_torch.models.videotgb import VideoTGBConfig
    from videotgb_torch.ops import kernels
    from videotgb_torch.tools import (decodeprobe, perfprobe,
                                      qformerattnprobe, raftencprobe,
                                      stemprobe, traceprobe, traintraceprobe)
    from videotgb_torch.utils import sweep

    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    walls = {}

    def tally(name, drive, expected, bodies=True):
        t = time.perf_counter()
        out, got = run_counted(name, drive, expected, bodies)
        walls[name] = time.perf_counter() - t
        for k, v in got.items():
            totals[k] += v
        return out

    # ---- 19a: the native host library behind clip_transform
    if not native.available():
        fail("the native host library did not build on the card's machine")
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, (32, 240, 320, 3), np.uint8)
    host = {}
    for name, flag in (("native", True), ("numpy", False)):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            out = transforms.clip_transform(clip, 224, use_native=flag)
            times.append((time.perf_counter() - t) * 1e3)
        host[name] = (out, statistics.median(times))
    diff = float(np.abs(host["native"][0] - host["numpy"][0]).max())
    log(f"  native library {native.library_path().name}; clip_transform of "
        f"32 frames 240x320 -> 224: native {host['native'][1]:.2f} ms, numpy "
        f"{host['numpy'][1]:.2f} ms (host, median of 3), max |diff| "
        f"{diff:.3e} (tolerance 2e-2 in normalized pixels: the library's "
        "bilinear weights against cv2's fixed-point ones, "
        "tests/test_native.py)")
    if not diff <= 2e-2:
        fail(f"native and numpy clip_transform differ by {diff}")
    if native.resize_normalize(clip[:1], 224, CLIP_MEAN, CLIP_STD).shape != \
            (1, 224, 224, 3):
        fail("native resize_normalize shape")

    # ---- 19b: kernel A at the Q-Former shapes
    qrows = qformer_flash(card)

    # ---- 19c: the serving trace probe on the JAX tool's model
    t = time.perf_counter()
    model = traceprobe.serving_model(torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"  traceprobe's model (bf16 parameters, tanh GELU, RAFT bf16) built "
        f"in {time.perf_counter() - t:.2f} s")
    cfg = model.config
    vit_a = cfg.blip2.vit.num_layers
    # the answer path mean-pools the Q-Former's queries over a clip's
    # frames: the T5 encoder reads 32 visual + 24 question tokens
    enc_len = cfg.blip2.qformer.num_query_tokens + traceprobe.TEXT_LEN
    t5_a = cfg.blip2.t5.num_encoder_layers * flash_on(enc_len, enc_len)
    iters = cfg.raft.iters
    b_tr = 32
    segments = {"raft": {"corr_lookup": 3 * iters},
                "vit": {"flash_fwd": 3 * vit_a}, "qformer": {},
                # the encoder state is computed once, before the calls
                "decode": {"corr_lookup": iters, "select_frames": 1,
                           "flash_fwd": vit_a + t5_a}}
    summaries = {}
    for seg, want in segments.items():
        # decode at 4 new tokens: the Chrome trace of 16 steps (54,216
        # device operations) takes ~30 s to write
        s = tally(f"traceprobe {seg} (batch {b_tr})",
                  lambda seg=seg: traceprobe.main(
                      [seg, "--batch", str(b_tr), "--max_new", "4", "--top",
                       "8"], model=model),
                  want)
        check_summary(f"traceprobe {seg}", s)
        summaries[seg] = s

    # ---- 19d: perfprobe on the same model (pipe), then its other probes
    it, b_pipe = 2, 4
    pipe_want = {"corr_lookup": 2 * iters * (1 + it) + iters,
                 "select_frames": 2 * (1 + it) + 1,
                 "flash_fwd": (vit_a + 2 * (vit_a + t5_a)) * (1 + it)
                 + vit_a + t5_a}
    tally(f"perfprobe pipe (batch {b_pipe})", lambda: perfprobe.main(
        ["pipe", "--batch", str(b_pipe), "--iters", str(it)], model=model),
        pipe_want)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    layers = 4
    vit_rows = tally(f"perfprobe vit (batch 32, {layers} layers)",
                     lambda: perfprobe.main(["vit", "--batch", "32",
                                             "--layers", str(layers),
                                             "--iters", str(it)]),
                     {"flash_fwd": 3 * (1 + it) * layers + 3})
    for r in vit_rows[1:4]:
        # one bf16 layer on activations of size ~1: products and attention
        # rounded in another order
        if not r["max_abs_vs_a"] <= 2 ** -4:
            fail(f"perfprobe {r['probe']} differs from A by "
                 f"{r['max_abs_vs_a']}")
    tally("perfprobe raft (8 pairs, f32)", lambda: perfprobe.main(
        ["raft", "--pairs", "8", "--iters", str(it)]),
        {"corr_lookup": iters * (1 + it)}, bodies=False)
    tally("perfprobe model (batch 8)", lambda: perfprobe.main(
        ["model", "--batch", "8", "--iters", str(it)]),
        {"flash_fwd": vit_a * (1 + it)})

    # ---- 19e: the Q-Former attention probe, kernel A below the rule
    f_q, l_q = 128, 4
    out = tally(f"qformerattnprobe ({f_q} frames, {l_q} layers)",
                lambda: qformerattnprobe.main(
                    ["--frames", str(f_q), "--layers", str(l_q), "--iters",
                     str(it)]),
                {"flash_fwd": 3 * ((1 + it) * l_q + 1)})
    for key, r in out.items():
        # c is kernel A; b sums the same f32 scores by einsum
        if not r["max_abs_vs_a"] <= 2 ** -4:
            fail(f"qformerattnprobe {key}: {r['max_abs_vs_a']} from a")

    # ---- 19f: RAFT's encoder and stem (cuDNN, no kernel)
    enc = tally("raftencprobe (fnet 64, cnet 32)", lambda: raftencprobe.main(
        ["--fnet", "64", "--cnet", "32", "--iters", str(it)]), {})
    stem = tally("stemprobe (batch 64)", lambda: stemprobe.main(
        ["--batch", "64", "--iters", str(it)]), {})
    # bf16 outputs of size ~1 (ulp 2^-8) from sums of 147 products in
    # another order; instance norm: two f32 variance formulas
    checks = {"raftencprobe stem_s2d": enc["stem_s2d_maxdiff"],
              "raftencprobe inorm": enc["inorm_maxdiff"],
              **{f"stemprobe {k}": v["max_abs_err"] for k, v in stem.items()}}
    log("  exactness between variants: " + ", ".join(
        f"{k} {v:.2e}" for k, v in checks.items()) + " (tolerance 2^-4)")
    bad = {k: v for k, v in checks.items() if not v <= 2 ** -4}
    if bad:
        fail(f"probe variants disagree: {bad}")

    # ---- 19g: the host decode probe
    tally("decodeprobe (3 clips)", lambda: decodeprobe.main(
        ["--clips", "3"]), {})

    # ---- 19h: the training trace probe: tg and ivt on one flagship model
    t = time.perf_counter()
    tmodel = T.build_model({"preset": "flagship", "lora_rank": 8},
                           device=torch.device("cuda"))[0]
    torch.cuda.synchronize()
    log(f"  traintraceprobe's flagship (f32 parameters, LoRA rank 8) built "
        f"in {time.perf_counter() - t:.2f} s")
    steps = 4  # one warm, two traced, one timed
    # ivt at one micro-batch of 4 a step: the trace of two steps of 2
    # micro-batches (57,737 device operations) takes ~30 s to write
    train_runs = {
        "tg": ({"batch": 32, "flow_len": 64}, {}),
        "ivt": ({"micro": 4, "accum": 1}, {"flash_fwd": steps * vit_a})}
    for mode, (kw, want) in train_runs.items():
        r = tally(f"traintraceprobe {mode} {kw}", lambda mode=mode, kw=kw:
                  traintraceprobe.main([mode, "--top", "8"], model=tmodel,
                                       **kw), want)
        check_summary(f"traintraceprobe {mode}", r)
        if r["state_step"] != steps or not math.isfinite(r["loss"]):
            fail(f"traintraceprobe {mode}: step {r['state_step']}, loss "
                 f"{r['loss']}")
        summaries[mode] = r
    del tmodel
    gc.collect()
    torch.cuda.empty_cache()
    sf_step = expected_launches(VideoTGBConfig.small(), "sf", 24, 16)
    r = tally("traintraceprobe sf (small, batch 8)", lambda: traintraceprobe.main(
        ["sf", "--top", "8"]), {k: steps * v for k, v in sf_step.items()})
    check_summary("traintraceprobe sf", r)
    if r["state_step"] != steps or not math.isfinite(r["loss"]):
        fail(f"traintraceprobe sf: step {r['state_step']}, loss {r['loss']}")
    summaries["sf"] = r

    # ---- 19i: a 2-trial sweep through run_sweep on the card
    root = os.path.join(HERE, "build", "phase19")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        result = tally("sweep (2 trials of smoke_tg_synthetic)",
                       lambda: sweep.run_sweep(
                           ["experiment=smoke_tg_synthetic",
                            f"paths.root_dir={root}/run"],
                           {"model.optimizer.lr": sweep.parse_space(
                               "choice(1e-4,2e-4)")},
                           trials=2, metric="val/iou_score", mode="max",
                           sampler="random"), {})
    finally:
        os.chdir(cwd)
    if len(result["history"]) != 2 or any("error" in h
                                          for h in result["history"]):
        fail(f"sweep trials failed: {result['history']}")
    multi = os.path.join(root, "run", "logs", "train", "multiruns")
    sweeps = os.listdir(multi)
    subdirs = sorted(os.listdir(os.path.join(multi, sweeps[0])))
    if len(sweeps) != 1 or subdirs != ["0", "1"]:
        fail(f"sweep layout: {sweeps} / {subdirs}")
    log(f"  sweep: best {result['best']}, history {result['history']}, "
        f"trials in {sweeps[0]}/{{0,1}}")

    # ---- 19j: the judge statistics from a written file
    combined = os.path.join(root, "combined.json")
    with open(combined, "w") as f:
        json.dump({"1": [{"pred": "yes", "score": 4}, {}],
                   "2": [{"pred": "no", "score": 2}, {}],
                   "3": [{"pred": "maybe", "score": 3}, {}]}, f)
    stats = debug.main(["--combined", combined])
    if stats != {"yes_count": 1, "no_count": 1, "accuracy": 0.5,
                 "average_score": 3.0, "count": 3}:
        fail(f"evalsuite.debug: {stats}")
    shutil.rmtree(root, ignore_errors=True)

    log("  phase 19 walls (s): " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in walls.items()))
    log(f"  phase 19 launches of the counted runs: {totals}")
    return {"launches": totals, "qformer_rows": qrows}


# ------------------------------------------ phase 20: the CUDA-graph programs
def synced_ms(fn):
    """``fn()`` and its synchronised wall in ms."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def held(label: str) -> None:
    """Log the device memory held (allocated, and reserved by the caching
    allocator and the CUDA graphs' pools) and the models still alive."""
    import torch

    from videotgb_torch.models.videotgb import VideoTGB

    from videotgb_torch.utils.graphs import Graphed

    gc.collect()
    torch.cuda.empty_cache()
    objs = gc.get_objects()
    alive = sum(isinstance(o, VideoTGB) for o in objs)
    wrappers = [(o.__name__, len(o.programs())) for o in objs
                if isinstance(o, Graphed) and o.programs()]
    cuda = [o for o in objs if torch.is_tensor(o) and o.is_cuda]
    log(f"  {label}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB "
        f"reserved, {alive} VideoTGB model(s) alive, graphed programs "
        f"{wrappers}, {len(cuda)} CUDA tensors seen by gc "
        f"({sum(t.numel() * t.element_size() for t in cuda) / 2 ** 30:.2f}"
        f" GiB)")


def graph_replay_ms(graph, before, iters=5) -> float:
    """Device time of one replay of a captured ``torch.cuda.CUDAGraph``:
    CUDA events around single replays, each after ``before()`` (the replay
    that sets up its state), median of ``iters`` after one."""
    import statistics

    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters + 1):
        before()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def graphed_against_eager(name, wrapper, call, expected, same, costs, card):
    """Three calls of the graphed entry point ``wrapper`` (the first eager,
    the second captures and replays, the third replays), each with the
    arguments ``call()`` makes anew (generators of one seed), then its eager
    function once on the same: every output equal to the eager one by
    ``same``; the launches of the third call (a replay) ``expected``, every
    A and C on the tensor-core body and B on the tile body. Appends (name,
    eager, capture, replay ms) to ``costs``; the capture is the second
    call's wall less a replay's. Returns (the eager output, the replay's
    launches)."""
    from videotgb_torch.ops import kernels

    outs, walls = [], []
    for i in range(3):
        args, kwargs = call()
        kernels.reset_launches()
        out, ms = synced_ms(lambda: wrapper(*args, **kwargs))
        outs.append(out)
        walls.append(ms)
    got = dict(kernels.LAUNCHES)
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), **expected}
    if got != want:
        fail(f"{name}: launches of a replay {got} != {want}")
    check_bodies(name, got)
    args, kwargs = call()
    ref, eager_ms = synced_ms(lambda: wrapper.eager(*args, **kwargs))
    for i, out in enumerate(outs):
        if not same(out, ref):
            fail(f"{name}: call {i + 1} of the graphed entry point differs "
                 "from the eager function")
    costs.append((name, eager_ms, walls[1] - walls[2], walls[2]))
    log(f"  {name}: graphed calls equal to the eager function (first eager "
        f"{walls[0]:.2f} ms, capture + replay {walls[1]:.2f} ms, replay "
        f"{walls[2]:.2f} ms; eager {eager_ms:.2f} ms); launches a replay "
        f"{ {k: v for k, v in got.items() if v} } on {card}")
    return ref, got


def same_tensors(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_tensors, a, b))
    return torch.equal(a, b)


def queue_burst(engine, requests) -> list:
    """``requests`` (frames, flow, question) queued as ``submit`` queues
    them, all under the queue's lock, so that the select worker finds them
    all at once and batches them alike in every engine. Returns the
    futures."""
    from concurrent.futures import Future

    from videotgb_torch import serve

    futures = [Future() for _ in requests]
    q = engine._queue
    with q.mutex:
        for fut, (frames, flow, question) in zip(futures, requests):
            q._put(serve._Request(frames, flow, question, fut,
                                  time.perf_counter()))
            q.unfinished_tasks += 1
        q.not_empty.notify()
    return futures


def graph_paths(card: str) -> dict:
    """Phase 20: the CUDA-graph programs at flagship width, each against its
    eager function (``.eager``) on the same inputs and generator seeds.
    (a) BLIP2-Flan-T5-xl serving (bf16, RAFT bf16) at batch 4:
    ``select_phase_blip2`` (20 B + 1 D a replay) and ``answer_phase_blip2``
    at 16 new tokens (39 A), greedy and sampled, frames and tokens
    identical; the decode chunk's graph replayed alone beside the eager
    decode step. (b) InstructBLIP-Vicuna-7B: its select phase and
    ``answer_phase_instructblip`` at 128 new tokens (71 A), greedy and
    sampled. (c) The serving engine, graphed and with both phases eager,
    a burst of 8 queued at once: equal replies and launches. (d) E2E
    (``LSTP_blip2_e2e``, f32 parameters, batch 8): two ``train_step`` calls
    against one ``train_step_multi`` window of K = 2 on a twin model
    (losses, gradient norms and every trainable parameter bit for bit),
    then a replayed step against an eager one; 63 A + 24 C a step. (e) TG
    at batch 32 (no kernel). Prints each program's eager, capture and
    replay walls and the peak memory. Returns the launches of the counted
    replays."""
    import numpy as np
    import torch

    from videotgb_torch import serve
    from videotgb_torch import train as T
    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import decode as D
    from videotgb_torch.ops import kernels
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    t20 = time.perf_counter()
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    costs = []

    def add(got):
        for k, v in got.items():
            totals[k] += v

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- (a) BLIP2-Flan-T5-xl serving at batch 4, 16 new tokens
    cfg = V.bf16_param_config(V.VideoTGBConfig.flagship())
    cfg = dataclasses.replace(
        cfg, raft=dataclasses.replace(cfg.raft, dtype=torch.bfloat16))
    model = V.VideoTGB(cfg, device=dev, seed=0)
    b, n_flow, img, fs = 4, 5, cfg.blip2.vit.image_size, cfg.tgb.flow_size
    gen = seeded(20)
    frames_u8 = torch.randint(0, 256, (b, cfg.num_frames, img, img, 3),
                              generator=gen, device=dev, dtype=torch.uint8)
    flow_u8 = torch.randint(0, 256, (b, n_flow, fs, fs, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
    batch = _batch(cfg, b, n_flow - 1, 24, gen, dev)
    t5 = cfg.blip2.t5
    greedy = D.DecodeConfig(max_new_tokens=16, eos_token_id=t5.eos_token_id,
                            pad_token_id=t5.pad_token_id)
    sampled = dataclasses.replace(greedy, do_sample=True, temperature=0.7,
                                  top_p=0.9)
    torch.cuda.reset_peak_memory_stats()
    cand, got = graphed_against_eager(
        "select_phase_blip2 (batch 4)", V.select_phase_blip2,
        lambda: ((model, flow_u8, batch), {"generator": seeded(7)}),
        {"corr_lookup": cfg.raft.iters, "select_frames": 1}, torch.equal,
        costs, card)
    add(got)
    sel = frames_u8[torch.arange(b, device=dev)[:, None], cand]
    for label, dcfg in (("greedy", greedy), ("sampled", sampled)):
        _, got = graphed_against_eager(
            f"answer_phase_blip2 ({label}, 16 new tokens)",
            V.answer_phase_blip2,
            lambda dcfg=dcfg: ((model, sel, batch, dcfg),
                               {"generator": seeded(8)}),
            {"flash_fwd": cfg.vit.num_layers}, torch.equal, costs, card)
        add(got)
    # the decode chunk alone, after the program's first graph (the encode
    # and step 0, which set the decode's state up)
    program = V.answer_phase_blip2.programs()[0]
    chunk = next(g for g, loop in program.steps if loop is not None)
    k = min(D.CHUNK, greedy.max_new_tokens - 1)
    chunk_ms = graph_replay_ms(chunk.graph, program.steps[0][0].graph.replay)
    with torch.no_grad():
        visual = V._encode_selected_u8(model, sel, batch)
        embeds, emask = model.model.encoder_inputs(
            visual, batch["question_ids"], batch["question_mask"])
        enc = model.model.language_model.encode(embeds, emask)
    walls = {}
    for n in (1, 16):
        dn = dataclasses.replace(greedy, max_new_tokens=n)
        V.t5_generate_from_encoder.eager(model, enc, emask, dn)
        walls[n] = min(synced_ms(lambda: V.t5_generate_from_encoder.eager(
            model, enc, emask, dn))[1] for _ in range(3))
    step_eager = (walls[16] - walls[1]) / 15
    costs.append((f"T5 decode chunk ({k} steps)", step_eager * k,
                  float("nan"), chunk_ms))
    costs.append(("T5 decode step", step_eager, float("nan"), chunk_ms / k))
    log(f"  T5-xl decode at batch 4: a chunk of {k} steps replays in "
        f"{chunk_ms:.3f} ms of device time ({chunk_ms / k:.3f} ms a step); "
        f"an eager step {step_eager:.3f} ms (16 tokens {walls[16]:.2f} ms "
        f"less 1 token {walls[1]:.2f} ms, over 15) on {card}")
    log(f"  (a) peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB reserved on "
        f"{card}")
    del model, program, chunk, enc, embeds, visual
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) InstructBLIP-Vicuna-7B, 128 new tokens
    vcfg = V.bf16_param_config(V.VideoTGBConfig.flagship("instructblip"))
    vcfg = dataclasses.replace(
        vcfg, raft=dataclasses.replace(vcfg.raft, dtype=torch.bfloat16))
    model = V.VideoTGB(vcfg, seed=0)
    frames_u8, flow_u8, vbatch = vicuna_requests(vcfg, dev)
    llm = vcfg.instructblip.llm
    vgreedy = D.DecodeConfig(max_new_tokens=128, eos_token_id=llm.eos_token_id,
                             pad_token_id=llm.pad_token_id)
    vsampled = dataclasses.replace(vgreedy, do_sample=True, temperature=0.7,
                                   top_p=0.9)
    torch.cuda.reset_peak_memory_stats()
    cand, got = graphed_against_eager(
        "Vicuna select_phase_blip2 (multi_modal, ratio)",
        V.select_phase_blip2,
        lambda: ((model, flow_u8, vbatch),
                 {"generator": seeded(7), "mode": "multi_modal",
                  "rescale": "ratio"}),
        {"corr_lookup": vcfg.raft.iters, "select_frames": 1}, torch.equal,
        costs, card)
    add(got)
    sel = frames_u8[torch.arange(b, device=dev)[:, None], cand]
    prefill = llm.num_layers  # 96 x 224 scores pass the 128^2 rule
    for label, dcfg in (("greedy", vgreedy), ("sampled", vsampled)):
        _, got = graphed_against_eager(
            f"answer_phase_instructblip ({label}, 128 new tokens)",
            V.answer_phase_instructblip,
            lambda dcfg=dcfg: ((model, sel, vbatch, dcfg),
                               {"generator": seeded(9)}),
            {"flash_fwd": vcfg.vit.num_layers + prefill}, torch.equal, costs,
            card)
        add(got)
    log(f"  (b) peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB reserved on "
        f"{card}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the serving engine, graphed and eager: a burst of 8
    rng = np.random.default_rng(20)
    scfg = V.VideoTGBConfig.flagship()
    img, fs = scfg.vit.image_size, scfg.tgb.flow_size
    reqs = [(rng.integers(0, 256, (scfg.num_frames, img, img, 3), np.uint8),
             rng.integers(0, 256, (5, fs, fs, 3), np.uint8),
             f"burst request {i}: what happens in the video?")
            for i in range(8)]
    replies, engine_launches = {}, {}
    real = (serve.select_phase_blip2, serve.answer_phase_blip2)
    for route in ("graphed", "eager"):
        if route == "eager":
            serve.select_phase_blip2 = V.select_phase_blip2.eager
            serve.answer_phase_blip2 = V.answer_phase_blip2.eager
        try:
            t = time.perf_counter()
            engine = serve.ServingEngine(
                "random:flagship", preset="flagship", batch_size=4,
                flow_frames=4, max_new_tokens=16, max_delay_ms=30)
            built = time.perf_counter() - t
            kernels.reset_launches()
            t = time.perf_counter()
            futs = queue_burst(engine, reqs)
            replies[route] = [f.result(timeout=300) for f in futs]
            burst = time.perf_counter() - t
            engine_launches[route] = dict(kernels.LAUNCHES)
            batches = engine.stats()["batches"]
        finally:
            engine.close()
            serve.select_phase_blip2, serve.answer_phase_blip2 = real
        log(f"  engine ({route} phases): built and warmed in {built:.2f} s; "
            f"the burst of 8 in {batches} batches served in {burst:.3f} s, "
            f"{8 / burst:.3f} req/s on {card}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    same = [(a.answer, a.selected_frames) == (e.answer, e.selected_frames)
            for a, e in zip(replies["graphed"], replies["eager"])]
    if not all(same):
        fail(f"the graphed engine's replies differ from the eager engine's: "
             f"{same}")
    if engine_launches["graphed"] != engine_launches["eager"]:
        fail(f"engine launches: graphed {engine_launches['graphed']} != "
             f"eager {engine_launches['eager']}")
    check_bodies("the graphed engine", engine_launches["graphed"])
    add(engine_launches["graphed"])
    log(f"  engine: all 8 replies of the graphed engine equal the eager "
        f"engine's (frames and answers); launches "
        f"{ {k: v for k, v in engine_launches['graphed'].items() if v} } in "
        f"both")

    # ---- (d) E2E: two train_step calls against a window of K = 2
    twins = [T.build_model({"preset": "flagship", "backbone": "blip2"},
                           device=dev, seed=0) for _ in range(2)]
    mcfg = twins[0][1]
    recipe = T.build_recipe({"recipe": "e2e", "tgb_mode": "multi_modal",
                             "selection": "uniform"})
    trainers = [Trainer(TrainerConfig(max_steps=4, lr=5e-5), recipe.loss_fn,
                        recipe.filter_fn) for _ in range(2)]
    states = [tr.init_state(m) for tr, (m, _) in zip(trainers, twins)]
    gen = seeded(21)
    batches = [e2e_batch(mcfg, dev, gen) for _ in range(2)]
    e2e_want = {**dict.fromkeys(kernels.LAUNCHES, 0),
                "flash_fwd": mcfg.vit.num_layers
                + mcfg.blip2.t5.num_encoder_layers,
                "flash_bwd": mcfg.blip2.t5.num_encoder_layers}
    singles, walls, peaks = [], [], []
    for i in range(2):
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (states[0], m), ms = synced_ms(
            lambda i=i: trainers[0].train_step(states[0], batches[i]))
        peaks.append((torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved()))
        singles.append(m)
        walls.append(ms)
        if dict(kernels.LAUNCHES) != e2e_want:
            fail(f"E2E step {i + 1}: launches {dict(kernels.LAUNCHES)}")
        add(dict(kernels.LAUNCHES))
    window = {key: torch.stack([bt[key] for bt in batches])
              for key in batches[0]}
    kernels.reset_launches()
    states[1], stacked = trainers[1].train_step_multi(states[1], window)
    torch.cuda.synchronize()
    if dict(kernels.LAUNCHES) != {k: 2 * v for k, v in e2e_want.items()}:
        fail(f"E2E window of 2: launches {dict(kernels.LAUNCHES)}")
    add(dict(kernels.LAUNCHES))

    def compare(label):
        params = [dict(st.model.named_parameters()) for st in states]
        diff = [n for n in trainers[0].trainable
                if not torch.equal(params[0][n], params[1][n])]
        if diff:
            fail(f"E2E {label}: trainable parameters differ: {diff[:5]}")
        return len(trainers[0].trainable)

    for i in range(2):
        for key in ("loss", "grad_norm"):
            if not torch.equal(singles[i][key], stacked[key][i]):
                fail(f"E2E step {i + 1}: {key} {float(singles[i][key])!r} "
                     f"against the window's {float(stacked[key][i])!r}")
    n_train = compare("after two steps and a window of 2")
    log(f"  E2E: two train_step calls (eager, then capture + replay) equal "
        f"a train_step_multi window of K = 2 in loss "
        f"{[float(m['loss']) for m in singles]}, grad norm "
        f"{[float(m['grad_norm']) for m in singles]} and all {n_train} "
        f"trainable tensors, bit for bit")
    # a replay against an eager step on the twin
    kernels.reset_launches()
    (states[0], m_replay), replay_ms = synced_ms(
        lambda: trainers[0].train_step(states[0], batches[0]))
    if dict(kernels.LAUNCHES) != e2e_want:
        fail(f"E2E replayed step: launches {dict(kernels.LAUNCHES)}")
    add(dict(kernels.LAUNCHES))
    trainers[1]._step = trainers[1]._step.eager
    (states[1], m_eager), eager_ms = synced_ms(
        lambda: trainers[1].train_step(states[1], batches[0]))
    for key in ("loss", "grad_norm"):
        if not torch.equal(m_replay[key], m_eager[key]):
            fail(f"E2E step 3: the replay's {key} {float(m_replay[key])!r} "
                 f"!= the eager step's {float(m_eager[key])!r}")
    compare("after a replayed step and an eager one")
    costs.append(("E2E train_step (batch 8)", eager_ms, walls[1] - replay_ms,
                  replay_ms))
    log(f"  E2E step 3: the replayed graph equals an eager step on the twin "
        f"(loss {float(m_replay['loss'])!r}, grad norm "
        f"{float(m_replay['grad_norm'])!r}, every trainable tensor); walls "
        f"first {walls[0]:.2f} ms, capture + replay {walls[1]:.2f} ms, "
        f"replay {replay_ms:.2f} ms, eager {eager_ms:.2f} ms; peak memory "
        f"eager {peaks[0][0] / 2 ** 30:.2f} GiB allocated / "
        f"{peaks[0][1] / 2 ** 30:.2f} reserved, graphed "
        f"{peaks[1][0] / 2 ** 30:.2f} / {peaks[1][1] / 2 ** 30:.2f} on {card}")
    model = states[0].model
    del trainers, states, twins, singles, stacked, window, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) TG at batch 32 on the same model: eager, capture, replay
    recipe = T.build_recipe({"recipe": "tg", "tgb_mode": "fusion"})
    trainer = Trainer(TrainerConfig(max_steps=4, lr=5e-5), recipe.loss_fn,
                      recipe.filter_fn)
    state = trainer.init_state(model)
    batch = tg_batch(mcfg, dev, gen)
    walls = []
    kernels.reset_launches()
    for _ in range(3):
        (state, m), ms = synced_ms(lambda: trainer.train_step(state, batch))
        walls.append(ms)
    if any(kernels.LAUNCHES.values()):
        fail(f"TG steps launched {dict(kernels.LAUNCHES)}")
    trainer._step = trainer._step.eager
    _, eager_ms = synced_ms(lambda: trainer.train_step(state, batch))
    costs.append(("TG train_step (batch 32)", eager_ms, walls[1] - walls[2],
                  walls[2]))
    del trainer, state, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    for name, eager_ms, capture_ms, replay_ms in costs:
        log(f"  graph cost {name}: eager {eager_ms:.3f} ms, capture "
            f"{capture_ms:.3f} ms, replay {replay_ms:.3f} ms "
            f"({eager_ms / replay_ms:.2f}x) on {card}")
    log(f"  phase 20 launches (the counted replays): "
        f"{ {k: v for k, v in totals.items() if v} }; ran in "
        f"{time.perf_counter() - t20:.1f} s")
    return totals


# ------------------------------------- phase 21: data-parallel and FSDP
P21_DIR = os.path.join(HERE, "build", "phase21")
# four last bits of phase 21's learning rate, 5e-5 (f32): how far an Adam
# update may move when its clip coefficient moves by one last bit
P21_UPDATE_BITS = 4 * 2.0 ** (math.floor(math.log2(5e-5)) - 23)


def p21_batch(cfg, dev) -> dict:
    """The global E2E batch of 8 (``e2e_batch``) with 64 flow frames and
    24-token sampler questions for the tgb selection, made from a seed on
    the card: every process makes the same one."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(21)
    batch = e2e_batch(cfg, dev, gen)
    b, flow_len, text_len, fs = 8, 64, 24, cfg.tgb.flow_size
    vocab = min(cfg.tgb.vocab_size, 5000)
    batch.update(
        flow=torch.randn((b, flow_len, fs, fs, 2), generator=gen, device=dev),
        flow_mask=torch.ones((b, flow_len + 2), device=dev),
        video_length=torch.full((b,), flow_len, device=dev),
        sampler_question_ids=torch.randint(100, vocab, (b, text_len),
                                           generator=gen, device=dev),
        sampler_question_mask=torch.ones((b, text_len), device=dev))
    return batch


def p21_tiny_batch(cfg, dev) -> dict:
    """A global E2E batch of 8 at the tiny preset (its small vocabularies),
    made from a seed on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(22)
    b, img, vocab = 8, cfg.blip2.vit.image_size, cfg.blip2.t5.vocab_size
    return {"frames": torch.randn((b, cfg.num_frames, img, img, 3),
                                  generator=gen, device=dev),
            "question_ids": torch.randint(4, vocab, (b, 6), generator=gen,
                                          device=dev),
            "question_mask": torch.ones((b, 6), device=dev),
            "answer_ids": torch.randint(2, vocab, (b, 4), generator=gen,
                                        device=dev)}


class P21Loss:
    """The E2E loss (``LSTP_blip2_e2e``: multi_modal TGB, dropout on) with
    the selection switched between steps; keeps the frames of the last
    tgb step."""

    def __init__(self):
        from videotgb_torch import train as T

        self.recipes = {s: T.build_recipe({"recipe": "e2e",
                                           "tgb_mode": "multi_modal",
                                           "selection": s})
                        for s in ("uniform", "tgb")}
        self.selection, self.cand = "uniform", None
        self.filter_fn = self.recipes["uniform"].filter_fn

    def __call__(self, model, batch, gen):
        loss, aux = self.recipes[self.selection].loss_fn(model, batch, gen)
        if self.selection == "tgb":
            self.cand = aux["cand"]
        return loss, aux


def p21_expected(tgb: bool) -> dict:
    """A flagship E2E step's launches: ViT-g's 39 and the T5-xl encoder's
    24 flash forwards, its 24 flash backwards, and D once on a tgb step."""
    from videotgb_torch.ops import kernels

    return {**dict.fromkeys(kernels.LAUNCHES, 0), "flash_fwd": 39 + 24,
            "flash_bwd": 24, "select_frames": int(tgb)}


def p21_step(name, trainer, state, batch, tgb, timer=None):
    """One counted, synchronised ``train_step``: (state, record)."""
    import torch

    from videotgb_torch.ops import kernels

    kernels.reset_launches()
    if timer is not None:
        timer.update(ms=0.0, calls=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    want = p21_expected(tgb)
    if launches != want:
        fail(f"{name}: launches {launches} != {want}")
    check_bodies(name, launches)
    rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "wall_ms": wall, "launches": launches}
    if timer is not None:
        rec.update(allreduce_ms=timer["ms"], allreduce_calls=timer["calls"])
    if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
        fail(f"{name}: non-finite loss or grad norm {rec}")
    return state, rec


def p21_fingerprint(params: dict, names) -> "torch.Tensor":
    """Per tensor, the sum and the sum of squares of its bit patterns as
    int64 (wrapping): a change of any value changes them but for a
    vanishing share of changes."""
    import torch

    rows = []
    for n in names:
        p = params[n].detach().reshape(-1)
        bits = (p.view(torch.int32) if p.element_size() == 4 else
                p.view(torch.int16)).long()
        rows.append(torch.stack([bits.sum(), (bits * bits).sum()]))
    return torch.stack(rows)


class P21Gradients:
    """While entered, keeps a copy of each trainable parameter's gradient
    as the update reads it (summed over the ranks, before the clip): on
    the FSDP2 route each rank's shard, made whole by :meth:`whole` after
    the step."""

    def __init__(self, trainer, model):
        self.trainer, self.model, self.grads = trainer, model, {}

    def __enter__(self):
        from videotgb_torch.training import trainer as TR

        self.real = real = TR.optimizer_step
        params = dict(self.model.named_parameters())

        def spy(optimizer, lr, max_grad_norm):
            for n in self.trainer.trainable:
                if params[n].grad is not None:
                    self.grads[n] = params[n].grad.detach().clone()
            return real(optimizer, lr, max_grad_norm)

        TR.optimizer_step = spy
        return self

    def __exit__(self, *exc):
        from videotgb_torch.training import trainer as TR

        TR.optimizer_step = self.real

    def whole(self) -> dict:
        from videotgb_torch.parallel.sharding import full_tensor

        return {n: full_tensor(g) for n, g in self.grads.items()}


class P21Grouping:
    """While entered, each FSDP2 unit of ``model`` (``fsdp_units``) passes
    the inputs it takes with a gradient through one identity autograd node,
    as FSDP2's ``RegisterPostBackwardFunction`` does: the unit's gradient
    contributions to such an input (a T5 decoder block's K and V
    projections of the encoder output) are summed in that node before they
    join the other units'. An unwrapped model so hooked computes the FSDP2
    route's gradients; bf16 sums grouped otherwise round otherwise."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        import torch
        from torch.utils._pytree import tree_flatten, tree_unflatten

        from videotgb_torch.parallel.sharding import fsdp_units

        class Identity(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *xs):
                return xs

            @staticmethod
            def backward(ctx, *grads):
                return grads

        def pre(module, args, kwargs):
            leaves, spec = tree_flatten((args, kwargs))
            at = [i for i, x in enumerate(leaves)
                  if torch.is_tensor(x) and x.requires_grad]
            if not at or not torch.is_grad_enabled():
                return None
            for i, x in zip(at, Identity.apply(*[leaves[i] for i in at])):
                leaves[i] = x
            return tree_unflatten(leaves, spec)

        self.hooks = [u.register_forward_pre_hook(pre, with_kwargs=True)
                      for u in fsdp_units(self.model)]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def p21_gap(got: dict, want: dict, slack: float = 0.0) -> dict:
    """``got`` against ``want`` (name -> tensor, a leaf missing on one side
    read as zeros): the leaves and entries not bit-identical, the largest
    difference of an entry in units of ``want``'s last bit (f32) plus
    ``slack``, the relative gap of the whole (all leaves as one vector)
    and the largest relative gap of a leaf among those holding at least
    1e-4 of the whole's norm, with its name."""
    import torch

    diff2 = ref2 = ulps = 0.0
    unequal = entries = 0
    norms = {}
    for n in want.keys() | got.keys():  # a leaf missing on one side: zeros
        like = got[n] if n in got else want[n]
        g, w = (x.to(like.device).float() if x is not None else
                torch.zeros(like.shape, device=like.device)
                for x in (got.get(n), want.get(n)))
        d = g - w
        entries += int((d != 0).sum())
        unequal += int(not torch.equal(g, w))
        if entries:  # the largest difference in steps of w's last bit
            ulp = torch.maximum(
                torch.nextafter(w, torch.full_like(w, math.inf)) - w,
                w - torch.nextafter(w, torch.full_like(w, -math.inf)))
            ulps = max(ulps, float((d.abs() / (ulp + slack)).max()))
        norms[n] = (float(d.norm()), float(w.norm()))
        diff2 += norms[n][0] ** 2
        ref2 += norms[n][1] ** 2
    floor = 1e-4 * math.sqrt(ref2)
    worst, leaf = max(((d / r, n) for n, (d, r) in norms.items()
                       if r >= floor), default=(0.0, None))
    return {"unequal": unequal, "leaves": len(norms), "entries": entries,
            "rel": math.sqrt(diff2 / ref2) if ref2 else 0.0,
            "worst": worst, "leaf": leaf, "ulps": ulps}


def p21_gap_text(g: dict) -> str:
    return (f"{g['unequal']} of {g['leaves']} leaves ({g['entries']} "
            f"entries) not bit-identical, at most {g['ulps']:.3g} last "
            f"bits, whole {g['rel']:.3e} relative, worst leaf {g['leaf']} "
            f"{g['worst']:.3e}")


def p21_rank() -> list:
    """One rank of phase 21 (two ranks on the one card over gloo)."""
    import faulthandler

    import torch
    import torch.distributed as dist

    from videotgb_torch import train as T
    from videotgb_torch.parallel.distributed import (
        barrier, gather_objects, process_index)
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.parallel.sharding import (full_tensor, is_sharded,
                                                  shard_batch)
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, train_state_items)
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    faulthandler.enable()  # a rank that dies prints its stack
    rank, dev = process_index(), torch.device("cuda", 0)
    tag = f"  21 rank {rank}"

    # gloo's collectives on CUDA tensors, before anything is built on them
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    g = torch.empty(8, device=dev)
    dist.all_gather_into_tensor(g, torch.full((4,), float(rank), device=dev))
    r = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(r, torch.arange(4.0, device=dev))
    if not (x.tolist() == [3.0] * 4
            and g.tolist() == [0.0] * 4 + [1.0] * 4
            and r.tolist() == [4.0 * rank, 4.0 * rank + 2.0]):
        fail(f"{tag}: gloo on CUDA tensors gave {x.tolist()}, "
             f"{g.tolist()}, {r.tolist()}")
    log(f"{tag}: gloo's all_reduce, all_gather_into_tensor and "
        f"reduce_scatter_tensor on CUDA tensors agree with their sums")

    timer = {"ms": 0.0, "calls": 0}
    real_all_reduce = dist.all_reduce

    def timed_all_reduce(t, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_all_reduce(t, *args, **kwargs)
        torch.cuda.synchronize()
        timer["ms"] += (time.perf_counter() - t0) * 1e3
        timer["calls"] += 1
        return out

    out = {"rank": rank}
    # ---- 21a: dp=2, a uniform step then a tgb step
    mesh = create_mesh(MeshConfig(dp=2), device_type="cuda")
    model, cfg = T.build_model({"preset": "flagship"}, device=dev, seed=0)
    rows = shard_batch(p21_batch(cfg, dev), mesh)
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn, mesh=mesh)
    state = trainer.init_state(model)
    params = dict(model.named_parameters())
    trainable = set(trainer.trainable)
    frozen = [n for n in params if n not in trainable]
    before = p21_fingerprint(params, frozen)
    # 21b's references first, not counted: the uniform step at step 1 (lr >
    # 0) on the dp route with FSDP2's grouping of the units' input
    # gradients and without it, each from the start with a new optimizer
    start = {n: params[n].detach().clone() for n in trainable}
    refs = {}
    for key in ("grouped", "dp"):
        with torch.no_grad():
            for n in trainable:
                params[n].copy_(start[n])
        trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                          loss.filter_fn, mesh=mesh)
        state = trainer.init_state(model)
        state.step = 1
        with (P21Grouping(model) if key == "grouped"
              else contextlib.nullcontext()), \
                P21Gradients(trainer, model) as spy:
            state, m = trainer.train_step(state, rows)
        refs[key] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "grads": {n: g.cpu() for n, g in spy.grads.items()},
                     "params": {n: params[n].detach().cpu()
                                for n in trainable}}
    with torch.no_grad():
        for n in trainable:
            params[n].copy_(start[n])
    del start, spy
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn, mesh=mesh)
    state = trainer.init_state(model)
    torch.cuda.reset_peak_memory_stats()
    dist.all_reduce = timed_all_reduce
    steps = []
    try:
        for sel in ("uniform", "tgb"):
            loss.selection = sel
            state, rec = p21_step(f"21a rank {rank} {sel} step", trainer,
                                  state, rows, sel == "tgb", timer)
            steps.append(rec)
    finally:
        dist.all_reduce = real_all_reduce
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cand = torch.cat(gather_objects(loss.cand.cpu()))
    flat = torch.cat([params[n].detach().reshape(-1).view(torch.int32)
                      for n in trainer.trainable])
    lo, hi = flat.clone(), flat
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    log(f"{tag}: 21a steps {[(r['loss'], r['grad_norm']) for r in steps]}")
    out["ddp"] = {"steps": steps, "peak_gib": peak, "cand": cand,
                  "route": trainer.route, "step_route": trainer.step_route,
                  "identical": bool(torch.equal(lo, hi)),
                  "frozen_same": bool(torch.equal(
                      before, p21_fingerprint(params, frozen))),
                  "n_trainable": len(trainable), "n_frozen": len(frozen)}
    del model, trainer, state, params, flat, lo, hi, before, rows
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 21b: fsdp=2, the model handed unsharded to Trainer.init_state as
    # train.py hands it; one uniform step at step 1
    mesh = create_mesh(MeshConfig(dp=1, fsdp=2), device_type="cuda")
    model, cfg = T.build_model({"preset": "flagship"}, device=dev, seed=0)
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn, mesh=mesh)
    t = time.perf_counter()
    state = trainer.init_state(model)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t
    if trainer.route != "fsdp" or not is_sharded(model):
        fail(f"21b rank {rank}: init_state took the route {trainer.route}")
    state.step = 1
    torch.cuda.reset_peak_memory_stats()
    with P21Gradients(trainer, model) as spy:
        state, rec = p21_step(f"21b rank {rank} fsdp step", trainer, state,
                              shard_batch(p21_batch(cfg, dev), mesh), False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag}: 21b step {rec['loss']:.6f} {rec['grad_norm']:.6f} "
        f"{rec['wall_ms']:.2f} ms; gathering the gradients and parameters")
    grads = spy.whole()
    params = dict(model.named_parameters())
    full = {n: full_tensor(params[n]) for n in trainer.trainable}
    grouped = refs["grouped"]
    fsdp = {**rec, "peak_gib": peak, "shard_s": shard_s,
            "route": trainer.route, "step_route": trainer.step_route,
            "grouped_loss": grouped["loss"],
            "grouped_grad_norm": grouped["grad_norm"],
            "vs_grouped": p21_gap(grads, grouped["grads"]),
            "params_vs_grouped": p21_gap(full, grouped["params"],
                                         slack=P21_UPDATE_BITS),
            "vs_dp": p21_gap(grads, refs["dp"]["grads"]),
            "grouped_vs_dp": p21_gap(grouped["grads"], refs["dp"]["grads"]),
            "dp_loss": refs["dp"]["loss"],
            "dp_grad_norm": refs["dp"]["grad_norm"]}
    if rank == 0:
        want = torch.load(os.path.join(P21_DIR, "ref.pt"))
        fsdp.update(
            vs_world1=p21_gap(grads, want["grads"]),
            dp_vs_world1=p21_gap(refs["dp"]["grads"], want["grads"]),
            grouped_vs_world1=p21_gap(grouped["grads"], want["grads"]),
            params_vs_world1=p21_gap(full, want["params"]))
        del want
        for key in [k for k in fsdp if "vs_" in k]:
            log(f"{tag}: 21b {key}: {p21_gap_text(fsdp[key])}")
    out["fsdp"] = fsdp
    del model, trainer, state, params, full, grads, grouped, refs, spy
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 21c: a tiny world-2 FSDP checkpoint for a world-1 restore
    log(f"{tag}: 21c")
    model, cfg = T.build_model({"preset": "tiny"}, device=dev, seed=0)
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-3), loss,
                      loss.filter_fn, mesh=mesh)
    state = trainer.init_state(model)
    tiny = shard_batch(p21_tiny_batch(cfg, dev), mesh)
    for _ in range(2):
        state, _ = trainer.train_step(state, tiny)
    params = dict(model.named_parameters())
    held = {"params": {n: full_tensor(params[n]).cpu()
                       for n in trainer.trainable},
            "moments": {n: {k: full_tensor(
                state.optimizer.state[params[n]][k]).cpu()
                for k in ("exp_avg", "exp_avg_sq")}
                for n in trainer.trainable}}
    items = train_state_items(state)
    if rank == 0:
        CheckpointManager(CheckpointConfig(
            directory=os.path.join(P21_DIR, "ckpt"))).save(state.step, items)
        out["held"] = held
    barrier()
    return gather_objects(out)


def parallel_paths(card: str) -> tuple:
    """Phase 21 (see the module's docstring). Returns the launches of its
    counted runs and 21a's world-1 reference (its two steps' records and
    D's frames), which phase 23 holds its ranks to."""
    import shutil

    import torch

    from videotgb_torch import train as T
    from videotgb_torch.parallel.distributed import spawn
    from videotgb_torch.training.checkpoint import (
        CheckpointConfig, CheckpointManager, restore_into)
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    shutil.rmtree(P21_DIR, ignore_errors=True)
    os.makedirs(P21_DIR)
    dev = torch.device("cuda")
    totals: dict = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    # ---- the world-1 references, in this process, eager (the reference's
    # tgb step would otherwise be captured without an eager run of its own):
    # 21b's, the uniform step at step 1 (lr > 0) from the start, its
    # gradients and updated trainable parameters saved; then 21a's, a
    # uniform step then a tgb step from the start with a new optimizer
    model, cfg = T.build_model({"preset": "flagship"}, device=dev, seed=0)
    batch = p21_batch(cfg, dev)
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn)
    trainer._step = trainer._step.eager
    state = trainer.init_state(model)
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in trainer.trainable}
    state.step = 1
    with P21Gradients(trainer, model) as spy:
        state, ref_b = p21_step("21 world-1 step at step 1", trainer, state,
                                batch, False)
    add(ref_b["launches"])
    torch.save({"grads": {n: g.cpu() for n, g in spy.grads.items()},
                "params": {n: params[n].detach().cpu()
                           for n in trainer.trainable}},
               os.path.join(P21_DIR, "ref.pt"))
    log(f"  21 world 1 from the start at step 1: loss {ref_b['loss']:.6f}, "
        f"grad_norm {ref_b['grad_norm']:.6f}")
    with torch.no_grad():
        for n in trainer.trainable:
            params[n].copy_(start[n])
    del start, spy
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn)
    trainer._step = trainer._step.eager
    state = trainer.init_state(model)
    ref_a = []
    for sel in ("uniform", "tgb"):
        loss.selection = sel
        state, rec = p21_step(f"21 world-1 {sel} step", trainer, state,
                              batch, sel == "tgb")
        ref_a.append(rec)
        add(rec["launches"])
        log(f"  21 world 1, {sel} step: loss {rec['loss']:.6f}, grad_norm "
            f"{rec['grad_norm']:.6f}, {rec['wall_ms']:.2f} ms (eager)")
    cand_a = loss.cand.clone().cpu()
    del model, trainer, state, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the two ranks
    t = time.perf_counter()
    try:
        ranks = spawn(p21_rank, 2, "gloo", device_type="cuda",
                      device_ids=[0, 0], timeout_s=600)
    except Exception as e:  # noqa: BLE001 - a rank's failure fails the phase
        fail(f"phase 21: the ranks failed: {type(e).__name__}: {e}")
    log(f"  21: two gloo ranks on the one card ran in "
        f"{time.perf_counter() - t:.1f} s (start, builds and steps)")

    # 21a
    for r in ranks:
        d = r["ddp"]
        for i, (rec, want) in enumerate(zip(d["steps"], ref_a)):
            add(rec["launches"])
            for key in ("loss", "grad_norm"):
                rel = abs(rec[key] - want[key]) / abs(want[key])
                if rel > 1e-2:
                    fail(f"21a rank {r['rank']} step {i}: {key} "
                         f"{rec[key]} vs world 1 {want[key]} ({rel:.2e})")
            log(f"  21a rank {r['rank']} step {i}: loss {rec['loss']:.6f} "
                f"(world 1 {want['loss']:.6f}), grad_norm "
                f"{rec['grad_norm']:.6f} (world 1 {want['grad_norm']:.6f}); "
                f"launches {rec['launches']}; wall {rec['wall_ms']:.2f} ms, "
                f"{rec['allreduce_calls']} all-reduces {rec['allreduce_ms']:.2f}"
                f" ms ({rec['allreduce_ms'] / rec['wall_ms']:.1%} of the "
                f"step) on {card}")
        if not d["identical"]:
            fail(f"21a: trainable parameters differ across the ranks")
        if not d["frozen_same"]:
            fail(f"21a rank {r['rank']}: a frozen parameter changed")
        log(f"  21a rank {r['rank']}: route {d['route']} ({d['step_route']}); "
            f"peak memory {d['peak_gib']:.2f} GiB; {d['n_trainable']} "
            f"trainable tensors bit-identical across the ranks; "
            f"{d['n_frozen']} frozen tensors' fingerprints unchanged")
    cand = ranks[0]["ddp"]["cand"]
    if not torch.equal(cand, cand_a):
        fail(f"21a: D's frames at world 2 {cand.tolist()} != world 1's "
             f"{cand_a.tolist()}")
    log(f"  21a: D's frames at world 2 equal world 1's: {cand.tolist()}")

    # 21b
    for r in ranks:
        f = r["fsdp"]
        add(f["launches"])
        log(f"  21b rank {r['rank']}: route {f['route']} ({f['step_route']})"
            f"; not captured; init_state sharded the model in "
            f"{f['shard_s']:.2f} s; loss {f['loss']:.6f}, grad_norm "
            f"{f['grad_norm']:.6f}; launches {f['launches']}; wall "
            f"{f['wall_ms']:.2f} ms; peak memory {f['peak_gib']:.2f} GiB on "
            f"{card}")
        log(f"  21b rank {r['rank']}: gradients against the dp route's with "
            f"FSDP2's grouping: {p21_gap_text(f['vs_grouped'])}; updated "
            f"parameters (last bits of the entry plus four of lr): "
            f"{p21_gap_text(f['params_vs_grouped'])}; loss "
            f"{f['loss']!r} vs {f['grouped_loss']!r}, grad_norm "
            f"{f['grad_norm']!r} vs {f['grouped_grad_norm']!r}")
        log(f"  21b rank {r['rank']}: gradients against the plain dp "
            f"route's (loss {f['dp_loss']!r}, grad_norm "
            f"{f['dp_grad_norm']!r}): FSDP2 {p21_gap_text(f['vs_dp'])}; the "
            f"dp route with FSDP2's grouping "
            f"{p21_gap_text(f['grouped_vs_dp'])}")
        if f["route"] != "fsdp":
            fail(f"21b rank {r['rank']}: route {f['route']}")
        # the clip reads the norm of FSDP2's shards, summed in another
        # order: its last bit may differ, and with it the last bits of an
        # update (|update| <= lr) and the last bit of the updated entry
        if f["vs_grouped"]["unequal"] or f["params_vs_grouped"]["ulps"] > 1:
            fail(f"21b rank {r['rank']}: the FSDP2 step's gradients or "
                 f"updated parameters differ from the dp route's with "
                 f"FSDP2's grouping")
        if f["loss"] != f["grouped_loss"]:
            fail(f"21b rank {r['rank']}: loss {f['loss']!r} vs "
                 f"{f['grouped_loss']!r}")
        rel = (abs(f["grad_norm"] - f["grouped_grad_norm"])
               / f["grouped_grad_norm"])
        if rel > 1e-5:
            fail(f"21b rank {r['rank']}: grad_norm {f['grad_norm']!r} vs "
                 f"{f['grouped_grad_norm']!r} ({rel:.2e})")
        for key in ("loss", "grad_norm"):
            rel = abs(f[key] - ref_b[key]) / abs(ref_b[key])
            if rel > 1e-2:
                fail(f"21b rank {r['rank']}: {key} {f[key]} vs the unwrapped "
                     f"step's {ref_b[key]} ({rel:.2e})")
    f = ranks[0]["fsdp"]
    log(f"  21b against the unwrapped world-1 step: loss {f['loss']:.6f} vs "
        f"{ref_b['loss']:.6f}, grad_norm {f['grad_norm']:.6f} vs "
        f"{ref_b['grad_norm']:.6f}; gradients: FSDP2 "
        f"{p21_gap_text(f['vs_world1'])}; the dp route "
        f"{p21_gap_text(f['dp_vs_world1'])}; the dp route with FSDP2's "
        f"grouping {p21_gap_text(f['grouped_vs_world1'])}; updated "
        f"parameters: {p21_gap_text(f['params_vs_world1'])} (Adam's first "
        f"update moves an entry by about lr whatever its gradient's size)")

    # 21c
    held = ranks[0]["held"]
    model, cfg = T.build_model({"preset": "tiny"}, device=dev, seed=1)
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-3), loss,
                      loss.filter_fn)
    state = trainer.init_state(model)
    step = restore_into(CheckpointManager(CheckpointConfig(
        directory=os.path.join(P21_DIR, "ckpt"))).restore(), model,
        state.optimizer)
    params = dict(model.named_parameters())
    bad = [n for n in trainer.trainable
           if not torch.equal(params[n].detach().cpu(), held["params"][n])]
    bad += [f"{n}:{k}" for n in trainer.trainable for k in held["moments"][n]
            if not torch.equal(state.optimizer.state[params[n]][k].cpu(),
                               held["moments"][n][k])]
    if step != 2 or bad:
        fail(f"21c: restored step {step}; differ {bad[:5]}")
    log(f"  21c: a tiny world-2 FSDP checkpoint restored at world 1 (step "
        f"{step}): {len(trainer.trainable)} trainable parameters and their "
        f"Adam moments equal to what the ranks held")
    shutil.rmtree(P21_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return totals, {"steps": ref_a, "cand": cand_a}


# ------------------------------------ phase 22: tensor-parallel serving
# new tokens of 22a (and 22c) and of 22b: Vicuna's prefill takes kernel A
# from 75 new tokens on (96 x (96 + 75) > 128^2)
P22_NEW = {"blip2": 16, "instructblip": 80}
# the LLM's visual tokens and the first decode step's logits at tp=2 may
# differ from world 1's by at most this share of world 1's largest (the
# bound PERF.md set before the first run: bf16 sums in another order move
# them by a few hundredths of it; a wrong slice or a missing reduction by
# its size). The logits' bound holds only where one bf16 step on the LLM's
# inputs moves world 1's logits by less: random-weight Flan-T5-xl's
# unscaled attention turns bf16 rounding into O(1) logits
P22_LOGITS_SHARE = 0.125
P22_AGREE = 0.7  # the JAX package's own floor (test_sharded_inference.py)
P22_ENGINE = dict(preset="flagship", batch_size=4, flow_frames=4,
                  max_new_tokens=P22_NEW["blip2"])


def p22_args(backbone: str):
    from types import SimpleNamespace

    return SimpleNamespace(model_path="random:flagship", preset="flagship",
                           backbone=backbone, bf16_params=1)


def p22_expected(backbone: str, batches: int = 1) -> dict:
    """Launches of one request batch: RAFT's 20 lookups and kernel D's one
    selection, then the ViT-g's 39 flash forwards, and Vicuna's prefill's
    32 where it takes kernel A; 0 for every other kernel."""
    from videotgb_torch.models.videotgb import VideoTGBConfig
    from videotgb_torch.ops import kernels

    cfg = VideoTGBConfig.flagship(backbone)
    flash = cfg.vit.num_layers
    if backbone == "instructblip":
        flash += cfg.instructblip.llm.num_layers
    per = {"flash_fwd": flash, "corr_lookup": cfg.raft.iters,
           "select_frames": 1}
    return {**dict.fromkeys(kernels.LAUNCHES, 0),
            **{k: v * batches for k, v in per.items()}}


def p22_drive(model, backbone: str, timer=None) -> dict:
    """22a / 22b on ``model``: the 4 requests of ``vicuna_requests`` (64
    -token prompts right-padded from 40 to 64 real tokens, 4 flow pairs,
    32 candidate frames), RAFT's flow of their flow frames, then
    ``generate_blip2`` / ``generate_instructblip`` from a seeded generator,
    counted (every count set to 0 just before, read just after) and timed;
    then, not counted, the logits of the first decode step on the same
    seed: T5's decoder on its start token, LLaMA's prefill at each row's
    last prompt token."""
    import torch

    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops import kernels
    from videotgb_torch.ops.decode import DecodeConfig

    dev, cfg = model.device, model.config
    frames_u8, flow_u8, batch = vicuna_requests(cfg, dev, seed=22)
    llm = (cfg.instructblip.llm if backbone == "instructblip"
           else cfg.blip2.t5)
    dcfg = DecodeConfig(max_new_tokens=P22_NEW[backbone],
                        eos_token_id=llm.eos_token_id,
                        pad_token_id=llm.pad_token_id)
    mean = torch.tensor((0.48145466, 0.4578275, 0.40821073), device=dev)
    std = torch.tensor((0.26862954, 0.26130258, 0.27577711), device=dev)
    gen = torch.Generator(device=dev)
    generate = (V.generate_instructblip if backbone == "instructblip"
                else V.generate_blip2)
    if timer is not None:
        timer.update(ms=0.0, calls=0)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.inference_mode():
        full = dict(batch, flow=model.flow_features(flow_u8.float()),
                    frames=(frames_u8.float() / 255.0 - mean) / std)
        tokens, cand = generate(model, full, dcfg,
                                generator=gen.manual_seed(22))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    check_bodies(f"22 {backbone}", launches)
    comm = dict(timer or {})
    lm = model.model.language_model
    with torch.inference_mode():
        qf = {}
        if cfg.instruction_aware:
            qf = dict(qformer_input_ids=full["qformer_input_ids"],
                      qformer_attention_mask=full["qformer_attention_mask"])
        visual = model.encode_selected(full["frames"], cand, **qf)
        if backbone == "instructblip":
            embeds, mask = model.model.decoder_inputs(
                visual, full["question_ids"], full["question_mask"])
        else:
            embeds, mask = model.model.encoder_inputs(
                visual, full["question_ids"], full["question_mask"])

        def first_logits(x):
            if backbone == "instructblip":
                logits, _ = lm(inputs_embeds=x, attention_mask=mask)
                last = mask.sum(1).long() - 1
                return logits[torch.arange(logits.shape[0], device=dev),
                              last]
            start = torch.full((x.shape[0], 1), llm.decoder_start_token_id,
                               device=dev)
            return lm.decode(start, lm.encode(x, mask), mask)[0][:, 0]

        logits = first_logits(embeds)
        # the LLM's inputs moved by at most one bf16 step: how far rounding
        # alone moves these logits at world 1
        nudged = first_logits((embeds.float() * (1 + 2 ** -8)).to(
            embeds.dtype))
    return {"tokens": tokens.cpu(), "cand": cand.cpu(),
            "visual": visual.float().cpu(), "logits": logits.float().cpu(),
            "nudged": nudged.float().cpu(), "wall_ms": wall,
            "launches": launches, "comm_ms": comm.get("ms", 0.0),
            "comm_calls": comm.get("calls", 0)}


def p22_requests(cfg, n: int = 4) -> list:
    """``n`` engine requests from a seed: (frames (32, 224, 224, 3), flow
    frames (5, fs, fs, 3) uint8, a question)."""
    import numpy as np

    rng = np.random.default_rng(22)
    img, fs = cfg.vit.image_size, cfg.tgb.flow_size
    return [(rng.integers(0, 256, (cfg.num_frames, img, img, 3), np.uint8),
             rng.integers(0, 256, (P22_ENGINE["flow_frames"] + 1, fs, fs, 3),
                          np.uint8),
             f"what happens in clip {i} and who is there?")
            for i in range(n)]


class P22Flash:
    """Records the first call of ``flash_attention`` at each input
    signature (its inputs, copied) while it is installed; ``check`` then
    holds kernel A against its plain version on them."""

    def __init__(self):
        self.calls: dict = {}

    def __enter__(self):
        from videotgb_torch.models import common

        self._orig = real = common.flash_attention

        def record(q, k, v, bias=None, scale=None):
            key = (tuple(q.shape), tuple(k.shape),
                   None if bias is None else tuple(bias.shape), str(q.dtype))
            if key not in self.calls:
                self.calls[key] = [None if t is None else t.detach().clone()
                                   for t in (q, k, v, bias)] + [scale]
            return real(q, k, v, bias, scale)

        common.flash_attention = record
        return self

    def __exit__(self, *exc):
        from videotgb_torch.models import common

        common.flash_attention = self._orig

    def check(self, tag: str) -> dict:
        """{shape: max abs error} of kernel A against the plain version on
        each recorded call's inputs (bf16: 2e-2 + 2e-2 |ref|, phase 2's)."""
        from videotgb_torch.ops.attention import (dot_product_attention,
                                                  flash_attention)

        out = {}
        for key, (q, k, v, bias, scale) in self.calls.items():
            got = flash_attention(q, k, v, bias, scale)
            want = dot_product_attention(q, k, v, bias, scale)
            out[str(key[:3])] = check_close(
                f"{tag} kernel A at {key[0]} x {key[1]} (bias {key[2]})",
                got, want, 2e-2, 2e-2, "bf16 output rounding plus another "
                "f32 summation order")
        return out


def p22_rank() -> dict:
    """One rank of phase 22 (two gloo ranks on the one card, as phase
    21)."""
    import faulthandler

    import torch
    import torch.distributed as dist

    from videotgb_torch.evalsuite.inference import load_model
    from videotgb_torch.parallel.distributed import (barrier, gather_objects,
                                                     process_index)
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.serve import ServingEngine

    faulthandler.enable()
    rank = process_index()
    tag = f"  22 rank {rank}"
    timer = {"ms": 0.0, "calls": 0}
    real = {name: getattr(dist, name)
            for name in ("all_reduce", "all_gather_into_tensor")}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timer["ms"] += (time.perf_counter() - t) * 1e3
            timer["calls"] += 1
            return out
        return call

    def drive(model, backbone):
        for name, fn in real.items():
            setattr(dist, name, timed(fn))
        try:
            with P22Flash() as flash:
                got = p22_drive(model, backbone, timer)
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        want = p22_expected(backbone)
        if got["launches"] != want:
            fail(f"{tag} {backbone}: launches {got['launches']} != {want}")
        got["kernel_a"] = flash.check(f"{tag} {backbone}")
        got["ranks_tokens_equal"] = all(
            torch.equal(t, got["tokens"]) for t in gather_objects(
                got["tokens"]))
        log(f"{tag} {backbone}: launches {got['launches']}, wall "
            f"{got['wall_ms']:.2f} ms, {got['comm_calls']} tp collectives "
            f"{got['comm_ms']:.2f} ms")
        return got

    out = {"rank": rank}
    # ---- 22a and 22c on one engine's model: BLIP2-Flan-T5-xl at tp=2
    t = time.perf_counter()
    engine = ServingEngine("random:flagship", mesh="tp=2", **P22_ENGINE)
    torch.cuda.synchronize()
    out["engine_build_s"] = time.perf_counter() - t
    out["route"] = engine.route
    out["heads"] = engine.model.model.vision_model.layers[0].attn.num_heads
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    barrier()
    out["blip2"] = drive(engine.model, "blip2")

    batches, tokens = [], []
    host_batch, answer = engine.host_batch, engine._answer

    def record_batch(padded):
        batches.append(list(padded))
        return host_batch(padded)

    def record_answer():
        def run(*args, **kwargs):
            got = answer()(*args, **kwargs)
            tokens.append(got.cpu())
            return got
        return run

    engine.host_batch, engine._answer = record_batch, record_answer
    barrier()
    from videotgb_torch.ops import kernels

    kernels.reset_launches()
    t = time.perf_counter()
    replies = None
    if engine.leader:
        requests = p22_requests(engine.cfg)
        futures = [engine.submit(*r) for r in requests]
        replies = [f.result(timeout=600) for f in futures]
        engine.close()
        index = {id(r[0]): i for i, r in enumerate(requests)}
        batches = [[index[id(r.frames_u8)] for r in padded]
                   for padded in batches]
    else:
        engine.join(timeout=600)
        batches = [len(padded) for padded in batches]
    wall = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    check_bodies(f"22c rank {rank}", launches)
    want = p22_expected("blip2", len(batches))
    if launches != want:
        fail(f"{tag} 22c: launches {launches} != {want} ({len(batches)} "
             f"batches)")
    out["engine"] = {
        "batches": batches, "launches": launches, "wall_ms": wall,
        "replies": None if replies is None else [
            (r.answer, r.selected_frames, r.latency_ms) for r in replies],
        "tokens": tokens,
        "ranks_tokens_equal": all(
            len(t) == len(tokens) and all(torch.equal(a, b)
                                          for a, b in zip(t, tokens))
            for t in gather_objects(tokens))}
    log(f"{tag} 22c: {len(batches)} batch(es), launches {launches}, "
        f"{wall:.2f} ms")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 22b: InstructBLIP-Vicuna-7B at tp=2
    mesh = create_mesh(MeshConfig(dp=1, tp=2), serving=True)
    t = time.perf_counter()
    model, _ = load_model(p22_args("instructblip"), mesh=mesh)
    torch.cuda.synchronize()
    out["vicuna_build_s"] = time.perf_counter() - t
    out["vicuna_heads"] = model.model.language_model.layers[0].attn.num_heads
    barrier()
    out["instructblip"] = drive(model, "instructblip")
    out["vicuna_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    gc.collect()
    torch.cuda.empty_cache()
    barrier()
    return gather_objects(out)


def p22_compare(name, got, want, card) -> float:
    """Frames, logits, greedy agreement of one rank's 22a / 22b (or 23b)
    run against world 1's; returns the share of greedy tokens that
    agree."""
    import torch

    if not torch.equal(got["cand"], want["cand"]):
        fail(f"{name}: frames {got['cand'].tolist()} != world 1's "
             f"{want['cand'].tolist()}")
    gaps = {}
    for key in ("visual", "logits"):
        gaps[key] = (float((got[key] - want[key]).abs().max()),
                     float(want[key].abs().max()))
    vis, vis_scale = gaps["visual"]
    if not vis <= P22_LOGITS_SHARE * vis_scale:
        fail(f"{name}: the LLM's visual tokens (ViT-g, Q-Former and "
             f"projection on the rank) {vis:.4g} off world 1's, over "
             f"{P22_LOGITS_SHARE} of its largest {vis_scale:.4g}")
    gap, scale = gaps["logits"]
    floor = float((want["nudged"] - want["logits"]).abs().max())
    bound = P22_LOGITS_SHARE * scale
    if not gap <= bound and floor < bound:
        fail(f"{name}: first-step logits {gap:.4g} off world 1's, over "
             f"{P22_LOGITS_SHARE} of its largest {scale:.4g}, where one bf16 "
             f"step on the LLM's inputs moves world 1's by {floor:.4g}")
    agree = float((got["tokens"] == want["tokens"]).float().mean())
    log(f"  {name}: frames equal to world 1's {want['cand'].tolist()}; "
        f"visual tokens max |rank - world 1| {vis:.4g} ({vis / vis_scale:.4g}"
        f" of the largest, {vis_scale:.4g}); first-step logits {gap:.4g} "
        f"({gap / scale:.4g} of the largest, {scale:.4g}; bound "
        f"{P22_LOGITS_SHARE}{' held' if gap <= bound else ' not held'}; one "
        f"bf16 step on the LLM's inputs moves world 1's by {floor:.4g}, "
        f"{floor / scale:.4g} of it"
        + ("" if gap <= bound else ": rounding alone moves these logits past "
           "the bound") + f"); greedy tokens agree on {agree:.4f} of "
        f"{tuple(want['tokens'].shape)} (the JAX test's floor {P22_AGREE}); "
        f"world-1 wall {want['wall_ms']:.2f} ms (eager) on {card}")
    return agree


def tensor_parallel_paths(card: str) -> tuple:
    """Phase 22 (see the module's docstring). Returns the launches of the
    ranks' counted runs and its world-1 ``p22_drive`` runs by backbone,
    which phase 23 holds its ranks to."""
    import numpy as np
    import torch

    from types import SimpleNamespace

    from videotgb_torch.data.tokenizer import load_tokenizer
    from videotgb_torch.device import step_generator
    from videotgb_torch.evalsuite.inference import load_model
    from videotgb_torch.models import videotgb as V
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.parallel.distributed import spawn
    from videotgb_torch.serve import ServingEngine

    totals: dict = {}
    refs = {}
    # ---- the world-1 references, in this process (eager: the first call
    # of a signature); BLIP2 stays for 22c's reference after the ranks
    for backbone in ("instructblip", "blip2"):
        t = time.perf_counter()
        model, cfg = load_model(p22_args(backbone))
        torch.cuda.synchronize()
        log(f"  22 world 1: {backbone} built in {time.perf_counter() - t:.2f}"
            f" s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        refs[backbone] = p22_drive(model, backbone)
        if refs[backbone]["launches"] != p22_expected(backbone):
            fail(f"22 world 1 {backbone}: launches "
                 f"{refs[backbone]['launches']}")
        if backbone == "instructblip":
            del model
            gc.collect()
            torch.cuda.empty_cache()

    t = time.perf_counter()
    try:
        ranks = spawn(p22_rank, 2, "gloo", device_type="cuda",
                      device_ids=[0, 0], timeout_s=600)
    except Exception as e:  # noqa: BLE001 - a rank's failure fails the phase
        fail(f"phase 22: the ranks failed: {type(e).__name__}: {e}")
    log(f"  22: two gloo ranks on the one card ran in "
        f"{time.perf_counter() - t:.1f} s (start, builds, 22a-c)")

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    agree = {}
    for r in ranks:
        log(f"  22 rank {r['rank']}: route {r['route']!r}; ViT-g "
            f"{r['heads']} heads a layer, Vicuna {r['vicuna_heads']}; the "
            f"engine (its model sliced) built in {r['engine_build_s']:.2f} "
            f"s, Vicuna in {r['vicuna_build_s']:.2f} s; peak memory "
            f"{r['peak_gib']:.2f} / {r['vicuna_peak_gib']:.2f} GiB")
        if not r["route"].startswith("eager"):
            fail(f"22 rank {r['rank']}: a sliced engine took route "
                 f"{r['route']!r}")
        for backbone, label in (("blip2", "22a"), ("instructblip", "22b")):
            got = r[backbone]
            add(got["launches"])
            if not got["ranks_tokens_equal"]:
                fail(f"{label}: the ranks' tokens differ")
            agree[label] = p22_compare(f"{label} rank {r['rank']}", got,
                                       refs[backbone], card)
            share = got["comm_ms"] / got["wall_ms"]
            log(f"  {label} rank {r['rank']}: launches {got['launches']}; "
                f"wall {got['wall_ms']:.2f} ms, {got['comm_calls']} tp "
                f"collectives (gloo, through the host) {got['comm_ms']:.2f} "
                f"ms = {share:.1%} of it; tokens bit-identical across the "
                f"ranks; kernel A {got['kernel_a']} on {card}")
        e = r["engine"]
        add(e["launches"])
        if not e["ranks_tokens_equal"]:
            fail("22c: the ranks' tokens differ")
        log(f"  22c rank {r['rank']}: {len(e['batches'])} batch(es), "
            f"launches {e['launches']}, the burst in {e['wall_ms']:.2f} ms "
            f"on {card}")

    # ---- 22c against world 1: direct phase calls on each batch rank 0 saw,
    # with its step's generator
    e = ranks[0]["engine"]
    requests = p22_requests(cfg)
    tok = load_tokenizer(None)
    host = SimpleNamespace(device=model.device, tok=tok, sampler_tok=tok,
                           flow_frames=P22_ENGINE["flow_frames"],
                           text_len=64)
    dcfg = DecodeConfig(max_new_tokens=P22_NEW["blip2"],
                        eos_token_id=cfg.blip2.t5.eos_token_id,
                        pad_token_id=cfg.blip2.t5.pad_token_id)
    frames_want, same, total = {}, 0, 0
    with torch.inference_mode():
        for step, (idx, got_tokens) in enumerate(zip(e["batches"],
                                                     e["tokens"])):
            padded = [SimpleNamespace(flow_u8=requests[i][1],
                                      question=requests[i][2]) for i in idx]
            flow_u8, bd = ServingEngine.host_batch(host, padded)
            gen = step_generator(0, step, model.device)
            cand = V.select_phase_blip2.eager(
                model, flow_u8, bd, generator=gen, mode="fusion",
                rescale="minus1").cpu()
            sel = torch.from_numpy(np.stack([
                requests[i][0][cand[j].numpy()] for j, i in enumerate(idx)]))
            want_tokens = V.answer_phase_blip2.eager(
                model, sel.to(model.device), bd, dcfg, generator=gen).cpu()
            same += int((want_tokens == got_tokens).sum())
            total += want_tokens.numel()
            for j, i in enumerate(idx):
                frames_want.setdefault(i, cand[j].tolist())
    got_frames = {i: frames for i, (_, frames, _) in enumerate(e["replies"])}
    if got_frames != frames_want:
        fail(f"22c: the engine's frames {got_frames} != world 1's "
             f"{frames_want}")
    agree["22c"] = same / total
    lat = [r[2] for r in e["replies"]]
    log(f"  22c: {len(e['replies'])} replies through rank 0's submit in "
        f"{len(e['batches'])} batch(es) {e['batches']}; frames equal to "
        f"world 1's direct phase calls {frames_want}; greedy tokens agree "
        f"on {agree['22c']:.4f} of {total} (the JAX test's floor "
        f"{P22_AGREE}); latency {lat} ms on {card}")
    log(f"  22: greedy agreement with world 1 {agree}; gloo on one card "
        f"carries every tp collective through the host: these walls time "
        f"nothing an NCCL machine with a card per rank would")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return totals, refs


# ------------------------------------ phase 23: sequence parallelism
@contextlib.contextmanager
def timed_collectives(timers: dict, kinds: dict):
    """While entered, each ``torch.distributed`` function named in
    ``kinds`` (name -> a key of ``timers``) adds its synchronised wall
    (ms) and one call to ``timers[key]``."""
    import torch
    import torch.distributed as dist

    real = {name: getattr(dist, name) for name in kinds}

    def timed(fn, timer):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timer["ms"] += (time.perf_counter() - t) * 1e3
            timer["calls"] += 1
            return out
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(fn, timers[kinds[name]]))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


class P23FlashBwd:
    """Records the first call of kernel C's wrapper at each input signature
    (its inputs, copied) while installed; ``check`` then holds kernel C
    against its plain version on them."""

    def __init__(self):
        self.calls: dict = {}

    def __enter__(self):
        from videotgb_torch.ops import attention

        self._orig = real = attention.flash_backward_cuda

        def record(q, k, v, bias, g, scale, bias_needs_grad=True):
            key = (tuple(q.shape), tuple(k.shape),
                   None if bias is None else tuple(bias.shape),
                   bias_needs_grad)
            if key not in self.calls:
                self.calls[key] = [None if t is None else t.detach().clone()
                                   for t in (q, k, v, bias, g)] + [
                    scale, bias_needs_grad]
            return real(q, k, v, bias, g, scale, bias_needs_grad)

        attention.flash_backward_cuda = record
        return self

    def __exit__(self, *exc):
        from videotgb_torch.ops import attention

        attention.flash_backward_cuda = self._orig

    def check(self, tag: str) -> dict:
        """{shape: max abs error} of kernel C (dq, dk, dv, and the bias's
        gradient where asked) against its plain version on each recorded
        call's inputs (phase 5's tolerance)."""
        from videotgb_torch.ops.attention import (flash_backward_cuda,
                                                  flash_backward_reference)

        out = {}
        for key, (q, k, v, bias, g, scale, need) in self.calls.items():
            got = flash_backward_cuda(q, k, v, bias, g, scale, need)
            want = flash_backward_reference(q, k, v, bias, g, scale, need)
            err = 0.0
            for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
                if y is not None:
                    err = max(err, check_to_largest(
                        f"{tag} kernel C {name} at {key[0]} x {key[1]} "
                        f"(bias {key[2]})", x, y, 2e-2,
                        "ds and the gradients rounded to bf16, sums in "
                        "another order"))
            out[str(key[:3])] = err
        return out


def p23_world1(world1: dict) -> dict:
    """Phases 21 and 22's world-1 references, ``world1`` with what it
    lacks (phase 23 run alone) made here: "e2e", 21a's uniform and tgb
    steps from the start and D's frames; "serving", 22's ``p22_drive`` of
    BLIP2-Flan-T5-xl and InstructBLIP-Vicuna-7B."""
    import torch

    from videotgb_torch import train as T
    from videotgb_torch.evalsuite.inference import load_model
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    world1 = dict(world1)
    dev = torch.device("cuda")
    if "e2e" not in world1:
        model, cfg = T.build_model({"preset": "flagship"}, device=dev, seed=0)
        batch = p21_batch(cfg, dev)
        loss = P21Loss()
        trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                          loss.filter_fn)
        trainer._step = trainer._step.eager
        state = trainer.init_state(model)
        steps = []
        for sel in ("uniform", "tgb"):
            loss.selection = sel
            state, rec = p21_step(f"23 world-1 {sel} step", trainer, state,
                                  batch, sel == "tgb")
            steps.append(rec)
        world1["e2e"] = {"steps": steps, "cand": loss.cand.clone().cpu()}
        del model, trainer, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    if "serving" not in world1:
        refs = {}
        for backbone in ("blip2", "instructblip"):
            model, _ = load_model(p22_args(backbone))
            refs[backbone] = p22_drive(model, backbone)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        world1["serving"] = refs
    return world1


P23_TEXT = 160  # 23c's prompt: with 32 visual tokens, phase 17's IV length


def p23_vicuna(model, visual, tag, timing, timer) -> dict:
    """23c on the rank's split InstructBLIP-Vicuna ``model``: Vicuna's
    forward without caches on 23b's ``visual`` tokens and a right-padded
    160-token prompt, and the backward to its input embeddings (the
    weights take no gradient), counted; the loss is the logits' sum
    against a seeded vector, each rank's 1/sp of it and the embeddings'
    gradient summed over the sp ranks, as the trainer's rule. Then on the
    rank, its LLM's ``sp`` set aside: the same whole (the reference), and
    whole once more on inputs moved by one bf16 step (how far rounding
    alone moves it). Kernels A and C held against their plain versions on
    the split run's recorded inputs."""
    import torch
    import torch.distributed as dist

    from videotgb_torch.ops import kernels

    dev, cfg = model.device, model.config
    lm, llm = model.model.language_model, cfg.instructblip.llm
    sp, b = lm.sp, visual.shape[0]
    gen = torch.Generator(device=dev).manual_seed(23)
    ids = torch.randint(100, 5000, (b, P23_TEXT), generator=gen, device=dev)
    lengths = P23_TEXT - 20 * torch.arange(b, device=dev)
    text_mask = (torch.arange(P23_TEXT, device=dev)[None]
                 < lengths[:, None]).float()
    with torch.no_grad():
        embeds, mask = model.model.decoder_inputs(
            visual.to(dev, torch.bfloat16), ids, text_mask)
    w = torch.randn(llm.vocab_size, generator=gen, device=dev)

    def run(x, share=1.0):
        x = x.detach().clone().requires_grad_()
        logits, _ = lm(inputs_embeds=x, attention_mask=mask)
        (dx,) = torch.autograd.grad(((logits @ w) * mask).sum() * share, [x])
        return logits.detach().float(), dx

    s = embeds.shape[1]
    local = s // sp.size
    shapes = [str(((b, llm.num_heads, local, llm.head_dim),
                   (b, llm.num_heads, s, llm.head_dim), (b, 1, local, s)))]
    timer.update(ms=0.0, calls=0)
    kernels.reset_launches()
    with P22Flash() as fa, P23FlashBwd() as fc, timing():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, dx = run(embeds, 1.0 / sp.size)
        dx = dx.float()
        dist.all_reduce(dx, group=sp.group)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    check_bodies(f"{tag} 23c", launches)
    want = {**dict.fromkeys(kernels.LAUNCHES, 0),
            "flash_fwd": llm.num_layers, "flash_bwd": llm.num_layers}
    if launches != want:
        fail(f"{tag} 23c: launches {launches} != {want}")
    got_a = sorted(str(k[:3]) for k in fa.calls)
    got_c = sorted(str(k[:3]) for k in fc.calls)
    if got_a != shapes or got_c != shapes:
        fail(f"{tag} 23c: kernels A and C saw {got_a} and {got_c}, not the "
             f"split Vicuna's {shapes}")
    out = {"launches": launches, "wall_ms": wall, "sp_ms": timer["ms"],
           "sp_calls": timer["calls"], "shape": shapes[0],
           "kernel_a": fa.check(f"{tag} 23c"),
           "kernel_c": fc.check(f"{tag} 23c")}
    lm.sp = None
    try:
        whole = run(embeds)
        nudged = run((embeds.float() * (1 + 2 ** -8)).to(embeds.dtype))
    finally:
        lm.sp = sp
    for name, got, ref, moved in (("logits", logits, whole[0], nudged[0]),
                                  ("dx", dx, whole[1], nudged[1])):
        gap = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        floor = float((moved.float() - ref.float()).abs().max())
        bound = P22_LOGITS_SHARE * scale
        if not gap <= bound and floor < bound:
            fail(f"{tag} 23c: split {name} {gap:.4g} off the whole "
                 f"forward's, over {P22_LOGITS_SHARE} of its largest "
                 f"{scale:.4g}, where one bf16 step on the inputs moves it "
                 f"by {floor:.4g}")
        out[name] = {"gap": gap, "scale": scale, "floor": floor}
    return out


def p23_rank() -> dict:
    """One rank of phase 23 (two gloo ranks on the one card at sp=2, as
    phases 21 and 22)."""
    import faulthandler

    import torch
    import torch.distributed as dist

    from videotgb_torch import train as T
    from videotgb_torch.evalsuite.inference import load_model
    from videotgb_torch.parallel.distributed import (barrier, gather_objects,
                                                     process_index)
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.parallel.sequence import is_split
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    faulthandler.enable()
    rank, dev = process_index(), torch.device("cuda", 0)
    tag = f"  23 rank {rank}"

    # gloo's token collectives on bf16 CUDA tensors, before anything else
    g = torch.empty(8, dtype=torch.bfloat16, device=dev)
    dist.all_gather_into_tensor(g, torch.full((4,), float(rank), device=dev,
                                              dtype=torch.bfloat16))
    r = torch.empty(2, dtype=torch.bfloat16, device=dev)
    dist.reduce_scatter_tensor(r, torch.arange(4.0, device=dev).to(
        torch.bfloat16))
    if not (g.tolist() == [0.0] * 4 + [1.0] * 4
            and r.tolist() == [4.0 * rank, 4.0 * rank + 2.0]):
        fail(f"{tag}: gloo on bf16 CUDA tensors gave {g.tolist()}, "
             f"{r.tolist()}")

    # the sp collectives (the token gathers and their reduce-scatters) and
    # the all-reduces (gradients, counts, losses), each timed apart
    timers = {"sp": {"ms": 0.0, "calls": 0}, "ar": {"ms": 0.0, "calls": 0}}
    timing = functools.partial(timed_collectives, timers, {
        "all_gather_into_tensor": "sp", "reduce_scatter_tensor": "sp",
        "all_reduce": "ar"})

    out = {"rank": rank}
    # ---- 23a: E2E on configs/trainer/sp.yaml's layout at 2 ranks (dp 1,
    # sp 2), a global batch of 8: a uniform step, then a tgb step
    mesh = create_mesh(MeshConfig(dp=1, sp=2), device_type="cuda")
    model, cfg = T.build_model({"preset": "flagship"}, device=dev, seed=0)
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn, mesh=mesh)
    state = trainer.init_state(model)
    if not is_split(model):
        fail(f"{tag}: Trainer.init_state did not split the model over sp")
    params = dict(model.named_parameters())
    trainable = set(trainer.trainable)
    frozen = [n for n in params if n not in trainable]
    before = p21_fingerprint(params, frozen)
    rows = p21_batch(cfg, dev)  # dp = 1: every rank holds the 8 rows
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with P22Flash() as fa, P23FlashBwd() as fc:
        for sel in ("uniform", "tgb"):
            loss.selection = sel
            for timer in timers.values():
                timer.update(ms=0.0, calls=0)
            with timing():
                state, rec = p21_step(f"23a rank {rank} {sel} step",
                                      trainer, state, rows, sel == "tgb")
            rec.update(sp_ms=timers["sp"]["ms"], sp_calls=timers["sp"][
                "calls"], ar_ms=timers["ar"]["ms"],
                ar_calls=timers["ar"]["calls"])
            steps.append(rec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flat = torch.cat([params[n].detach().reshape(-1).view(torch.int32)
                      for n in trainer.trainable])
    lo, hi = flat.clone(), flat
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    out["e2e"] = {
        "steps": steps, "peak_gib": peak, "cand": loss.cand.cpu(),
        "route": trainer.route, "step_route": trainer.step_route,
        "identical": bool(torch.equal(lo, hi)),
        "frozen_same": bool(torch.equal(before,
                                        p21_fingerprint(params, frozen))),
        "kernel_a": fa.check(f"{tag} 23a"), "kernel_c": fc.check(
            f"{tag} 23a"),
        "a_shapes": sorted(str(k[:3]) for k in fa.calls),
        "c_shapes": sorted(str(k[:3]) for k in fc.calls)}
    log(f"{tag}: 23a steps {[(r['loss'], r['grad_norm']) for r in steps]}")
    del model, trainer, state, params, flat, lo, hi, before, rows, fa, fc
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 23b: serving at sp=2, phase 22's requests and tokens
    mesh = create_mesh(MeshConfig(dp=1, sp=2), serving=True)
    for backbone in ("blip2", "instructblip"):
        model, _ = load_model(p22_args(backbone), mesh=mesh)
        if not is_split(model):
            fail(f"{tag}: load_model did not split {backbone} over sp")
        barrier()
        for timer in timers.values():
            timer.update(ms=0.0, calls=0)
        with P22Flash() as fa, timing():
            got = p22_drive(model, backbone, timers["sp"])
        want = p22_expected(backbone)
        if got["launches"] != want:
            fail(f"{tag} 23b {backbone}: launches {got['launches']} != "
                 f"{want}")
        got["kernel_a"] = fa.check(f"{tag} 23b {backbone}")
        got["a_shapes"] = sorted(str(k[:3]) for k in fa.calls)
        got["ranks_tokens_equal"] = all(
            torch.equal(t, got["tokens"]) for t in gather_objects(
                got["tokens"]))
        out[backbone] = got
        log(f"{tag} 23b {backbone}: launches {got['launches']}, wall "
            f"{got['wall_ms']:.2f} ms, {got['comm_calls']} sp collectives "
            f"{got['comm_ms']:.2f} ms")
        if backbone == "instructblip":
            barrier()
            out["vicuna"] = p23_vicuna(model, got["visual"], tag, timing,
                                       timers["sp"])
        del model, fa
        gc.collect()
        torch.cuda.empty_cache()
    barrier()
    return gather_objects(out)


def sequence_parallel_paths(card: str, world1: dict) -> tuple:
    """Phase 23 (see the module's docstring), held to ``world1``, phases
    21 and 22's references ("e2e", "serving"; :func:`p23_world1` makes
    those missing). Returns the launches of the ranks' counted runs and
    kernels A's and C's device times at the split T5-xl encoder's
    shape."""
    import torch

    from videotgb_torch.ops.attention import NEG_INF
    from videotgb_torch.parallel.distributed import spawn

    world1 = p23_world1(world1)
    totals: dict = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    t = time.perf_counter()
    try:
        ranks = spawn(p23_rank, 2, "gloo", device_type="cuda",
                      device_ids=[0, 0], timeout_s=600)
    except Exception as e:  # noqa: BLE001 - a rank's failure fails the phase
        fail(f"phase 23: the ranks failed: {type(e).__name__}: {e}")
    log(f"  23: two gloo ranks on the one card at sp=2 ran in "
        f"{time.perf_counter() - t:.1f} s (start, builds, 23a-c)")

    # 23a
    ref = world1["e2e"]
    for r in ranks:
        d = r["e2e"]
        for i, (rec, want) in enumerate(zip(d["steps"], ref["steps"])):
            add(rec["launches"])
            for key in ("loss", "grad_norm"):
                rel = abs(rec[key] - want[key]) / abs(want[key])
                if rel > 1e-2:
                    fail(f"23a rank {r['rank']} step {i}: {key} "
                         f"{rec[key]} vs world 1 {want[key]} ({rel:.2e})")
            log(f"  23a rank {r['rank']} step {i}: loss {rec['loss']:.6f} "
                f"(world 1 {want['loss']:.6f}), grad_norm "
                f"{rec['grad_norm']:.6f} (world 1 {want['grad_norm']:.6f}); "
                f"launches {rec['launches']}; wall {rec['wall_ms']:.2f} ms, "
                f"{rec['sp_calls']} sp collectives {rec['sp_ms']:.2f} ms "
                f"({rec['sp_ms'] / rec['wall_ms']:.1%} of the step), "
                f"{rec['ar_calls']} all-reduces {rec['ar_ms']:.2f} ms "
                f"({rec['ar_ms'] / rec['wall_ms']:.1%}) on {card}")
        if not d["identical"]:
            fail("23a: trainable parameters differ across the ranks")
        if not d["frozen_same"]:
            fail(f"23a rank {r['rank']}: a frozen parameter changed")
        if "((8, 32, 80, 64), (8, 32, 160, 64), (8, 32, 80, 160))" not in (
                d["a_shapes"]) or d["c_shapes"] != [
                "((8, 32, 80, 64), (8, 32, 160, 64), (8, 32, 80, 160))"]:
            fail(f"23a rank {r['rank']}: kernels A and C saw {d['a_shapes']}"
                 f" and {d['c_shapes']}, not the split T5-xl encoder's")
        log(f"  23a rank {r['rank']}: route {d['route']} ({d['step_route']})"
            f"; peak memory {d['peak_gib']:.2f} GiB; kernel A "
            f"{d['kernel_a']}, kernel C {d['kernel_c']} on the recorded "
            f"inputs; trainable tensors bit-identical across the ranks; "
            f"frozen fingerprints unchanged")
    cand = ranks[0]["e2e"]["cand"]
    if not torch.equal(cand, ref["cand"]):
        fail(f"23a: D's frames at sp=2 {cand.tolist()} != world 1's "
             f"{ref['cand'].tolist()}")
    log(f"  23a: D's frames at sp=2 equal world 1's: {cand.tolist()}")

    # 23b
    agree = {}
    for r in ranks:
        for backbone in ("blip2", "instructblip"):
            got = r[backbone]
            add(got["launches"])
            if not got["ranks_tokens_equal"]:
                fail(f"23b {backbone}: the ranks' tokens differ")
            agree[backbone] = p22_compare(
                f"23b {backbone} rank {r['rank']}", got,
                world1["serving"][backbone], card)
            share = got["comm_ms"] / got["wall_ms"]
            log(f"  23b {backbone} rank {r['rank']}: launches "
                f"{got['launches']}; wall {got['wall_ms']:.2f} ms, "
                f"{got['comm_calls']} sp collectives (gloo, through the "
                f"host) {got['comm_ms']:.2f} ms = {share:.1%} of it; tokens "
                f"bit-identical across the ranks; kernel A at "
                f"{got['a_shapes']}: {got['kernel_a']} on {card}")
    # 23c
    for r in ranks:
        d = r["vicuna"]
        add(d["launches"])
        log(f"  23c rank {r['rank']}: Vicuna without caches, split: launches "
            f"{d['launches']}; kernels A and C at {d['shape']}: A "
            f"{d['kernel_a']}, C {d['kernel_c']} on the recorded inputs; "
            + "; ".join(
                f"{k} max |split - whole| {d[k]['gap']:.4g} ({d[k]['gap'] / d[k]['scale']:.4g} of the largest, "
                f"{d[k]['scale']:.4g}; one bf16 step on the inputs moves the "
                f"whole forward's by {d[k]['floor']:.4g})"
                for k in ("logits", "dx"))
            + f"; wall {d['wall_ms']:.2f} ms, {d['sp_calls']} sp collectives "
            f"{d['sp_ms']:.2f} ms ({d['sp_ms'] / d['wall_ms']:.1%}) on {card}")
    log(f"  23: greedy agreement with world 1 {agree}; gloo on one card "
        f"carries every sp collective through the host: these walls time "
        f"nothing an NCCL machine with a card per rank would")

    # kernels A and C at the split T5-xl encoder's shape: a rank's 80
    # queries over the 160 keys, its rows of the relative-position bias
    # plus the padding, one (8, 32, 80, 160) f32 bias
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    keys = torch.arange(160, device=dev)
    lens = torch.randint(120, 161, (8,), generator=gen, device=dev)
    bias = (torch.randn((1, 32, 80, 160), generator=gen, device=dev)
            + torch.where(keys[None] < lens[:, None], 0.0,
                          NEG_INF).float()[:, None, None])
    q, k, v = (torch.randn((8, s, 32, 64), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2) for s in (80, 160, 160))
    a_row = flash_timed(card, "23 split T5-xl encoder (8,32,80,160,64) "
                        "bias (8,32,80,160)", (q, k, v), bias)
    c_row = c_at(card, "23 split T5-xl encoder", 8, 32, 80, 160, 64, bias,
                 False)
    return totals, {"a": a_row, "c": c_row}


P24_HOP = (4, 160, 2048)  # a T5-xl encoder microbatch's activation
P24_LR = 1e-3  # 24b's update of the stage leaves


def P24_LEAVES(first: int, per: int) -> tuple:
    """24b's stage leaves of the stage whose layers start at ``first``: its
    first attention query and its last MLP down projection."""
    return ((first, "attn.q"), (first + per - 1, "down_proj"))


def p24_probe(pp, tag: str) -> dict:
    """The pipeline's hop before anything else: gloo's
    ``all_gather_into_tensor`` on bf16 and f32 CUDA tensors, then
    ``parallel.pipeline._hop`` (the ring permute built from it) handing each
    rank its predecessor's block forward and its successor's backward;
    then the hop timed at a T5-xl microbatch's activation."""
    import torch

    from videotgb_torch.parallel.pipeline import _hop

    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.full((2, 3), float(pp.rank), device=dev, dtype=dtype)
        for shift in (1, -1):
            got = _hop(x, pp, shift)
            want = float((pp.rank - shift) % pp.size)
            if got.device != dev or not bool((got == want).all()):
                fail(f"{tag}: the hop (shift {shift}, {dtype}) gave "
                     f"{got.tolist()} on {got.device}, not rank "
                     f"{want:.0f}'s block")
    x = torch.randn(P24_HOP, device=dev).to(torch.bfloat16)
    for _ in range(3):
        _hop(x, pp, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        _hop(x, pp, 1)
    torch.cuda.synchronize()
    return {"hop_ms": (time.perf_counter() - t) * 1e2,
            "hop_mb": x.numel() * x.element_size() / 1e6}


def p24_vicuna(mesh, tag, timing, timers) -> dict:
    """24b on the rank: Vicuna-7B (32 layers, bf16, random weights from a
    seed) with ``scan_layers``, forward without caches on 4 rows of 192
    tokens (23c's length: 32 stand-in visual tokens and a right-padded
    160-token prompt) and the backward to its input embeddings and to the
    first attention query and last MLP down projection of each stage
    (``P24_LEAVES``); first whole on the rank (the reference; once more on
    inputs moved by one bf16 step, the floor; and on each 2-row
    microbatch, whose summed layer gradients take the staged backward's
    shapes and order), then staged over pp=2 (16 layers a stage, 2
    microbatches of 2 rows), each rank's loss 1/pp of it and the
    embeddings' gradient summed over the pp ranks. Then one update of the
    rank's stage leaves among ``P24_LEAVES`` (``make_optimizer`` /
    ``optimizer_step``, the norm's squares summed over the pp group): the
    norm against the reference gradients', the leaves against AdamW on
    their staged gradients clipped by that norm. Kernels A and C held
    against their plain versions on the staged run's recorded inputs."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from videotgb_torch.models.common import init_params
    from videotgb_torch.models.llama import LlamaConfig, LlamaModel
    from videotgb_torch.ops import kernels
    from videotgb_torch.parallel.mesh import pp_rank
    from videotgb_torch.parallel.pipeline import held, shard_pp
    from videotgb_torch.training.optim import (B1, B2, EPS, make_optimizer,
                                               optimizer_step)

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(LlamaConfig.vicuna_7b(), scan_layers=True,
                              param_dtype=torch.bfloat16)
    lm = init_params(LlamaModel(cfg, device=dev), 24)
    gen = torch.Generator(device=dev).manual_seed(24)
    b, s = 4, 32 + P23_TEXT
    ids = torch.randint(100, 5000, (b, s), generator=gen, device=dev)
    lengths = P23_TEXT - 20 * torch.arange(b, device=dev)
    text = (torch.arange(P23_TEXT, device=dev)[None]
            < lengths[:, None]).float()
    mask = torch.cat([torch.ones((b, 32), device=dev), text], 1)
    with torch.no_grad():
        embeds = lm.embed(ids)
    w = torch.randn(cfg.vocab_size, generator=gen, device=dev)
    per = cfg.num_layers // pp_rank(mesh)[1]
    leaves = [f"layers.{i}.{leaf}.weight" for first in range(
        0, cfg.num_layers, per) for i, leaf in P24_LEAVES(first, per)]
    named = dict(lm.named_parameters())
    for n in leaves:  # the other parameters take no gradient
        named[n].requires_grad_()

    def run(x, share=1.0, names=leaves, rows=slice(None)):
        x = x[rows].detach().clone().requires_grad_()
        logits, _ = lm(inputs_embeds=x, attention_mask=mask[rows])
        dx, *dw = torch.autograd.grad(
            ((logits @ w) * mask[rows]).sum() * share,
            [x, *(named[n] for n in names)])
        return logits.detach().float(), dx.float(), dict(zip(names, dw))

    whole = run(embeds)
    nudged = run((embeds.float() * (1 + 2 ** -8)).to(embeds.dtype))
    micro = [run(embeds, rows=slice(i, i + 2))[2] for i in (0, 2)]
    micro = {n: micro[0][n] + micro[1][n] for n in leaves}
    shard_pp(lm, mesh)
    pp = lm.pp
    layers = sorted({int(n.split(".")[1]) for n, p in lm.named_parameters()
                     if n.startswith("layers.") and p.numel()})
    if layers != list(pp.stage(cfg.num_layers)):
        fail(f"{tag} 24b: the rank holds layers {layers}, not its stage's")
    shapes = [str(((2, 32, s, 128), (2, 32, s, 128), (2, 1, s, s)))]
    for timer in timers.values():
        timer.update(ms=0.0, calls=0)
    kernels.reset_launches()
    with P22Flash() as fa, P23FlashBwd() as fc, timing():
        torch.cuda.synchronize()
        t = time.perf_counter()
        mine = [n for n in leaves if held(named[n])]
        logits, dx, dw = run(embeds, 1.0 / pp.size, mine)
        dist.all_reduce(dx, group=pp.group)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    check_bodies(f"{tag} 24b", launches)
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "flash_fwd": 32,
            "flash_bwd": 32}
    if launches != want:
        fail(f"{tag} 24b: launches {launches} != {want}")
    got_a = sorted(str(k[:3]) for k in fa.calls)
    got_c = sorted(str(k[:3]) for k in fc.calls)
    if got_a != shapes or got_c != shapes:
        fail(f"{tag} 24b: kernels A and C saw {got_a} and {got_c}, not the "
             f"Vicuna stage's {shapes}")
    if dict(pp.calls) != {"staged": 1}:
        fail(f"{tag} 24b: the stack's routes {dict(pp.calls)}")
    out = {"launches": launches, "wall_ms": wall, "shape": shapes[0],
           "hop_ms": timers["hop"]["ms"], "hop_calls": timers["hop"]["calls"],
           "ar_ms": timers["ar"]["ms"], "ar_calls": timers["ar"]["calls"],
           "kernel_a": fa.check(f"{tag} 24b"),
           "kernel_c": fc.check(f"{tag} 24b")}
    if mine != leaves[2 * pp.rank:2 * pp.rank + 2]:
        fail(f"{tag} 24b: the rank holds {mine} of {leaves}")
    # a microbatch's rows take the whole batch's arithmetic (PERF.md, PR
    # 22: bit-identical), so the bound is the floor, not a share
    for name, got, ref, moved, base in (
            ("logits", logits, whole[0], nudged[0], whole[0]),
            ("dx", dx, whole[1], nudged[1], whole[1]),
            *((n, dw[n], micro[n], nudged[2][n], whole[2][n])
              for n in mine)):
        gap = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        floor = float((moved.float() - base.float()).abs().max())
        if not gap <= floor:
            fail(f"{tag} 24b: staged {name} {gap:.4g} off the reference "
                 f"(largest {scale:.4g}), over the {floor:.4g} that one bf16 "
                 f"step on the inputs moves the whole forward's")
        out[name] = {"gap": gap, "scale": scale, "floor": floor}

    # one update of the stage leaves: the optimizer holds the rank's alone
    optimizer, names = make_optimizer(lm, filter_fn=set(leaves).__contains__)
    if (names != mine or optimizer.stage_group is not pp.group
            or not all(named[n].numel() == 0
                       for n in leaves if n not in mine)):
        fail(f"{tag} 24b: the optimizer holds {names}, not {mine}, or "
             f"sums its norm over another group")
    # the norm's reference: each stage's leaf norm (bf16, as
    # get_total_norm gives it) squared and summed over the stages, on the
    # reference gradients (within the floor of the staged ones above, so a
    # stage norm may round to the next bf16 step); the update's: AdamW on
    # the staged gradients, clipped by the norm the step took
    lr = torch.full((), P24_LR, dtype=torch.float32, device=dev)
    want_norm = float(torch.stack([torch.nn.utils.get_total_norm(
        [micro[n] for n in leaves[2 * k:2 * k + 2]]).float() ** 2
        for k in range(pp.size)]).sum().sqrt())
    ref = [named[n].detach().clone() for n in mine]
    for p, n in zip(ref, mine):
        p.grad = dw[n].clone()
        named[n].grad = dw[n]
    norm = optimizer_step(optimizer, lr, 1.0)
    torch.nn.utils.clip_grads_with_norm_(ref, 1.0, norm)
    torch.optim.AdamW(ref, lr=lr, betas=(B1, B2), eps=EPS, weight_decay=0.0,
                      fused=True, capturable=True).step()
    norm = float(norm)
    off = [float((named[n].detach().float() - p.float()).abs().max())
           for n, p in zip(mine, ref)]
    if (abs(norm - want_norm) > 2 ** -6 * want_norm or max(off) > 0
            or len(optimizer.state) != len(mine)):
        fail(f"{tag} 24b: the staged update's norm {norm!r} (want "
             f"{want_norm!r}), its leaves {off} off AdamW's on their "
             f"gradients, {len(optimizer.state)} moments; the gradients "
             f"{[(n, out[n]['gap'], out[n]['floor']) for n in mine]} off "
             f"the reference (gap, floor)")
    out["update"] = {"norm": norm, "want_norm": want_norm, "leaves": mine,
                     "off": off}
    return out


def p24_rank() -> dict:
    """One rank of phase 24 (two gloo ranks on the one card at pp=2, as
    phases 21-23)."""
    import dataclasses
    import faulthandler

    import torch
    import torch.distributed as dist

    from videotgb_torch.models.videotgb import VideoTGB, VideoTGBConfig
    from videotgb_torch.parallel.distributed import gather_objects
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh, pp_rank
    from videotgb_torch.parallel.pipeline import PPGroup, stage_leaf
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    faulthandler.enable()
    mesh = create_mesh(MeshConfig(dp=1, pp=2), device_type="cuda")
    rank, size = pp_rank(mesh)
    tag = f"  24 rank {rank}"
    out = {"rank": rank, **p24_probe(PPGroup(rank, size,
                                             mesh.get_group("pp")), tag)}

    # the hops (all_gather_into_tensor) and the all-reduces (the delivered
    # output, the output's gradient, gradients, counts, losses) timed apart
    timers = {"hop": {"ms": 0.0, "calls": 0}, "ar": {"ms": 0.0, "calls": 0}}
    timing = functools.partial(timed_collectives, timers, {
        "all_gather_into_tensor": "hop", "all_reduce": "ar"})

    # ---- 24a: E2E with the T5 tower's scan_layers, a global batch of 8
    # (dp 1: every rank holds the 8 rows), a uniform step then a tgb step
    dev = torch.device("cuda", 0)
    cfg = VideoTGBConfig.flagship("blip2")
    cfg = dataclasses.replace(cfg, blip2=dataclasses.replace(
        cfg.blip2, t5=dataclasses.replace(cfg.blip2.t5, scan_layers=True)))
    model = VideoTGB(cfg, device=dev, seed=0)
    whole_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    loss = P21Loss()
    trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                      loss.filter_fn, mesh=mesh)
    state = trainer.init_state(model)
    t5 = model.model.language_model
    if trainer.route != "pp" or t5.pp is None:
        fail(f"{tag}: Trainer.init_state did not stage the T5 tower "
             f"(route {trainer.route})")
    params = dict(model.named_parameters())
    held = {stack: sorted({int(n.split(f".{stack}.")[1].split(".")[0])
                           for n, p in params.items()
                           if f".{stack}." in n and p.numel()})
            for stack in ("encoder_blocks", "decoder_blocks")}
    for stack, layers in held.items():
        if layers != list(t5.pp.stage(24)):
            fail(f"{tag}: holds {stack} {layers}, not its stage's 12")
    rank_bytes = sum(p.numel() * p.element_size() for p in params.values())
    trainable = set(trainer.trainable)
    if any(stage_leaf(params[n]) for n in trainable):
        fail(f"{tag}: a stage leaf trains in E2E")
    frozen = [n for n in params if n not in trainable and params[n].numel()]
    before = p21_fingerprint(params, frozen)
    rows = p21_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with P22Flash() as fa, P23FlashBwd() as fc:
        for sel in ("uniform", "tgb"):
            loss.selection = sel
            for timer in timers.values():
                timer.update(ms=0.0, calls=0)
            with timing():
                state, rec = p21_step(f"24a rank {rank} {sel} step",
                                      trainer, state, rows, sel == "tgb")
            rec.update(hop_ms=timers["hop"]["ms"],
                       hop_calls=timers["hop"]["calls"],
                       ar_ms=timers["ar"]["ms"],
                       ar_calls=timers["ar"]["calls"])
            steps.append(rec)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flat = torch.cat([params[n].detach().reshape(-1).view(torch.int32)
                      for n in trainer.trainable])
    lo, hi = flat.clone(), flat
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    out["e2e"] = {
        "steps": steps, "peak_gib": peak, "cand": loss.cand.cpu(),
        "route": trainer.route, "step_route": trainer.step_route,
        "calls": dict(t5.pp.calls), "held": held,
        "rank_gb": rank_bytes / 1e9, "whole_gb": whole_bytes / 1e9,
        "identical": bool(torch.equal(lo, hi)),
        "frozen_same": bool(torch.equal(before,
                                        p21_fingerprint(params, frozen))),
        "kernel_a": fa.check(f"{tag} 24a"), "kernel_c": fc.check(
            f"{tag} 24a"),
        "a_shapes": sorted(str(k[:3]) for k in fa.calls),
        "c_shapes": sorted(str(k[:3]) for k in fc.calls)}
    log(f"{tag}: 24a steps {[(r['loss'], r['grad_norm']) for r in steps]}")
    del model, trainer, state, params, flat, lo, hi, before, rows, fa, fc, t5
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 24b: Vicuna-7B's forward without caches, staged
    out["vicuna"] = p24_vicuna(mesh, tag, timing, timers)
    gc.collect()
    torch.cuda.empty_cache()
    return gather_objects(out)


P24_T5 = "((4, 32, 160, 64), (4, 32, 160, 64), (4, 32, 160, 160))"


def p24_remat(card: str, ref: dict) -> dict:
    """24c at world 1, in this process: the flagship E2E model of phase
    21's world-1 start with the T5 tower's ``remat``, one uniform step from
    the start (eager), against phase 21's first step; every T5 encoder
    block's forward runs again in the backward: A 63 + 24, C 24. Beside it
    the same step without remat, each with its peak memory."""
    import dataclasses

    import torch

    from videotgb_torch import train as T
    from videotgb_torch.ops import kernels
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    model, cfg = T.build_model({"preset": "flagship"}, device=dev, seed=0)
    batch = p21_batch(cfg, dev)
    t5 = model.model.language_model
    loss = P21Loss()
    params = dict(model.named_parameters())
    out = {}
    start = None
    for remat in (False, True):
        t5.config = dataclasses.replace(t5.config, remat=remat)
        trainer = Trainer(TrainerConfig(max_steps=3, lr=5e-5), loss,
                          loss.filter_fn)
        trainer._step = trainer._step.eager
        state = trainer.init_state(model)
        if start is None:
            start = {n: params[n].detach().clone() for n in trainer.trainable}
        with torch.no_grad():
            for n in trainer.trainable:
                params[n].copy_(start[n])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        launches = dict(kernels.LAUNCHES)
        want = {**p21_expected(False),
                "flash_fwd": 63 + 24 * remat}
        if launches != want:
            fail(f"24c remat={remat}: launches {launches} != {want}")
        check_bodies(f"24c remat={remat}", launches)
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "wall_ms": wall, "launches": launches,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        for key in ("loss", "grad_norm"):
            rel = abs(rec[key] - ref[key]) / abs(ref[key])
            if rel > 1e-2:
                fail(f"24c remat={remat}: {key} {rec[key]} vs phase 21's "
                     f"first step {ref[key]} ({rel:.2e})")
        out[remat] = rec
        log(f"  24c world 1, remat={remat}: loss {rec['loss']:.6f}, "
            f"grad_norm {rec['grad_norm']:.6f} (phase 21's first step "
            f"{ref['loss']:.6f}, {ref['grad_norm']:.6f}); launches "
            f"{launches}; wall {wall:.2f} ms (eager), peak memory "
            f"{rec['peak_gib']:.2f} GiB on {card}")
        del trainer, state
    del model, params, start, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_parallel_paths(card: str, world1: dict) -> tuple:
    """Phase 24 (see the module's docstring), held to ``world1``, phase
    21's references ("e2e"; :func:`p23_world1` makes it when missing).
    Returns the launches of its counted runs and kernels A's and C's rows
    at the pipeline's stage shapes and 23c's split Vicuna shape."""
    import torch

    from videotgb_torch.ops.attention import NEG_INF
    from videotgb_torch.parallel.distributed import spawn

    ref = p23_world1({"serving": None, **world1})["e2e"]
    totals: dict = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    t = time.perf_counter()
    try:
        ranks = spawn(p24_rank, 2, "gloo", device_type="cuda",
                      device_ids=[0, 0], timeout_s=600)
    except Exception as e:  # noqa: BLE001 - a rank's failure fails the phase
        fail(f"phase 24: the ranks failed: {type(e).__name__}: {e}")
    log(f"  24: two gloo ranks on the one card at pp=2 ran in "
        f"{time.perf_counter() - t:.1f} s (start, hop probe, 24a, 24b)")

    # 24a
    for r in ranks:
        d = r["e2e"]
        log(f"  24 rank {r['rank']}: the hop (gloo all_gather_into_tensor, "
            f"through the host) of a {r['hop_mb']:.2f} MB bf16 activation: "
            f"{r['hop_ms']:.3f} ms on {card}")
        for i, (rec, want) in enumerate(zip(d["steps"], ref["steps"])):
            add(rec["launches"])
            for key in ("loss", "grad_norm"):
                rel = abs(rec[key] - want[key]) / abs(want[key])
                if rel > 1e-2:
                    fail(f"24a rank {r['rank']} step {i}: {key} "
                         f"{rec[key]} vs world 1 {want[key]} ({rel:.2e})")
            if rec["hop_calls"] != 8:
                fail(f"24a rank {r['rank']} step {i}: {rec['hop_calls']} "
                     f"hops, not 8 (2 a pass: encoder and decoder, forward "
                     f"and backward, 2 microbatches over 2 stages)")
            log(f"  24a rank {r['rank']} step {i}: loss {rec['loss']:.6f} "
                f"(world 1 {want['loss']:.6f}), grad_norm "
                f"{rec['grad_norm']:.6f} (world 1 {want['grad_norm']:.6f}); "
                f"launches {rec['launches']}; wall {rec['wall_ms']:.2f} ms, "
                f"{rec['hop_calls']} hops {rec['hop_ms']:.2f} ms "
                f"({rec['hop_ms'] / rec['wall_ms']:.1%} of the step), "
                f"{rec['ar_calls']} all-reduces {rec['ar_ms']:.2f} ms "
                f"({rec['ar_ms'] / rec['wall_ms']:.1%}) on {card}")
        if not d["identical"]:
            fail("24a: trainable parameters differ across the ranks")
        if not d["frozen_same"]:
            fail(f"24a rank {r['rank']}: a frozen parameter changed")
        if P24_T5 not in d["a_shapes"] or d["c_shapes"] != [P24_T5]:
            fail(f"24a rank {r['rank']}: kernels A and C saw {d['a_shapes']}"
                 f" and {d['c_shapes']}, not the T5-xl stage's microbatch")
        if d["calls"] != {"staged": 4}:
            fail(f"24a rank {r['rank']}: the stacks' routes {d['calls']}, "
                 f"not 4 staged passes (encoder and decoder, 2 steps)")
        log(f"  24a rank {r['rank']}: route {d['route']} ({d['step_route']})"
            f", T5 stacks staged {d['calls']}; holds encoder layers "
            f"{d['held']['encoder_blocks']} and decoder layers "
            f"{d['held']['decoder_blocks']}: {d['rank_gb']:.3f} GB of "
            f"parameters against world 1's {d['whole_gb']:.3f} GB; peak "
            f"memory {d['peak_gib']:.2f} GiB; kernel A {d['kernel_a']}, "
            f"kernel C {d['kernel_c']} on the recorded inputs; trainable "
            f"tensors bit-identical across the ranks; frozen fingerprints "
            f"unchanged")
    cand = ranks[0]["e2e"]["cand"]
    if not torch.equal(cand, ref["cand"]):
        fail(f"24a: D's frames at pp=2 {cand.tolist()} != world 1's "
             f"{ref['cand'].tolist()}")
    log(f"  24a: D's frames at pp=2 equal world 1's: {cand.tolist()}")

    # 24b
    for r in ranks:
        d = r["vicuna"]
        add(d["launches"])
        log(f"  24b rank {r['rank']}: Vicuna-7B without caches, 16 layers a "
            f"stage: launches {d['launches']}; kernels A and C at "
            f"{d['shape']}: A {d['kernel_a']}, C {d['kernel_c']} on the "
            f"recorded inputs; "
            + "; ".join(
                f"{k} max |staged - reference| {d[k]['gap']:.4g} (largest "
                f"{d[k]['scale']:.4g}; one bf16 step on the inputs moves the "
                f"whole forward's by {d[k]['floor']:.4g})"
                for k in ("logits", "dx", *d["update"]["leaves"]))
            + f"; the update of {d['update']['leaves']}: norm "
            f"{d['update']['norm']!r} (reference {d['update']['want_norm']!r}"
            f"), leaves off AdamW's by {d['update']['off']}"
            + f"; wall {d['wall_ms']:.2f} ms, {d['hop_calls']} hops "
            f"{d['hop_ms']:.2f} ms ({d['hop_ms'] / d['wall_ms']:.1%}), "
            f"{d['ar_calls']} all-reduces {d['ar_ms']:.2f} ms on {card}")
    log(f"  24: gloo on one card carries every hop through the host: these "
        f"walls time nothing an NCCL machine with a card per rank would")

    # 24c
    remat = p24_remat(card, ref["steps"][0])
    for rec in remat.values():
        add(rec["launches"])

    # kernels A and C at the pipeline's stage shapes and 23c's split Vicuna
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = {}
    for label, (b, h, sq, skv, d) in (
            ("24 T5-xl stage microbatch", (4, 32, 160, 160, 64)),
            ("24 Vicuna stage microbatch", (2, 32, 192, 192, 128)),
            ("23c split Vicuna", (4, 32, 96, 192, 128))):
        if d == 64:  # the relative-position table plus the padding
            lens = torch.randint(120, 161, (b,), generator=gen, device=dev)
            keys = torch.arange(skv, device=dev)
            bias = (torch.randn((1, h, sq, skv), generator=gen, device=dev)
                    + torch.where(keys[None] < lens[:, None], 0.0,
                                  NEG_INF).float()[:, None, None])
        else:  # causal at the rows' global positions, plus the padding
            q_pos = torch.arange(skv - sq, skv, device=dev)
            keys = torch.arange(skv, device=dev)
            lens = torch.randint(skv - 60, skv + 1, (b,), generator=gen,
                                 device=dev)
            bias = (torch.where(keys[None] <= q_pos[:, None], 0.0,
                                NEG_INF)[None, None]
                    + torch.where(keys[None] < lens[:, None], 0.0,
                                  NEG_INF)[:, None, None]).float()
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2) for s in (sq, skv, skv))
        a_row = flash_timed(card, f"{label} ({b},{h},{sq},{skv},{d}) bias "
                            f"{tuple(bias.shape)}", (q, k, v), bias)
        c_row = c_at(card, label, b, h, sq, skv, d, bias, False)
        rows[label] = {"a": a_row, "c": c_row}
    return totals, rows


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        from videotgb_torch.ops import kernels
    except ImportError as e:
        fail(f"the videotgb_torch package is not beside chip_smoke.py ({e})")

    card = card_line()
    t_run = time.perf_counter()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    empty_build = start_empty_build()
    reports = kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    empty = empty_launcher(*empty_build)
    build_s = time.perf_counter() - t0
    log(f"phase 1: built {sorted(kernels.SOURCES)} in {build_s:.2f} s")
    for name, text in reports.items():
        for line in ptxas_summary(text):
            log(f"  {name}: {line}")

    log("phase 2: kernel A, flash-attention forward")
    flash = check_flash(card)
    log("phase 3: kernel B, correlation lookup")
    lookup = check_lookup(card)
    log("phase 4: flagship serving path, 4 requests")
    launches, span = main_path(card)
    gc.collect()
    torch.cuda.empty_cache()  # the serving model is gone before training
    log("phase 5: kernel C, flash-attention backward")
    flash_bwd = check_flash_bwd(card)
    log("phase 6 (E2E) and phase 7 (TG): flagship training paths")
    trained = train_paths(card)
    launches = {k: launches.get(k, 0) + trained[k] for k in trained}
    log(f"  launches of the counted main-path runs (serving, E2E steps 1-2, "
        f"TG steps 1-2): {launches}")
    for kern in (flash, flash_bwd, lookup):
        kern["launches"] = launches[kern["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 8: kernel D, fused frame selection")
    select = check_select(card, span, empty)
    select["launches"] = launches["select_frames"]
    log("phase 9: kernel E, query-blocked correlation lookup (lookup probe)")
    blocked = check_blocked_lookup(card)
    log("phase 10: kernel F, fused add + LayerNorm in Triton (LN probe)")
    add_ln, ln = check_ln(card)
    log("phase 11: kernel G, flash attention in (B, S, H, D) (layout probe)")
    bshd = check_bshd(card)
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    log("phase 12: kernel H, int8 and bf16 GEMMs; the W8A8 serving path; "
        "the int8 tools")
    int8_row, bf16_row = check_gemms(card)
    int8_row["launches"] = int8_serving_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    bf16_row["launches"] = check_int8_tools(card)
    gc.collect()
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    log("phase 13: the serving engine (two workers, two CUDA streams)")
    served = serving_engine(card)
    for kern in (flash, lookup, select):
        kern["launches"] += served[kern["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    log("phase 14: InstructBLIP-Vicuna-7B serving, 4 requests, then its "
        "serving engine")
    vicuna = vicuna_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    vicuna_served = serving_engine(card, backbone="instructblip", arrivals=0)
    for kern in (flash, lookup, select):
        kern["launches"] += vicuna[kern["name"]] + vicuna_served[kern["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    log("phase 15: the training and evaluation CLIs at flagship width "
        "(train.main, evaluate.main)")
    clis = cli_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += clis.get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    log("phase 16: SF through train.main, SF with RAFT in the step on "
        "InstructBLIP-Flan-T5, an E2E step on InstructBLIP-Vicuna-7B")
    sf_launches, c_rows = sf_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += sf_launches.get(kern["name"], 0)
    log(f"  kernel C beside its main-shape row: with ds at the SF T5 shape "
        f"{c_rows['ds']}; head dim 128 at the Vicuna E2E shape "
        f"{c_rows['hd128']}")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    log("phase 17: stage 3, IVT on BLIP2-Flan-T5-xl through train.main, its "
        "checkpoint served by load_model and scored by evaluate.main, IV on "
        "InstructBLIP-Vicuna-7B through train.main")
    s3_launches, s3_rows = stage3_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += s3_launches.get(kern["name"], 0)
    log(f"  kernel C at stage 3: the T5 encoder's (1, 32, 160, 160, 64) "
        f"{s3_rows['t5']}; the LLaMA's (2, 32, 192, 192, 128) "
        f"{s3_rows['llama']}")
    gc.collect()
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    log("phase 18: the chat demo (Chat, its HTTP server, beams on T5 and "
        "Vicuna-7B) and the checkpoint converter")
    demo = demo_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += demo.get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    log("phase 19: the trace and probe tools, the native host library, a "
        "sweep and the judge statistics")
    tools = tool_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += tools["launches"].get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    log("phase 20: the CUDA-graph programs (select, answer, decode, the "
        "engine, train_step and train_step_multi) against their eager "
        "functions")
    graphs_run = graph_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += graphs_run.get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    log("phase 21: data-parallel and fully sharded training (two gloo "
        "ranks on the one card; world-1 references in this process)")
    parallel, e2e_world1 = parallel_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += parallel.get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    log("phase 22: tensor-parallel serving (two gloo ranks on the one card "
        "at tp=2; world-1 references in this process)")
    tensor, serving_world1 = tensor_parallel_paths(card)
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += tensor.get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    log("phase 23: sequence parallelism (two gloo ranks on the one card at "
        "sp=2; phases 21 and 22's world-1 references)")
    sequence, _ = sequence_parallel_paths(
        card, {"e2e": e2e_world1, "serving": serving_world1})
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += sequence.get(kern["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t24 = time.perf_counter()
    log("phase 24: pipeline parallelism (two gloo ranks on the one card at "
        "pp=2; phase 21's world-1 references; remat at world 1)")
    pipeline, _ = pipeline_parallel_paths(card, {"e2e": e2e_world1})
    for kern in (flash, flash_bwd, lookup, select):
        kern["launches"] += pipeline.get(kern["name"], 0)
    done = time.perf_counter()
    log(f"phases 1-24 ran in {done - t_run:.1f} s, phase 12 in "
        f"{t13 - t12:.1f} s, phase 13 in {t14 - t13:.1f} s, phase 14 in "
        f"{t15 - t14:.1f} s, phase 15 in {t16 - t15:.1f} s, phase 16 in "
        f"{t17 - t16:.1f} s, phase 17 in {t18 - t17:.1f} s, phase 18 in "
        f"{t19 - t18:.1f} s, phase 19 in {t20 - t19:.1f} s, phase 20 in "
        f"{t21 - t20:.1f} s, phase 21 in {t22 - t21:.1f} s, phase 22 in "
        f"{t23 - t22:.1f} s, phase 23 in {t24 - t23:.1f} s, phase 24 in "
        f"{done - t24:.1f} s")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    line = {"kernels": [{k: kern[k] for k in order} for kern in (
        flash, lookup, flash_bwd, select, blocked, add_ln, ln, bshd, int8_row,
        bf16_row)]}
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
