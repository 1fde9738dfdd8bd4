"""Trace one training step under ``torch.profiler`` and print the top device
operations.

The counterpart of the JAX package's ``tools/traintraceprobe.py``, the
training-side sibling of ``traceprobe``. The port has no benchmark yet, so
the steps are built here, as ``bench_train.py`` builds the steps it times
(``tg_step``, ``ivt_step`` and ``sf_step`` return the trainer, its state and
the batch, for a benchmark to import):

  tg   the TG recipe (the TGB alone trains) at batch 32, 64 flow frames,
       24-token questions; flagship by default. No kernel.
  ivt  the IVT recipe (LoRA rank 8 on the T5, the Q-Former trains) at
       micro-batch 4 x 4 accumulated, 32-token questions and answers;
       flagship by default. Kernel A on the ViT-g; the T5 sees 32 pooled
       visual + 32 text tokens, under the flash rule's 128^2.
  sf   the SF recipe (everything but the ViT and RAFT trains) at batch 8,
       32 flow frames, 24-token questions, 16-token answers; ``small`` by
       default (the JAX benchmark's one-chip stand-in). Kernels A and C on
       the ViT and the T5 encoder, D for the Gumbel selection.

Parameters are f32 with bf16 compute, random from seed 0, as the port's
training CLI builds them (the JAX benchmark keeps its frozen towers in
bf16). One warm step, then two traced; Python stacks and shapes are not
recorded (host events can crowd the device operations out of a long
trace). Then ``{"mode", "preset", "step_ms"}`` (one synchronised step) and
the trace probe's lines.

    python -m videotgb_torch.tools.traintraceprobe tg|ivt|sf [--preset P]
        [--top 40] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.utils.profiling import print_summary, timed, traced

MODES = ("tg", "ivt", "sf")
DEFAULT_PRESET = {"tg": "flagship", "ivt": "flagship", "sf": "small"}


def _ids(gen, vocab, shape, dev):
    return torch.randint(100, min(vocab, 5000), shape, generator=gen,
                         device=dev)


def _trainer(recipe, model, accum: int = 1):
    from videotgb_torch.training.trainer import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(max_steps=100, lr=5e-5,
                                    accumulate_grad_batches=accum,
                                    log_every=1_000_000,
                                    eval_every=1_000_000),
                      recipe.loss_fn, recipe.filter_fn)
    return trainer, trainer.init_state(model)


def tg_step(device, preset: str = "flagship", batch: int = 32,
            flow_len: int = 64, model=None):
    """(trainer, state, batch) of the TG step ``bench_train.bench_tg``
    times; ``model`` reuses a built model of the preset."""
    from videotgb_torch import train as T

    model = model or T.build_model({"preset": preset}, device=device)[0]
    cfg, dev = model.config, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    fs, text_len = cfg.tgb.flow_size, 24
    starts = torch.randint(0, flow_len, (batch,), generator=gen, device=dev)
    ends = torch.clamp(starts + torch.randint(0, flow_len, (batch,),
                                              generator=gen, device=dev),
                       max=flow_len - 1)
    b = {"flow": torch.randn((batch, flow_len, fs, fs, 2), generator=gen,
                             device=dev),
         "flow_mask": torch.ones((batch, flow_len + 2), device=dev),
         "sampler_question_ids": _ids(gen, cfg.tgb.vocab_size,
                                      (batch, text_len), dev),
         "sampler_question_mask": torch.ones((batch, text_len), device=dev),
         "starts": starts, "ends": ends}
    return (*_trainer(T.build_recipe({"recipe": "tg"}), model), b)


def ivt_step(device, preset: str = "flagship", micro: int = 4,
             accum: int = 4, model=None):
    """(trainer, state, batch) of the IVT step ``bench_train.bench_ivt``
    times: the ``accum`` micro-batches stacked on axis 0 (one micro-batch
    unstacked); ``model`` reuses a built model of the preset with rank-8
    LoRA."""
    from videotgb_torch import train as T

    model = model or T.build_model({"preset": preset, "lora_rank": 8},
                                   device=device)[0]
    cfg, dev = model.config, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    image, nframe, text_len, ans_len = (cfg.blip2.vit.image_size, cfg.nframe,
                                        32, 32)
    vocab = cfg.blip2.t5.vocab_size
    lead = (accum, micro) if accum > 1 else (micro,)
    b = {"frames": torch.randn((*lead, nframe, image, image, 3),
                               generator=gen, device=dev),
         "widths": torch.full(lead, nframe, device=dev),
         "question_ids": _ids(gen, vocab, (*lead, text_len), dev),
         "question_mask": torch.ones((*lead, text_len), device=dev),
         "answer_ids": _ids(gen, vocab, (*lead, ans_len), dev),
         "answer_mask": torch.ones((*lead, ans_len), device=dev)}
    return (*_trainer(T.build_recipe({"recipe": "ivt"}), model, accum), b)


def sf_step(device, preset: str = "small", batch: int = 8,
            flow_len: int = 32, model=None):
    """(trainer, state, batch) of the SF step ``bench_train.bench_sf``
    times; ``model`` reuses a built model of the preset."""
    from videotgb_torch import train as T

    model = model or T.build_model({"preset": preset}, device=device)[0]
    cfg, dev = model.config, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    image, fs, text_len = cfg.blip2.vit.image_size, cfg.tgb.flow_size, 24
    vocab = cfg.blip2.t5.vocab_size
    b = {"frames": torch.randn((batch, cfg.num_frames, image, image, 3),
                               generator=gen, device=dev),
         "flow": torch.randn((batch, flow_len, fs, fs, 2), generator=gen,
                             device=dev),
         "flow_mask": torch.ones((batch, flow_len + 2), device=dev),
         "video_length": torch.full((batch,), flow_len, device=dev),
         "sampler_question_ids": _ids(gen, cfg.tgb.vocab_size,
                                      (batch, text_len), dev),
         "sampler_question_mask": torch.ones((batch, text_len), device=dev),
         "question_ids": _ids(gen, vocab, (batch, text_len), dev),
         "question_mask": torch.ones((batch, text_len), device=dev),
         "answer_ids": _ids(gen, vocab, (batch, 16), dev),
         "scores": torch.rand((batch, cfg.num_frames), generator=gen,
                              device=dev)}
    return (*_trainer(T.build_recipe({"recipe": "sf"}), model), b)


STEPS = {"tg": tg_step, "ivt": ivt_step, "sf": sf_step}


def main(argv=None, model=None, **step_kwargs) -> dict:
    """``model`` and ``step_kwargs`` (batch sizes, ``flow_len``) go to the
    mode's step function."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=MODES)
    ap.add_argument("--preset", default=None,
                    help="default: flagship for tg and ivt, small for sf")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    preset = args.preset or DEFAULT_PRESET[args.which]
    dev = model.device if model is not None else resolve_device(args.device)
    trainer, state, batch = STEPS[args.which](dev, preset, model=model,
                                              **step_kwargs)

    def step():
        nonlocal state
        state, metrics = trainer.train_step(state, batch)
        return float(metrics["loss"])

    step()
    trace_dir = tempfile.mkdtemp(prefix="torchtraintrace_")
    summary = traced(lambda: [step() for _ in range(2)], dev,
                     trace_path=os.path.join(trace_dir, "trace.json"))
    step_s, loss = timed(step, iters=1, warmup=0)
    print({"mode": args.which, "preset": preset,
           "step_ms": round(step_s * 1e3, 3)}, flush=True)
    print_summary(summary, args.top)
    return {**summary, "step_ms": step_s * 1e3, "loss": loss,
            "state_step": state.step}


if __name__ == "__main__":
    main()
