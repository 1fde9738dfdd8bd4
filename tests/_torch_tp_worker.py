"""The port's tensor-parallel run on the CPU: two gloo ranks, and the JAX
package's references beside them (not collected by pytest). Started by
``tests/test_torch_tensor_parallel.py``::

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/_torch_tp_worker.py --rank <tp_in.pkl> <ckpt dir> \
        <out.pt>
    python tests/_torch_tp_worker.py --jax <tp_in.pkl> <ckpt dir> <out.pkl> \
        <backbone>

Each rank (``rank_checks``; it imports neither JAX nor the JAX package)
runs, at ``tp=2`` unless named: ``generate_blip2`` and
``generate_instructblip`` with handed Gumbel noise (tokens, frames and
the first decode step's logits), ``ServingEngine(mesh="tp=2")`` request
by request and one request through its HTTP server on rank 0,
``ServingEngine(mesh="dp=2")``, and ``run_inference --mesh tp=2`` on
InstructBLIP-Vicuna, every
model restored from the checkpoints the JAX references write; rank 0
saves what the test checks.

``--jax`` is the reference for one backbone, in a process of its own so
that it compiles while the ranks start: it writes the backbone's seeded
weights as a port checkpoint (then a file ``ready_<backbone>``) and runs
the JAX package's ``generate_*`` (its two halves, jitted as one program)
on a 2-device CPU mesh at ``tp=2``; then, for blip2 its engine at
``mesh="tp=2"``, for instructblip its QA CLI at ``--mesh tp=2``.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np

BACKBONES = ("blip2", "instructblip")
ENGINE = dict(preset="tiny", batch_size=2, flow_frames=3, max_new_tokens=4,
              max_delay_ms=200.0, bf16_params=False)
CLI_FLAGS = ["--batch_size", "2", "--flow_frames", "3", "--max_new_tokens",
             "4", "--do_sample", "0", "--bf16_params", "0", "--flow_mode",
             "fixed", "--preset", "tiny", "--mesh", "tp=2", "--backbone",
             "instructblip"]
WAIT_S = 90  # for the reference's checkpoints


def cli_argv(tp_in: dict, model_path: str, out_dir: str) -> list:
    cli = tp_in["cli"]
    return ["--model_path", model_path, "--video_dir", cli["video_dir"],
            "--gt_file_question", cli["questions"],
            "--gt_file_answers", cli["answers"], "--output_dir", out_dir,
            "--output_name", "preds", *CLI_FLAGS]


# ------------------------------------------------------------- the ranks
def rank_checks(tp_in: dict, ckpt: str) -> dict:
    """This rank's tensor-parallel results (rank 0's are the ones the test
    reads; the tokens of both ranks ride along)."""
    import torch

    from videotgb_torch.evalsuite import inference as TI
    from videotgb_torch.models import videotgb as TV
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.parallel.distributed import gather_objects
    from videotgb_torch.parallel.mesh import MeshConfig, create_mesh
    from videotgb_torch.serve import ServingEngine

    deadline = time.monotonic() + WAIT_S
    while not all(os.path.exists(os.path.join(ckpt, f"ready_{b}"))
                  for b in BACKBONES):
        if time.monotonic() > deadline:
            raise TimeoutError("the JAX references wrote no checkpoints")
        time.sleep(0.2)
    cfgs = tp_in["torch_cfgs"]
    tiny, choose = TV.VideoTGBConfig.tiny, TV.VideoTGB.select_frames
    TV.VideoTGBConfig.tiny = classmethod(
        lambda cls, backbone="blip2": cfgs[backbone])
    handed: list = []

    def select_handed(self, start_logits, end_logits, video_length,
                      generator=None, **kw):
        if handed:
            kw["noise"] = torch.from_numpy(handed.pop(0))
        return choose(self, start_logits, end_logits, video_length,
                      generator, **kw)

    TV.VideoTGB.select_frames = select_handed
    out: dict = {}
    try:
        mesh = create_mesh(MeshConfig(dp=1, tp=2), serving=True)
        b = {k: torch.from_numpy(v) for k, v in tp_in["batch"].items()}
        noise = torch.from_numpy(tp_in["noise"])
        for backbone in BACKBONES:
            model, cfg = TI.load_model(_args(ckpt, backbone), device="cpu",
                                       mesh=mesh)
            dcfg = DecodeConfig(**tp_in["decode"][backbone])
            gen = (TV.generate_instructblip if backbone == "instructblip"
                   else TV.generate_blip2)
            with torch.no_grad():
                tokens, cand = gen(model, b, dcfg, noise=noise)
                logits = _first_logits(model, backbone, b, noise)
            out[backbone] = {
                "tokens": tokens, "cand": cand, "logits": logits,
                "heads": model.model.vision_model.layers[0].attn.num_heads,
                "ranks_tokens": gather_objects(tokens)}

        for mesh_spec in ("tp=2", "dp=2"):
            handed[:] = list(tp_in["engine_noise"])
            engine = ServingEngine(os.path.join(ckpt, "blip2"),
                                   mesh=mesh_spec, device="cpu", **ENGINE)
            replies = None
            if engine.leader:
                replies = [engine.submit(*r).result(timeout=WAIT_S)
                           for r in tp_in["requests"]]
                replies = [(r.answer, r.selected_frames) for r in replies]
                if mesh_spec == "tp=2":
                    out["http"] = http_generate(engine, os.path.join(
                        tp_in["cli"]["video_dir"], "vid_a.mp4"))
                engine.close()
            else:
                engine.join(timeout=WAIT_S)
            out["engine", mesh_spec] = {"replies": replies,
                                        "route": engine.route}

        starts = []
        step_generator = TI.step_generator
        TI.step_generator = lambda s, k, d: (
            starts.append(k) or step_generator(s, k, d))
        handed[:] = []
        cli_noise = tp_in["cli"]["noise"]

        def select_by_start(self, start_logits, end_logits, video_length,
                            generator=None, **kw):
            kw["noise"] = torch.from_numpy(cli_noise[starts[-1]])
            return choose(self, start_logits, end_logits, video_length,
                          generator, **kw)

        TV.VideoTGB.select_frames = select_by_start
        try:
            path = TI.run_inference(TI.parse_args(cli_argv(
                tp_in, os.path.join(ckpt, "instructblip"),
                os.path.join(ckpt, "cli_torch")) + ["--device", "cpu"]))
        finally:
            TI.step_generator = step_generator
        with open(path) as f:
            out["cli"] = {"rows": f.read(), "starts": starts}
    finally:
        TV.VideoTGBConfig.tiny, TV.VideoTGB.select_frames = tiny, choose
    return out


def http_generate(engine, video: str) -> dict:
    """One POST /v1/generate of ``video`` through ``make_server`` on an
    ephemeral port of rank 0: the reply's JSON."""
    import json
    import threading
    import urllib.request

    from videotgb_torch.serve import make_server

    server = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    with open(video, "rb") as f:
        clip = f.read()
    body = (b'--xx\r\nContent-Disposition: form-data; name="video"; '
            b'filename="clip.mp4"\r\n\r\n' + clip + b'\r\n--xx\r\n'
            b'Content-Disposition: form-data; name="question"\r\n\r\n'
            b'what happens?\r\n--xx--\r\n')
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.server_address[1]}/v1/generate",
        data=body, headers={"Content-Type":
                            "multipart/form-data; boundary=xx"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()


def _args(ckpt: str, backbone: str):
    from types import SimpleNamespace

    return SimpleNamespace(model_path=os.path.join(ckpt, backbone),
                           preset="tiny", backbone=backbone, bf16_params=0)


def _first_logits(model, backbone, b, noise):
    """The logits of the first decode step: T5's decoder on its start
    token; LLaMA's prefill at each row's last prompt token."""
    import torch

    lm = model.model.language_model
    rows = b["frames"].shape[0]
    if backbone == "instructblip":
        embeds, mask, _ = model.prepare_llama_inference(
            *(b[k] for k in ("frames", "flow", "flow_mask", "video_length",
                             "sampler_question_ids", "sampler_question_mask",
                             "question_ids", "question_mask")),
            noise=noise, qformer_input_ids=b["qformer_input_ids"],
            qformer_attention_mask=b["qformer_attention_mask"])
        logits, _ = lm(inputs_embeds=embeds, attention_mask=mask)
        last = mask.sum(1).long() - 1
        return logits[torch.arange(rows), last]
    enc, mask, _ = model.prepare_t5_inference(
        *(b[k] for k in ("frames", "flow", "flow_mask", "video_length",
                         "sampler_question_ids", "sampler_question_mask",
                         "question_ids", "question_mask")), noise=noise)
    start = torch.full((rows, 1), lm.config.decoder_start_token_id)
    logits, _ = lm.decode(start, enc, mask)
    return logits[:, 0]


# --------------------------------------------------- the JAX references
def jax_reference() -> None:
    import unittest.mock as mock

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_threefry_partitionable", True)
    jax.config.update("jax_disable_most_optimizations", True)
    import jax.numpy as jnp
    import pytest
    from jax.sharding import NamedSharding

    from _torch_port_helpers import (f32_tiny_presets, jax_load_model_seeded,
                                     jax_param_specs, jax_params,
                                     jax_tiny_f32)
    from videotgb_torch.convert import flax_to_state_dict
    from videotgb_torch.training.checkpoint import (CheckpointConfig,
                                                    CheckpointManager)
    from videotgb_tpu.evalsuite import inference as JI
    from videotgb_tpu.models import videotgb as JV
    from videotgb_tpu.ops.decode import DecodeConfig
    from videotgb_tpu.parallel.mesh import MeshConfig, create_mesh
    from videotgb_tpu.serve import ServingEngine

    src, ckpt, dst, backbone = sys.argv[2:6]
    with open(src, "rb") as f:
        tp_in = pickle.load(f)
    jcfg = jax_tiny_f32(backbone)
    jmodel = JV.VideoTGB(jcfg)
    tree = jax_params(jmodel, jcfg)["params"]  # first: the ranks wait on it
    CheckpointManager(CheckpointConfig(
        directory=os.path.join(ckpt, backbone))).save(
        1, {"params": flax_to_state_dict(jax.device_get(tree)), "step": 1})
    open(os.path.join(ckpt, f"ready_{backbone}"), "w").close()

    mesh = create_mesh(MeshConfig(dp=1, tp=2))
    batch = {k: jnp.asarray(v) for k, v in tp_in["batch"].items()}
    noise = jnp.asarray(tp_in["noise"])
    names = ("frames", "flow", "flow_mask", "video_length",
             "sampler_question_ids", "sampler_question_mask",
             "question_ids", "question_mask")
    placed = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree,
        jax_param_specs(jmodel, jcfg))
    dcfg = DecodeConfig(**tp_in["decode"][backbone])

    def run(p, bt):
        # generate_*'s two halves (the prefix, then the decode from it, on
        # the split of its key), so that the first step's logits read the
        # same prefix without tracing it twice
        sel_key, decode_key = jax.random.split(jax.random.key(0))
        v = {"params": p}
        with mock.patch.object(jax.random, "gumbel",
                               lambda k, shape, dtype=None: noise):
            if backbone == "instructblip":
                embeds, mask, cand = jmodel.apply(
                    v, *(bt[n] for n in names), sel_key,
                    qformer_input_ids=bt["qformer_input_ids"],
                    qformer_attention_mask=bt["qformer_attention_mask"],
                    method=jmodel.prepare_llama_inference)
                tokens = JV.llama_generate_from_embeds(
                    jmodel, v, embeds, mask, dcfg, decode_key)
                logits, _ = jmodel.apply(
                    v, inputs_embeds=embeds, attention_mask=mask,
                    method=lambda m, **a: m.model.language_model(**a))
                last = mask.sum(1).astype(jnp.int32) - 1
                return tokens, cand, logits[jnp.arange(mask.shape[0]), last]
            enc, mask, cand = jmodel.apply(
                v, *(bt[n] for n in names), sel_key,
                method=jmodel.prepare_t5_inference)
            tokens = JV.t5_generate_from_encoder(jmodel, v, enc, mask, dcfg,
                                                 decode_key)
            start = jnp.full((mask.shape[0], 1),
                             jcfg.blip2.t5.decoder_start_token_id, jnp.int32)
            logits, _ = jmodel.apply(
                v, start, enc, mask,
                method=lambda m, *a: m.model.language_model.decode(*a))
            return tokens, cand, logits[:, 0]

    tokens, cand, logits = jax.jit(run)(placed, batch)
    out = {backbone: {"tokens": np.asarray(tokens), "cand": np.asarray(cand),
                      "logits": np.asarray(logits)}}

    with pytest.MonkeyPatch.context() as mp:
        f32_tiny_presets(mp)
        mp.setattr(JI, "load_model", jax_load_model_seeded)
        if backbone == "blip2":
            engine = ServingEngine("random:tiny", mesh="tp=2", **ENGINE)
            try:
                replies = [engine.submit(*r).result(timeout=600)
                           for r in tp_in["requests"]]
            finally:
                engine.close()
            out["engine"] = [(r.answer, r.selected_frames) for r in replies]
        else:
            path = JI.run_inference(JI.parse_args(cli_argv(
                tp_in, "random:tiny", os.path.join(ckpt, "cli_jax"))))
            with open(path) as f:
                out["cli"] = f.read()
    with open(dst, "wb") as f:
        pickle.dump(out, f)


def rank_main() -> None:
    import torch

    from videotgb_torch.parallel.distributed import (barrier, initialize,
                                                     is_coordinator)

    torch.set_num_threads(1)
    initialize(device_type="cpu")
    src, ckpt, dst = sys.argv[2:5]
    with open(src, "rb") as f:
        tp_in = pickle.load(f)
    out = rank_checks(tp_in, ckpt)
    if is_coordinator():
        torch.save(out, dst)
    barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rank_main() if sys.argv[1] == "--rank" else jax_reference()
