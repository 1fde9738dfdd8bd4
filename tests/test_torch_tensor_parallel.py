"""videotgb_torch's tensor parallelism for serving and QA inference
(``parallel/tensor.py``, ``ServingEngine(mesh=...)``, ``run_inference
--mesh``) against videotgb_tpu's GSPMD ``tp`` placement and its
mesh-sharded runs on a 2-device CPU mesh, tiny f32.

Pure parts: the ``("dp", "fsdp", "tp")`` rank layout against JAX's
``create_mesh``; ``tp_shard_state_dict`` against the shards of JAX's
``param_partition_spec`` placement on a ``tp=2`` mesh; the layouts that
still raise.

One 2-process gloo run (``tests/_torch_tp_worker.py``, at most
``TIMEOUT_S``, every process killed on expiry): the ranks' generate,
engine and QA CLI at ``tp=2`` (and the engine at ``dp=2``) against the
JAX package's mesh runs at ``tp=2``, which compile in two processes of
their own while the ranks start.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_port_helpers import L_FLOW, TOL, few_torch_threads  # noqa: F401
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from _torch_port_helpers import handed_gumbel
from videotgb_torch.convert import flat_to_state_dict, flax_to_state_dict
from videotgb_torch.models import videotgb as TV
from videotgb_torch.parallel import distributed as TDI
from videotgb_torch.parallel import mesh as TM
from videotgb_torch.parallel import tensor as TT
from videotgb_torch.training.trainer import Trainer, TrainerConfig
from videotgb_tpu.parallel import mesh as JM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_tp_worker.py")
TIMEOUT_S = 150
SEED = 3
BACKBONES = ("blip2", "instructblip")
KW = dict(max_steps=10, lr=1e-3)


class _Mesh:
    """The coordinate interface of a (dp, fsdp, tp) DeviceMesh."""

    def __init__(self, coord, shape):
        self.coord, self.shape = coord, shape

    def get_coordinate(self):
        return self.coord

    def size(self, dim=None):
        return self.shape[dim] if dim is not None else int(np.prod(self.shape))


# ------------------------------------------------------------ pure parts
@pytest.mark.parametrize("axes,n", [
    (dict(dp=2, tp=2), 4), (dict(dp=1, tp=4), 4), (dict(dp=4, tp=2), 8),
    (dict(dp=-1, tp=2), 8), (dict(dp=2, fsdp=2), 4)])
def test_mesh_layout_is_the_jax_mesh(axes, n):
    """The ranks of the port's ("dp", "fsdp", "tp") mesh sit where JAX's
    ``create_mesh`` puts the devices: ``tp`` innermost, so a ``tp`` group
    is consecutive ranks and the tp ranks of one dp position hold the same
    rows."""
    import jax

    want = JM.create_mesh(JM.MeshConfig(**axes), jax.devices()[:n]).devices
    ids = np.vectorize(lambda d: d.id)(want)
    got = TM.mesh_layout(TM.MeshConfig(**axes), n)
    np.testing.assert_array_equal(got, ids.reshape(got.shape))
    assert ids.shape[3:] == (1, 1)  # pp and sp


@pytest.mark.parametrize("backbone", ["blip2", "instructblip"])
def test_tp_slices_are_the_jax_shards(backbone):
    """Each rank's ``tp_shard_state_dict`` is the device's
    ``addressable_shards`` of JAX's ``param_partition_spec`` placement on a
    ``tp=2`` mesh, carried across with ``videotgb_torch.convert``: equal
    bit for bit, LoRA adapters included. The one difference: JAX leaves
    the biases of column-parallel projections unannotated and GSPMD
    replicates them, where a port rank holds its heads' or units' part;
    those are held to their slice of the whole bias."""
    import jax
    from jax.sharding import NamedSharding

    from _torch_port_helpers import (jax_param_specs, jax_params,
                                     jax_tiny_f32, jax_with_lora,
                                     torch_tiny_f32)
    from flax.traverse_util import flatten_dict
    from videotgb_tpu.models import videotgb as JV

    jcfg = jax_with_lora(jax_tiny_f32(backbone), 4)
    tcfg = TV.with_lora(torch_tiny_f32(backbone), 4)
    jmodel = JV.VideoTGB(jcfg)
    tree = jax_params(jmodel, jcfg, SEED)["params"]
    mesh = JM.create_mesh(JM.MeshConfig(dp=1, tp=2), jax.devices()[:2])
    placed = jax.tree.map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)), tree,
        jax_param_specs(jmodel, jcfg))
    whole = flax_to_state_dict(jax.device_get(tree))
    sliced = 0
    for rank, device in enumerate(mesh.devices.reshape(-1)):
        shards = {path: next(np.asarray(s.data) for s in x.addressable_shards
                             if s.device == device)
                  for path, x in flatten_dict(placed).items()}
        want = flat_to_state_dict(shards)
        got = TT.tp_shard_state_dict(whole, tcfg, rank, 2)
        assert got.keys() == want.keys() == whole.keys()
        for key, value in got.items():
            role = TT.role(key)
            if role == TT.COLUMN and key.endswith(".bias"):
                assert torch.equal(want[key], whole[key]), key
                n = whole[key].shape[0] // 2
                want[key] = whole[key][rank * n:(rank + 1) * n]
            assert torch.equal(value, want[key]), key
            sliced += role is not None and value.shape != whole[key].shape
    roles = {TT.role(k) for k in whole} - {None}
    assert roles == {TT.COLUMN, TT.ROW, TT.VOCAB, TT.GATHER, TT.LORA_B} | (
        {TT.HEADS} if backbone == "blip2" else set())
    assert sliced == 2 * sum(TT.role(k) is not None for k in whole)


def test_tp_layouts_that_still_raise_name_their_items():
    """Serving takes ``tp`` (and ``tp`` with ``sp``); ``sp`` with
    ``fsdp``, ``pp`` and ``fsdp`` with ``tp`` raise there, ``tp`` raises in
    training (``Trainer`` too), and a tower whose heads do not divide
    raises a ``ValueError`` naming it (the Q-Former's 12 heads at tp=8,
    whose 768 q rows would divide)."""
    for axes, item in ((dict(fsdp=2, sp=2), "item 4"),
                       (dict(pp=2), "item 5"),
                       (dict(fsdp=2, tp=2), "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            TM.create_mesh(TM.MeshConfig(**axes), serving=True)
    TM.check_ported(TM.MeshConfig(dp=1, tp=2, sp=2), serving=True)
    with pytest.raises(ValueError, match="device count"):
        TM.create_mesh(TM.MeshConfig(dp=1, tp=2), serving=True)
    with pytest.raises(NotImplementedError, match="item 4"):
        Trainer(TrainerConfig(**KW), None, mesh=_Mesh((0, 0, 0), (1, 1, 2)))
    flagship = TV.VideoTGBConfig.flagship()
    key = "model.qformer.layers.0.self_attn.q.weight"
    with pytest.raises(ValueError, match=r"model\.qformer\.layers\.0\."
                       r"self_attn\.q: 12 heads do not divide by tp=8"):
        TT.tp_shard_state_dict({key: torch.zeros(768, 8)}, flagship, 0, 8)
    key = "temporal_encoder.token_type_embeddings.weight"
    with pytest.raises(ValueError, match="2 vocabulary rows do not divide"):
        TT.tp_shard_state_dict({key: torch.zeros(2, 8)}, flagship, 0, 4)


def test_a_sampled_token_under_a_split_draws_the_global_batchs():
    """A sampled decode step under a dp split draws this rank's rows of the
    global batch's noise (``global_draw``), so each row gets the token it
    gets at world 1; the tp ranks of one position draw alike."""
    from videotgb_torch.ops.decode import DecodeConfig, _next_token
    from videotgb_torch.parallel.sharding import batch_split

    cfg = DecodeConfig(max_new_tokens=4, do_sample=True, temperature=0.7)
    logits = torch.randn((4, 384), generator=torch.Generator().manual_seed(1))
    tokens = torch.zeros((4, 4), dtype=torch.long)
    want = _next_token(logits, tokens, cfg, torch.Generator().manual_seed(5))
    for dp_i, tp_i in ((0, 0), (1, 0), (1, 1)):
        with batch_split(_Mesh((dp_i, 0, tp_i), (2, 1, 2))):
            got = _next_token(logits[2 * dp_i:2 * dp_i + 2], tokens[:2], cfg,
                              torch.Generator().manual_seed(5))
        assert torch.equal(got, want[2 * dp_i:2 * dp_i + 2]), (dp_i, tp_i)


# --------------------------------------------------- the two-process run
def tp_inputs(qa) -> dict:
    """The run's inputs, from seeds: a generate batch of 2 rows with its
    Gumbel noise, 3 engine requests with the JAX engine's draws for its
    steps (``fold_in(key(0), step)``), 3 mp4 clips and their questions
    (one without a clip) with the JAX CLI's draws for its batches, the
    port's tiny f32 configs."""
    import cv2
    import jax

    from _torch_port_helpers import jax_tiny_f32, torch_tiny_f32

    rng = np.random.default_rng(SEED)
    jcfg = jax_tiny_f32()
    img, fs, b = jcfg.blip2.vit.image_size, jcfg.tgb.flow_size, 2
    batch = {
        "frames": rng.standard_normal((b, jcfg.num_frames, img, img, 3)),
        "flow": rng.standard_normal((b, L_FLOW, fs, fs, 2)),
        "flow_mask": np.ones((b, L_FLOW + 2)),
        "video_length": np.full((b,), L_FLOW, np.int32),
        "sampler_question_ids": rng.integers(4, 60, (b, 5)),
        "sampler_question_mask": np.ones((b, 5)),
        "question_ids": rng.integers(4, 60, (b, 6)),
        "question_mask": np.array([[1.0] * 6, [1.0] * 4 + [0.0] * 2]),
        "qformer_input_ids": rng.integers(4, 60, (b, 5)),
        "qformer_attention_mask": np.ones((b, 5))}
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in batch.items()}
    shape = (jcfg.top_k, 2, b, L_FLOW)

    def gumbel(key):
        return np.asarray(jax.random.gumbel(key, shape), np.float32)

    requests = [(rng.integers(0, 255, (jcfg.num_frames, img, img, 3),
                              np.uint8),
                 rng.integers(0, 255, (L_FLOW + 1, fs, fs, 3), np.uint8),
                 question) for question in ("what happens?", "", "why " * 30)]
    videos = qa / "videos"
    videos.mkdir(parents=True)
    for name in ("vid_a", "vid_b", "vid_c"):
        writer = cv2.VideoWriter(str(videos / f"{name}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                                 (64, 64))
        for _ in range(20):
            writer.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
        writer.release()
    names = ("vid_a", "vid_b", "missing", "vid_c")
    (qa / "q.json").write_text(json.dumps([
        {"video_name": n, "question": f"what is in {n}", "question_id": n}
        for n in names]))
    (qa / "a.json").write_text(json.dumps([{"answer": n} for n in names]))
    key = jax.random.key(0)
    return {
        "batch": batch, "noise": np.asarray(handed_gumbel(jcfg)),
        "decode": {"blip2": dict(max_new_tokens=4, eos_token_id=1,
                                 pad_token_id=0),
                   "instructblip": dict(max_new_tokens=4, eos_token_id=2,
                                        pad_token_id=0)},
        "requests": requests,
        "engine_noise": [gumbel(jax.random.fold_in(key, step))
                         for step in range(len(requests))],
        "cli": {"video_dir": str(videos), "questions": str(qa / "q.json"),
                "answers": str(qa / "a.json"),
                "noise": {start: gumbel(jax.random.split(
                    jax.random.fold_in(key, start))[0]) for start in (0, 2)}},
        "torch_cfgs": {bb: torch_tiny_f32(bb) for bb in BACKBONES}}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Starts the JAX references (one process a backbone) and the two
    ranks at once (the ranks wait for the checkpoints the references write
    first), and waits for them all at most TIMEOUT_S."""
    d = tmp_path_factory.mktemp("tp")
    (d / "ckpt").mkdir()
    tp_in = tp_inputs(d / "qa")
    with open(d / "tp_in.pkl", "wb") as f:
        pickle.dump(tp_in, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = TDI.free_port()
    args = [str(d / "tp_in.pkl"), str(d / "ckpt")]
    cmds = [([sys.executable, WORKER, "--jax", *args,
              str(d / f"jax_{backbone}.pkl"), backbone], {})
            for backbone in BACKBONES]
    cmds += [([sys.executable, WORKER, "--rank", *args, str(d / "out.pt")],
              dict(RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))) for r in range(2)]
    procs = [subprocess.Popen(cmd, env=dict(env, **extra), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd, extra in cmds]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode()[-3000:]
    jax_out = {}
    for backbone in BACKBONES:
        with open(d / f"jax_{backbone}.pkl", "rb") as f:
            jax_out.update(pickle.load(f))
    return {"out": torch.load(d / "out.pt", weights_only=False),
            "jax": jax_out, "tp_in": tp_in}


def test_tensor_parallel_serving_matches_the_jax_mesh_runs(tp_run):
    """The ranks' tensor-parallel work against the JAX package's mesh runs
    at ``tp=2`` (one test: under ``--dist load`` every worker that takes a
    test of the run would start its processes). ``generate_blip2`` and
    ``generate_instructblip`` on each rank's slice, the same noise handed
    to both: frames and tokens equal, the first decode step's logits at
    2e-4 (T5's decoder on its start token; LLaMA's prefill at each row's
    last prompt token), both ranks' tokens bit-identical, each ViT layer
    on half of its heads. The port's engine at ``mesh="tp=2"`` and at
    ``mesh="dp=2"``, rank 0 taking the requests one at a time (each batch
    padded by repeating it), against the JAX engine at ``mesh="tp=2"``
    with the same draws: the same frames and answer for each request; the
    sliced model runs eagerly; a POST of an mp4 to rank 0's HTTP server
    answers. ``run_inference --mesh tp=2`` (rank 0
    writes) against the JAX CLI's ``--mesh tp=2`` rows with the JAX draws
    of each batch: the same JSONL."""
    tp, want = tp_run["out"], tp_run["jax"]
    for backbone in ("blip2", "instructblip"):
        got, ref = tp[backbone], want[backbone]
        np.testing.assert_array_equal(got["cand"].numpy(), ref["cand"],
                                      err_msg=backbone)
        np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"],
                                      err_msg=backbone)
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   err_msg=backbone, **TOL)
        a, b = got["ranks_tokens"]
        assert torch.equal(a, b), backbone
        assert got["heads"] == tp_run["tp_in"]["torch_cfgs"][
            backbone].vit.num_heads // 2
    replies = [(a, list(f)) for a, f in want["engine"]]
    for mesh in ("tp=2", "dp=2"):
        got = tp["engine", mesh]
        assert got["replies"] == replies, mesh
        assert got["route"].startswith("eager") == (mesh == "tp=2")
    http = tp["http"]  # rank 0's HTTP server in front of the tp=2 engine
    assert set(http) == {"answer", "selected_frames", "latency_ms"}
    assert len(http["selected_frames"]) == tp_run["tp_in"]["torch_cfgs"][
        "blip2"].nframe
    cli = tp["cli"]
    assert cli["starts"] == [0, 2]
    rows = [json.loads(line) for line in cli["rows"].splitlines()]
    assert [r["id"] for r in rows] == ["vid_a", "vid_b", "vid_c"]
    assert cli["rows"] == want["cli"]
