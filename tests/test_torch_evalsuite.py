"""The port's evalsuite (``videotgb_torch.evalsuite``) against the JAX
package's on the CPU: ``run_inference`` writes the same JSONL rows from the
same small mp4 fixture as ``tests/test_evalsuite.py`` (three videos, one
question without a video) in the uniform ("fixed") and timeline flow
modes; the CLI helpers and the offline judge give the same values.

Both packages serve the tiny f32 preset with the same numpy weights from a
seed (``_torch_port_helpers.jax_load_model_seeded`` on the JAX side,
carried across with ``videotgb_torch.convert``), the JAX selection's Gumbel
draws are handed to the port for each batch, and both packages'
``clip_transform`` take their default path, the C++ host library."""

import json
import os
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (  # noqa: F401
    f32_tiny_presets,
    few_torch_threads,
    gumbel_like,
    jax_load_model_seeded,
)
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.convert import load_flax_params
from videotgb_torch.data import tokenizer as TT
from videotgb_torch.device import step_generator
from videotgb_torch.evalsuite import evaluate as TE
from videotgb_torch.evalsuite import inference as TI
from videotgb_torch.models import videotgb as TV
from videotgb_torch.training.metrics import rouge_n
from videotgb_tpu.data import tokenizer as JT
from videotgb_tpu.evalsuite import evaluate as JE
from videotgb_tpu.evalsuite import inference as JI
from videotgb_tpu.training import metrics as JM


@pytest.fixture(scope="module")
def qa_assets(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("qa")
    video_dir = root / "videos"
    video_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in ("vid_a", "vid_b", "vid_c"):
        path = str(video_dir / f"{name}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 10.0, (64, 64))
        for _ in range(20):
            writer.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
        writer.release()
    questions = [
        {"video_name": "vid_a", "question": "what happens", "question_id": "q1"},
        {"video_name": "vid_b", "question": "who is there", "question_id": "q2"},
        {"video_name": "vid_c", "question": "what color", "question_id": "q3"},
        {"video_name": "missing", "question": "skip me", "question_id": "q4"},
    ]
    answers = [
        {"answer": "a person walks"},
        {"answer": "a dog"},
        {"answer": "red"},
        {"answer": "n/a"},
    ]
    (root / "q.json").write_text(json.dumps(questions))
    (root / "a.json").write_text(json.dumps(answers))
    return root, video_dir


def _argv(qa_assets, out_dir, *extra):
    root, video_dir = qa_assets
    return ["--model_path", "random:tiny",
            "--video_dir", str(video_dir),
            "--gt_file_question", str(root / "q.json"),
            "--gt_file_answers", str(root / "a.json"),
            "--output_dir", str(out_dir), "--output_name", "preds",
            *extra]


@pytest.mark.parametrize("mode", ["fixed", "timeline"])
def test_run_inference_matches_jax(qa_assets, tmp_path, monkeypatch, mode):
    _cli_matches_jax(qa_assets, tmp_path, monkeypatch, mode, "blip2")


@pytest.mark.parametrize("backbone, mode", [("instructblip", "timeline"),
                                            ("instructblip_t5", "fixed")])
def test_run_inference_instructblip_matches_jax(qa_assets, tmp_path,
                                                monkeypatch, backbone, mode):
    """Vicuna (its eos / pad, ``generate_instructblip``) and the
    instruction-aware T5 variant: the JAX CLI's rows."""
    _cli_matches_jax(qa_assets, tmp_path, monkeypatch, mode, backbone)


def _cli_matches_jax(qa_assets, tmp_path, monkeypatch, mode, backbone):
    """Both CLIs on the fixture's videos: the same JSONL rows."""
    f32_tiny_presets(monkeypatch)
    monkeypatch.setattr(JI, "load_model", jax_load_model_seeded)
    flags = ["--batch_size", "2", "--flow_frames", "3", "--max_new_tokens",
             "4", "--do_sample", "0", "--bf16_params", "0", "--flow_mode",
             mode, "--backbone", backbone]

    # the port: the JAX weights, and the JAX draws of the batch's key
    load = TI.load_model

    def load_carried(args, device=None, mesh=None):
        model, cfg = load(args, device=device, mesh=mesh)
        load_flax_params(model, jax.device_get(
            jax_load_model_seeded(args)[1]))
        return model, cfg

    starts = []
    choose = TV.VideoTGB.select_frames

    def select_jax_noise(self, start_logits, end_logits, video_length,
                         generator=None, **kw):
        key = jax.random.fold_in(jax.random.key(0), starts[-1])
        kw["noise"] = gumbel_like(jax.random.split(key)[0], start_logits,
                                  self.config.top_k)
        return choose(self, start_logits, end_logits, video_length,
                      generator, **kw)

    monkeypatch.setattr(TI, "load_model", load_carried)
    monkeypatch.setattr(TI, "step_generator", lambda s, k, d: (
        starts.append(k) or step_generator(s, k, d)))
    monkeypatch.setattr(TV.VideoTGB, "select_frames", select_jax_noise)

    want_path = JI.run_inference(JI.parse_args(
        _argv(qa_assets, tmp_path / "jax", *flags)))
    got_path = TI.run_inference(TI.parse_args(
        _argv(qa_assets, tmp_path / "torch", *flags, "--device", "cpu")))
    with open(want_path) as f:
        want = [json.loads(line) for line in f]
    with open(got_path) as f:
        got = [json.loads(line) for line in f]
    assert starts == [0, 2]
    assert [r["id"] for r in got] == ["q1", "q2", "q3"]
    assert got == want


def test_run_inference_shards_chunks_and_wants_cuda(qa_assets, tmp_path,
                                                    monkeypatch):
    """--num_chunks/--chunk_idx pick the reference's split; a run with no
    --device wants the CUDA device and raises without one."""
    args = TI.parse_args(_argv(
        qa_assets, tmp_path, "--batch_size", "1", "--max_new_tokens", "2",
        "--num_chunks", "2", "--chunk_idx", "1", "--device", "cpu",
        "--flow_mode", "fixed", "--flow_frames", "3"))
    with open(TI.run_inference(args)) as f:
        rows = [json.loads(line) for line in f]
    assert [r["id"] for r in rows] == ["q3"]  # q4's video is missing
    assert set(rows[0]) == {"id", "question", "answer", "pred"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args.device = None
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.run_inference(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.load_model(args)


def test_load_model_honours_flags_and_refuses_what_is_not_ported(tmp_path):
    from videotgb_torch.training import checkpoint as TCK

    base = dict(model_path="random:tiny", backbone="blip2", lora=0,
                bf16_params=False, nframe=None, flow_size=None)
    _, cfg = TI.load_model(SimpleNamespace(**base), device="cpu")
    assert cfg == TV.VideoTGBConfig.tiny()
    model, cfg = TI.load_model(
        SimpleNamespace(**dict(base, nframe=3, flow_size=48)), device="cpu")
    assert cfg.nframe == 3 and cfg.tgb.flow_size == 48
    assert model.config is cfg
    for backbone in ("instructblip", "instructblip_t5", "blip2"):
        model, cfg = TI.load_model(
            SimpleNamespace(**dict(base, backbone=backbone)), device="cpu")
        assert cfg == TV.VideoTGBConfig.tiny(backbone)
        assert cfg.instruction_aware == (backbone != "blip2")
        # --lora 1: rank-8 adapters on the LLM (it raised before LoRA)
        _, cfg = TI.load_model(SimpleNamespace(
            **dict(base, backbone=backbone, lora=1)), device="cpu")
        assert cfg == TV.with_lora(TV.VideoTGBConfig.tiny(backbone), 8)
        # a checkpoint directory (it raised before the restore): the
        # model of ``preset`` with the saved parameters
        root = tmp_path / backbone
        TCK.CheckpointManager(TCK.CheckpointConfig(directory=str(root))).save(
            3, {"params": model.state_dict(), "step": 3})
        restored, cfg = TI.load_model(SimpleNamespace(**dict(
            base, backbone=backbone, model_path=str(root), preset="tiny")),
            device="cpu")
        assert cfg == TV.VideoTGBConfig.tiny(backbone)
        want = model.state_dict()
        assert all(torch.equal(v, want[k])
                   for k, v in restored.state_dict().items())
    # a mesh it does not serve raises before it wants its ranks
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        TI.run_inference(SimpleNamespace(**dict(base, mesh="fsdp=2,sp=2",
                                                device="cpu", batch_size=2)))


def test_load_model_serves_an_ivt_checkpoint(qa_assets, tmp_path,
                                             monkeypatch):
    """A tiny IVT run of ``train.main`` saves its adapters; ``load_model``
    with ``lora`` restores them onto the preset's model, which selects
    and answers exactly as the saving model; the keys must match both
    ways; the QA CLI answers from the checkpoint with ``--lora 1``."""
    from _torch_port_helpers import make_inputs, write_stage3_media
    from videotgb_torch import train as TTR
    from videotgb_torch.ops.decode import DecodeConfig
    from videotgb_torch.training import checkpoint as TCK

    write_stage3_media(tmp_path / "data" / "ivinstruct")
    trained = []
    build = TTR.build_model
    monkeypatch.setattr(TTR, "build_model", lambda *a, **k: (
        trained.append(build(*a, **k)) or trained[-1]))
    ckpt = str(tmp_path / "out" / "checkpoints")
    TTR.main(["experiment=LSTP_blip2flant5xl_ivtinstruct", "model.preset=tiny",
              "data.tokenizer=byte", "data.num_workers=0",
              "trainer.max_steps=2", "trainer.eval_every=10", "trainer=cpu",
              "extras.print_config=false", f"paths.root_dir={tmp_path}",
              f"paths.output_dir={tmp_path / 'out'}"])
    saver = trained[0][0]
    args = dict(model_path=ckpt, preset="tiny", backbone="blip2", lora=1,
                bf16_params=False)
    model, cfg = TI.load_model(SimpleNamespace(**args), device="cpu")
    assert cfg == trained[0][1]

    x = make_inputs(cfg, seed=3)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    batch["question_ids"] = batch["question_ids"].long()
    dcfg = DecodeConfig(max_new_tokens=4, eos_token_id=1, pad_token_id=0)

    def serve(m):
        cand = TV.select_phase_blip2(m, batch["flow_u8"], batch,
                                     generator=torch.Generator().manual_seed(1))
        sel = batch["frames_u8"][torch.arange(2)[:, None], cand]
        return cand, TV.answer_phase_blip2(m, sel, batch, dcfg)

    for got, want in zip(serve(model), serve(saver)):
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="Unexpected key.*q_lora"):
        TI.load_model(SimpleNamespace(**dict(args, lora=0)), device="cpu")
    plain = tmp_path / "plain"
    TCK.CheckpointManager(TCK.CheckpointConfig(directory=str(plain))).save(
        1, {"params": TI.load_model(SimpleNamespace(**dict(
            args, model_path="random:tiny", lora=0)), device="cpu")[0]
            .state_dict()})
    with pytest.raises(RuntimeError, match="Missing key.*q_lora"):
        TI.load_model(SimpleNamespace(**dict(args, model_path=str(plain))),
                      device="cpu")

    cli = TI.parse_args(_argv(
        qa_assets, tmp_path / "qa", "--model_path", ckpt, "--preset", "tiny",
        "--lora", "1", "--bf16_params", "0", "--batch_size", "2",
        "--max_new_tokens", "2", "--flow_mode", "fixed", "--flow_frames", "3",
        "--device", "cpu"))
    with open(TI.run_inference(cli)) as f:
        assert [json.loads(line)["id"] for line in f] == ["q1", "q2", "q3"]


def test_ignored_reference_flags_warn(qa_assets, tmp_path):
    args = TI.parse_args(_argv(qa_assets, tmp_path, "--model_max_length",
                               "4096", "--cache_dir", "/tmp/nope"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        TI.load_model(args, device="cpu")
    text = " ".join(str(w.message) for w in caught)
    assert "model_max_length" in text and "cache_dir" in text


def test_parse_args_takes_the_jax_flags(qa_assets, tmp_path):
    argv = _argv(qa_assets, tmp_path, "--nframe", "3", "--stop", "###",
                 "--stop", "</s>", "--flow_mode", "fixed")
    got, want = vars(TI.parse_args(argv)), vars(JI.parse_args(argv))
    assert set(got) == set(want)
    assert got.pop("device") is None and want.pop("device") == "tpu"
    assert got == want


@pytest.mark.parametrize("name", [None, "bert-vendored", "llama-vendored"])
def test_encode_stop_words_matches_jax(name):
    words = ["###", "</s>", "#", "stop here", "", "ASSISTANT:"]
    assert TI.encode_stop_words(TT.load_tokenizer(name), words) == \
        JI.encode_stop_words(JT.load_tokenizer(name), words)
    for kw in ({"add_bos": True, "add_eos": False}, {"add_bos": True},
               {"add_eos": False}):
        assert TI.encode_stop_words(TT.ByteTokenizer(**kw), words) == \
            JI.encode_stop_words(JT.ByteTokenizer(**kw), words)


def test_flow_bucket_and_chunks_match_jax():
    for length in range(0, 80):
        for cap in (8, 16, 24, 32, 64, 100):
            assert TI.flow_bucket(length, cap) == JI.flow_bucket(length, cap)
    for n_items in range(1, 23):
        lst = list(range(n_items))
        for n in range(1, n_items + 1):
            assert TI.split_list(lst, n) == JI.split_list(lst, n)
            for k in range(len(JI.split_list(lst, n))):
                assert TI.get_chunk(lst, n, k) == JI.get_chunk(lst, n, k)
    assert TI.VIDEO_FORMATS == JI.VIDEO_FORMATS
    assert TI.FLOW_BUCKETS == JI.FLOW_BUCKETS


def test_find_video_matches_jax(tmp_path):
    for sub in ("msvd", "Activitynet_Zero_Shot_QA"):
        d = tmp_path / sub
        d.mkdir()
        (d / "a.avi").write_bytes(b"")
        (d / "v_b.mkv").write_bytes(b"")
        (d / "b.mp4").write_bytes(b"")
        for name in ("a", "b", "c"):
            assert TI.find_video(str(d), name) == JI.find_video(str(d), name)


def test_rouge_n_matches_jax():
    rng = np.random.default_rng(0)
    vocab = ["a", "red", "car", ",", ".", "dog", "the", "runs", "Red"]
    golds = [" ".join(rng.choice(vocab, rng.integers(0, 7)))
             for _ in range(40)]
    preds = [" ".join(rng.choice(vocab, rng.integers(0, 7)))
             for _ in range(40)]
    for ignore in ((",", "."), None, ("a",)):
        assert rouge_n(golds, preds, ignore) == JM.rouge_n(golds, preds,
                                                           ignore)
        for g, p in zip(golds, preds):
            assert rouge_n(g, p, ignore) == JM.rouge_n(g, p, ignore)


def _judged_dir(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out[name] = json.load(f)
    return out


def test_evaluate_main_token_recall_matches_jax(tmp_path):
    rows = [
        {"id": "1", "question": "q", "answer": "a red car",
         "pred": "a red car </s>"},
        {"id": "2", "question": "q", "answer": "a dog",
         "pred": "something else"},
        {"id": 3, "question": "what", "answer": "red , blue .",
         "pred": "blue</s>red"},
        {"id": "4", "question": "q", "answer": "", "pred": ""},
        {"id": "5", "question": "q", "answer": "one two three four",
         "pred": "two four five"},
    ]
    pred_path = tmp_path / "preds.json"
    pred_path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert TE.load_predictions(str(pred_path)) == \
        JE.load_predictions(str(pred_path))
    stats = {}
    for name, main in (("torch", TE.main), ("jax", JE.main)):
        argv = ["--pred_path", str(pred_path),
                "--output_dir", str(tmp_path / name),
                "--output_json", str(tmp_path / f"{name}.json"),
                "--judge", "token_recall", "--num_tasks", "2"]
        stats[name] = main(argv)
        assert main(argv[:4] + ["--judge", "token_recall"]) == stats[name]
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["count"] == 5
    assert _judged_dir(tmp_path / "torch") == _judged_dir(tmp_path / "jax")
    with open(tmp_path / "torch.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)
    assert TE.SYSTEM_PROMPT == JE.SYSTEM_PROMPT
    assert TE.user_prompt("q", "a", "p") == JE.user_prompt("q", "a", "p")
