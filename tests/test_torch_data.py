"""The port's host data modules against the JAX package's, exactly: the
tokenizers (byte, vendored BERT WordPiece, vendored LLaMA BPE), the frame
sampling rules, the OpenCV readers on a small mp4 and the numpy
transforms."""

import random

import numpy as np
import pytest

from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.data import tokenizer as TT
from videotgb_torch.data import transforms as TX
from videotgb_torch.data import video_io as TIO
from videotgb_tpu.data import tokenizer as JT
from videotgb_tpu.data import transforms as JX
from videotgb_tpu.data import video_io as JIO

TEXTS = ["what happens in the video?", "Who is THERE, and why?",
         "naïve café — ünïcode", "", "a " * 40]


@pytest.mark.parametrize("name", [None, "bert-vendored", "llama-vendored"])
@pytest.mark.parametrize("padding", ["max_length", "longest"])
def test_tokenizer_matches_jax(name, padding):
    want_tok, got_tok = JT.load_tokenizer(name), TT.load_tokenizer(name)
    assert type(got_tok).__name__ == type(want_tok).__name__
    want = want_tok(TEXTS, padding=padding, truncation=True, max_length=24)
    got = got_tok(TEXTS, padding=padding, truncation=True, max_length=24)
    np.testing.assert_array_equal(np.asarray(got["input_ids"]),
                                  np.asarray(want["input_ids"]))
    np.testing.assert_array_equal(np.asarray(got["attention_mask"]),
                                  np.asarray(want["attention_mask"]))
    ids = np.asarray(want["input_ids"])
    for skip in (True, False):
        assert got_tok.batch_decode(ids, skip_special_tokens=skip) == \
            want_tok.batch_decode(ids, skip_special_tokens=skip)
    for text in TEXTS:
        assert list(got_tok.encode(text)) == list(want_tok.encode(text))


def test_byte_tokenizer_options_and_random_ids_match_jax():
    for kw in ({}, {"add_bos": True}, {"add_eos": False},
               {"vocab_size": 32128}):
        want, got = JT.ByteTokenizer(**kw), TT.ByteTokenizer(**kw)
        assert got.vocab_size == want.vocab_size
        assert got.encode("hi there") == want.encode("hi there")
    ids = np.random.default_rng(0).integers(0, 32128, (4, 40))
    assert TT.ByteTokenizer().batch_decode(ids) == \
        JT.ByteTokenizer().batch_decode(ids)


def test_vendored_tokenizer_dirs_load_the_same_vocab(tmp_path):
    from transformers import AutoTokenizer

    for write_t, write_j in ((TT.write_vendored_bert_dir,
                              JT.write_vendored_bert_dir),
                             (TT.write_vendored_llama_dir,
                              JT.write_vendored_llama_dir)):
        got = AutoTokenizer.from_pretrained(
            write_t(str(tmp_path / "t" / write_t.__name__)))
        want = AutoTokenizer.from_pretrained(
            write_j(str(tmp_path / "j" / write_j.__name__)))
        assert got.get_vocab() == want.get_vocab()
        assert got(TEXTS)["input_ids"] == want(TEXTS)["input_ids"]


@pytest.mark.parametrize("sampling", ["uniform", "rand", "headtail"])
def test_sample_frames_matches_jax(sampling):
    for vlen in (1, 2, 3, 7, 32, 33, 100, 257):
        for n in (1, 2, 4, 8, 32):
            if sampling == "headtail" and vlen < 2:
                continue
            random.seed(vlen * 100 + n)
            want = JIO.sample_frames(n, vlen, sampling)
            random.seed(vlen * 100 + n)
            got = TIO.sample_frames(n, vlen, sampling)
            assert got == want, (vlen, n)


def test_frame_index_rules_match_jax():
    for vlen in range(1, 80):
        for n in (4, 8, 32):
            assert TIO.candidate_indices(vlen, n) == \
                JIO.candidate_indices(vlen, n)
            assert TIO.duplicate_to_length(list(range(vlen)), n) == \
                JIO.duplicate_to_length(list(range(vlen)), n)
        for fps in (0.5, 1.0, 2.0, 30.0, 60.0):
            for native in (0.9, 1.0, 10.0, 24.0, 29.97, 30.0):
                assert TIO.reference_flow_indices(vlen, native, fps) == \
                    JIO.reference_flow_indices(vlen, native, fps)
    with pytest.raises(NotImplementedError):
        TIO.sample_frames(4, 10, "bogus")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 23-frame 10 fps 48 x 64 mp4 of random frames, and a directory of
    its first frames as png."""
    import cv2

    root = tmp_path_factory.mktemp("video")
    path = str(root / "clip.mp4")
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (64, 48))
    frames_dir = root / "frames"
    frames_dir.mkdir()
    for i in range(23):
        frame = rng.integers(0, 255, (48, 64, 3), np.uint8)
        writer.write(frame)
        if i < 9:
            cv2.imwrite(str(frames_dir / f"{i:03d}.png"), frame)
    writer.release()
    return path, str(frames_dir)


@pytest.mark.parametrize("kw", [dict(num_frames=4), dict(num_frames=32),
                                dict(num_frames=8, size=(56, 56)),
                                dict(fps=2.0), dict(fps=5.0, size=(32, 40))])
def test_read_video_cv2_matches_jax(clip, kw):
    got, got_fps = TIO.read_video_cv2(clip[0], **kw)
    want, want_fps = JIO.read_video_cv2(clip[0], **kw)
    assert got_fps == want_fps
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(max_frames=2),
                                dict(max_frames=64, fps=30.0, size=(32, 32))])
def test_read_video_timeline_matches_jax(clip, kw):
    got, got_len = TIO.read_video_timeline(clip[0], **kw)
    want, want_len = JIO.read_video_timeline(clip[0], **kw)
    assert got_len == want_len
    np.testing.assert_array_equal(got, want)


def test_read_frames_dir_matches_jax(clip):
    for n in (3, 9, 16):
        np.testing.assert_array_equal(TIO.read_frames_dir(clip[1], n),
                                      JIO.read_frames_dir(clip[1], n))
    with pytest.raises(FileNotFoundError):
        TIO.read_video_cv2(clip[1] + "/missing.mp4", num_frames=4)


@pytest.mark.parametrize("size", [56, (56, 56), (32, 48), 224, (48, 64)])
def test_resize_video_matches_jax(size):
    frames = np.random.default_rng(1).integers(0, 255, (5, 48, 64, 3),
                                               np.uint8)
    got, want = TX.resize_video(frames, size), JX.resize_video(frames, size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [56, 224])
def test_clip_transform_matches_jax_numpy_path(size):
    frames = np.random.default_rng(2).integers(0, 255, (6, 48, 64, 3),
                                               np.uint8)
    got = TX.clip_transform(frames, size, use_native=False)
    want = JX.clip_transform(frames, size, use_native=False)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TX.denormalize(got), JX.denormalize(want))


def test_random_crops_and_flips_match_jax():
    frames = np.random.default_rng(3).integers(0, 255, (3, 48, 64, 3),
                                               np.uint8)
    for seed in range(6):
        for fn, args in (("horizontal_flip_video", (0.5,)),
                         ("random_crop_video", (32,)),
                         ("random_resized_crop_video", (40,))):
            got = getattr(TX, fn)(frames, *args, np.random.default_rng(seed))
            want = getattr(JX, fn)(frames, *args, np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TX.center_crop_video(frames, 40),
                                  JX.center_crop_video(frames, 40))
