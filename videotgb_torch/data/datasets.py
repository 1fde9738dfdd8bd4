"""Datasets and the static-shape collate of the VideoInstruct mix (the
port's copy of the video half of ``videotgb_tpu/data/datasets.py``, the same
arrays and keys).

Ports the reference's dataset layer (reference: src/data/components/
videoinstruct_dataset.py) with one deliberate change kept from the JAX
package: the collate pads to FIXED maxima (flow -> max_flow_len=64, text ->
max_txt_len) instead of pad-to-longest, so every step sees the same shapes.
Masks carry the true lengths.

Batch key mapping (reference collate keys -> ours):
  frames (B*T,3,224,224)       -> frames (B, T, 224, 224, 3) channels-last
  of / of_mask                 -> flow (B, L, H, W, 2) / flow_mask (B, L+2)
  sampler_question[_attention_mask] -> sampler_question_ids / _mask
  question / answer / instruction   -> *_ids / *_mask
  of_lengths                   -> video_length (B,) int32
  starts/ends                  -> unchanged (flow-domain span targets)

A :class:`SyntheticVideoQA` twin generates schema-identical batches for
tests and smoke training (no dataset ships with the repo). The image/video
instruction mix (``IVInstructDataset``, ``collate_iv``) comes with the IV
recipe.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from videotgb_torch.data.flow_viz import normalize_flow
from videotgb_torch.data.transforms import clip_transform
from videotgb_torch.data.video_io import read_video_cv2, sample_frames

IGNORE_INDEX = -100


def pack_text_input_output(
    input_ids: list[list[int]],
    output_ids: list[list[int]],
    max_len: int,
    pad_id: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LAVIS-style packing (reference LSTP_module.py:677-699): concatenate
    prompt+answer per sample; labels = -100 on the prompt part and pads.
    Host-side (ragged python lists in, padded int32 arrays out); the numpy
    copy of ``videotgb_tpu/models/instructblip.py::pack_text_input_output``."""
    b = len(input_ids)
    ids = np.full((b, max_len), pad_id, np.int32)
    mask = np.zeros((b, max_len), np.int32)
    labels = np.full((b, max_len), IGNORE_INDEX, np.int32)
    for i, (inp, out) in enumerate(zip(input_ids, output_ids)):
        seq = (inp + out)[:max_len]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1
        ans_start = min(len(inp), max_len)
        labels[i, ans_start : len(seq)] = seq[ans_start:]
    return ids, mask, labels


class VideoInstructDataset:
    """Video-ChatGPT instruction data (videoinstruct_dataset.py:54-86)."""

    def __init__(
        self,
        text_dir: str,
        video_dir: str,
        of_dir: str,
        split: str = "train",
        num_frames: int = 32,
        max_flow_len: int = 64,
        nframe: int = 4,
        image_size: int = 224,
        sampling: str = "uniform",
    ):
        self.video_dir = video_dir
        self.of_dir = of_dir
        self.num_frames = num_frames
        self.max_flow_len = max_flow_len
        self.nframe = nframe
        self.image_size = image_size
        self.sampling = sampling
        with open(os.path.join(text_dir, f"{split}.json")) as f:
            raw = json.load(f)
        self.data = [{**d, "idx": idx} for idx, d in raw.items()]
        pl_path = os.path.join(text_dir, "pseudo_label.json")
        self.pseudo_label = {}
        if os.path.exists(pl_path):
            with open(pl_path) as f:
                self.pseudo_label = json.load(f)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict[str, Any]:
        d = self.data[index]
        question = "USER: " + d["q"] + "ASSISTANT: "
        answer = d["a"] + " </s>"
        vid = d["video_id"]

        frames, _ = read_video_cv2(
            os.path.join(self.video_dir, vid + ".mp4"),
            num_frames=self.num_frames, sampling=self.sampling,
            size=(self.image_size, self.image_size),
        )
        frames = clip_transform(frames, self.image_size)

        flow = np.load(os.path.join(self.of_dir, vid + "_raft.npy"))  # (T,2,H,W)
        flow = flow.transpose(0, 2, 3, 1)  # channels-last
        if flow.shape[0] > self.max_flow_len:
            fid = sample_frames(self.max_flow_len, flow.shape[0], self.sampling)
            flow = flow[fid]
        of_length = flow.shape[0]
        flow = normalize_flow(flow)

        # pseudo span: fractions over 31 -> flow-length domain
        # (videoinstruct_dataset.py:81-83)
        start = end = 0
        if d["idx"] in self.pseudo_label:
            pl = self.pseudo_label[d["idx"]]
            start = int(pl[0] / 31 * (of_length - 1))
            end = int(pl[1] / 31 * (of_length - 1))

        return {
            "idx": d["idx"], "frames": frames, "flow": flow,
            "of_length": of_length, "question": question, "answer": answer,
            "instruction": question + " " + answer, "start": start, "end": end,
        }


class SyntheticVideoQA:
    """Schema twin of VideoInstructDataset with generated content."""

    QA = [
        ("what is the person doing", "playing a guitar on stage"),
        ("what color is the car", "the car is bright red"),
        ("how many dogs appear", "two dogs appear in the video"),
        ("where does the scene take place", "in a busy city street"),
    ]

    def __init__(self, length: int = 64, num_frames: int = 32,
                 max_flow_len: int = 64, flow_len_range: tuple[int, int] = (8, 64),
                 image_size: int = 224, flow_size: int = 224, nframe: int = 4,
                 seed: int = 0):
        self.length = length
        self.num_frames = num_frames
        self.max_flow_len = max_flow_len
        self.flow_len_range = flow_len_range
        self.image_size = image_size
        self.flow_size = flow_size
        self.nframe = nframe
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        q, a = self.QA[index % len(self.QA)]
        of_length = int(rng.integers(*self.flow_len_range))
        of_length = min(of_length, self.max_flow_len)
        frames = rng.standard_normal(
            (self.num_frames, self.image_size, self.image_size, 3)
        ).astype(np.float32)
        flow = rng.standard_normal(
            (of_length, self.flow_size, self.flow_size, 2)
        ).astype(np.float32)
        start = int(rng.integers(0, of_length))
        end = int(rng.integers(start, of_length))
        question = "USER: " + q + "ASSISTANT: "
        answer = a + " </s>"
        return {
            "idx": str(index), "frames": frames, "flow": normalize_flow(flow),
            "of_length": of_length, "question": question, "answer": answer,
            "instruction": question + " " + answer, "start": start, "end": end,
        }


def _ragged_ids(enc) -> list[list[int]]:
    """Unpadded token lists from a padded HF-style encoding."""
    return [[t for t, m in zip(ids, mask) if m]
            for ids, mask in zip(enc["input_ids"], enc["attention_mask"])]


def _strip_bos(ids: list[list[int]], tokenizer) -> list[list[int]]:
    """Drop a leading BOS the tokenizer prepended to the answer, mirroring
    the reference's ``output_ids[i][1:]`` in concat_text_input_output
    (LSTP_module.py:688) — otherwise a stray BOS lands between prompt and
    answer and becomes the first supervised label token."""
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is None:
        return ids
    return [seq[1:] if seq and seq[0] == bos else seq for seq in ids]


def collate_videoinstruct(
    samples: list[dict],
    tokenizer,
    sampler_tokenizer,
    max_flow_len: int = 64,
    max_txt_len: int = 128,
    nframe: int = 4,
    answer_len: int = 32,
) -> dict[str, np.ndarray]:
    """Fixed-shape batch assembly (videoinstruct_dataset.py:88-192)."""
    b = len(samples)
    frames = np.stack([s["frames"] for s in samples])  # (B, T, H, W, 3)
    fs = samples[0]["flow"].shape[1:]
    flow = np.zeros((b, max_flow_len, *fs), np.float32)
    flow_mask = np.zeros((b, max_flow_len + 2), np.int32)
    lengths = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        l = s["flow"].shape[0]
        flow[i, :l] = s["flow"]
        flow_mask[i, : l + 2] = 1
        lengths[i] = s["of_length"]

    questions = [s["question"] for s in samples]
    answers = [s["answer"] for s in samples]

    sq = sampler_tokenizer(questions, padding="max_length", truncation=True,
                           max_length=max_txt_len)
    q = tokenizer(questions, padding="max_length", truncation=True,
                  max_length=max_txt_len)
    a = tokenizer(answers, padding="max_length", truncation=True,
                  max_length=answer_len)
    # decoder-only (InstructBLIP) packed prompt+answer with LAVIS-style
    # labels: -100 on the prompt part and pads (pack_text_input_output,
    # reference LSTP_module.py:677-699)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    inst_ids, inst_mask, labels = pack_text_input_output(
        _ragged_ids(q), _strip_bos(_ragged_ids(a), tokenizer),
        max_txt_len + answer_len, pad_id)

    return {
        "frames": frames,
        "flow": flow,
        "flow_mask": flow_mask,
        "video_length": lengths,
        "sampler_question_ids": np.asarray(sq["input_ids"], np.int32),
        "sampler_question_mask": np.asarray(sq["attention_mask"], np.int32),
        # instruction-aware Q-Former text (InstructBLIP variants): the
        # reference's qformer tokenizer is bert-base-uncased — the same
        # vocabulary the sampler uses, so one tokenization serves both
        # (blip2 recipes simply ignore these keys)
        "qformer_input_ids": np.asarray(sq["input_ids"], np.int32),
        "qformer_attention_mask": np.asarray(sq["attention_mask"], np.int32),
        "question_ids": np.asarray(q["input_ids"], np.int32),
        "question_mask": np.asarray(q["attention_mask"], np.int32),
        "answer_ids": np.asarray(a["input_ids"], np.int32),
        "answer_mask": np.asarray(a["attention_mask"], np.int32),
        "instruction_ids": np.asarray(inst_ids, np.int32),
        "instruction_mask": np.asarray(inst_mask, np.int32),
        "labels": np.asarray(labels, np.int32),
        "starts": np.asarray([s["start"] for s in samples], np.int32),
        "ends": np.asarray([s["end"] for s in samples], np.int32),
        "_text_answer": answers,
        "_idxs": [s["idx"] for s in samples],
    }
