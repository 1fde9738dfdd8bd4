"""Tokenizers: HF-backed when vocab assets exist, byte-level otherwise (the
port's copy of ``videotgb_tpu/data/tokenizer.py``, same ids and call
surface).

:class:`ByteTokenizer` is a deterministic, reversible byte-level scheme with
the HF call surface (``__call__`` with padding/truncation ->
{"input_ids", "attention_mask"} as numpy arrays, ``batch_decode``); its 260
ids fit the T5 (32,128) and BERT (30,522) embeddings, so it serves random
weights where ``transformers`` is not installed. ``transformers`` is
imported only inside the functions that load an HF tokenizer.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Encoding:
    input_ids: np.ndarray
    attention_mask: np.ndarray

    def __getitem__(self, key: str):
        return getattr(self, key)


class ByteTokenizer:
    """Bytes + specials. ids: 0=pad, 1=eos, 2=bos, 3=unk, byte b -> b + 4."""

    pad_token_id = 0
    eos_token_id = 1
    bos_token_id = 2
    unk_token_id = 3
    offset = 4

    def __init__(self, vocab_size: int = 260, add_bos: bool = False,
                 add_eos: bool = True):
        self.vocab_size = max(vocab_size, 260)
        self.add_bos = add_bos
        self.add_eos = add_eos
        self.name_or_path = "byte-tokenizer"

    def encode(self, text: str) -> list[int]:
        ids = [b + self.offset for b in text.encode("utf-8")]
        if self.add_bos:
            ids = [self.bos_token_id] + ids
        if self.add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if self.offset <= i < self.offset + 256:
                out.append(i - self.offset)
            elif not skip_special_tokens:
                out.extend(f"<{i}>".encode())
            # ids beyond the byte range (vocab padding slots a model may
            # emit with random weights) decode to nothing
        return out.decode("utf-8", errors="replace")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def __call__(
        self,
        text: str | list[str],
        padding: str = "longest",
        truncation: bool = True,
        max_length: int = 128,
        return_tensors: str | None = "np",
        **_,
    ) -> Encoding:
        texts = [text] if isinstance(text, str) else list(text)
        encoded = [self.encode(t) for t in texts]
        if truncation:
            encoded = [e[:max_length] for e in encoded]
        width = max_length if padding == "max_length" else max(len(e) for e in encoded)
        ids = np.full((len(encoded), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(encoded), width), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return Encoding(ids, mask)


# a real (minimal) WordPiece vocab: bert-style specials + characters +
# ##-continuations + common words, 384 entries (fits the tiny TGB
# embedding); keeps the HF WordPiece code path exercisable offline
VENDORED_BERT_VOCAB = os.path.join(
    os.path.dirname(__file__), "assets", "bert_vocab.txt")

# a real (minimal) LLaMA-family tokenizer: the serialized pipeline released
# Vicuna checkpoints carry (metaspace normalizer, BPE with byte fallback,
# <s> BOS template), vocab 384; loads through LlamaTokenizerFast
VENDORED_LLAMA_TOKENIZER = os.path.join(
    os.path.dirname(__file__), "assets", "llama_tokenizer.json")


def write_vendored_bert_dir(directory: str) -> str:
    """Materialize an AutoTokenizer-loadable directory from the vendored
    WordPiece vocab (vocab.txt + tokenizer_config.json)."""
    import json
    import shutil

    os.makedirs(directory, exist_ok=True)
    shutil.copy(VENDORED_BERT_VOCAB, os.path.join(directory, "vocab.txt"))
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer",
                   "do_lower_case": True,
                   "model_max_length": 512}, f)
    return directory


def load_llama_vendored():
    """The packaged LLaMA/Vicuna-scheme tokenizer through transformers'
    LlamaTokenizerFast (ids: 0=unk=pad, 1=bos, 2=eos). ``legacy=True``
    pins the Vicuna-era metaspace behavior."""
    from transformers import LlamaTokenizerFast

    tok = LlamaTokenizerFast(
        tokenizer_file=VENDORED_LLAMA_TOKENIZER,
        unk_token="<unk>", bos_token="<s>", eos_token="</s>",
        pad_token="<unk>", add_bos_token=True, add_eos_token=False,
        legacy=True)
    tok.name_or_path = "llama-vendored-vicuna"
    return tok


def write_vendored_llama_dir(directory: str) -> str:
    """Materialize an AutoTokenizer-loadable directory from the vendored
    LLaMA tokenizer (tokenizer.json + tokenizer_config.json)."""
    os.makedirs(directory, exist_ok=True)
    load_llama_vendored().save_pretrained(directory)
    return directory


def load_tokenizer(name_or_path: str | None, **kwargs):
    """HF AutoTokenizer when resolvable, ByteTokenizer otherwise.
    ``"bert-vendored"`` / ``"llama-vendored"`` load the packaged minimal
    assets through the real transformers tokenizer classes."""
    if name_or_path in (None, "byte", "byte-tokenizer"):
        return ByteTokenizer(**kwargs)
    if name_or_path == "bert-vendored":
        from transformers import BertTokenizer

        return BertTokenizer(vocab_file=VENDORED_BERT_VOCAB,
                             do_lower_case=True)
    if name_or_path == "llama-vendored":
        return load_llama_vendored()
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
    except Exception:
        return ByteTokenizer(**kwargs)
