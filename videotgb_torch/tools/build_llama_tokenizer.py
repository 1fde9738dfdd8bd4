"""Build the vendored LLaMA-family tokenizer asset (offline, deterministic;
the port's copy of the JAX package's ``tools/build_llama_tokenizer.py``).

The reference's Vicuna path loads the LLaMA sentencepiece tokenizer from the
hub (eval/inference.py:76-89 via InstructBlipProcessor). This image has no
hub access and no `sentencepiece` lib, but it does ship HF's Rust
`tokenizers`, and LlamaTokenizerFast runs entirely off a tokenizer.json —
the exact serialized pipeline the released Vicuna checkpoints carry:

  normalizer   Sequence[Prepend("▁"), Replace(" " -> "▁")]
  model        BPE(byte_fallback=True, fuse_unk=True, unk="<unk>")
  decoder      Sequence[Replace("▁" -> " "), ByteFallback, Fuse, Strip]
  post         TemplateProcessing("<s> $A")   (BOS, no EOS — LLaMA default)

This script trains a tiny deterministic BPE (pure-python, frequency order
with lexicographic tie-break) over an embedded video-QA corpus and emits
``videotgb_torch/data/assets/llama_tokenizer.json`` with vocab_size=384 —
matching LlamaConfig.tiny's embedding — laid out like the real asset:
ids 0-2 = <unk>/<s>/</s>, 3-258 = the 256 <0xNN> byte tokens, then learned
pieces. Any text therefore tokenizes (byte fallback), while common QA words
come out as real multi-char pieces.

Run: python -m videotgb_torch.tools.build_llama_tokenizer
"""

from __future__ import annotations

import collections
import os

VOCAB_SIZE = 384
ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "data", "assets", "llama_tokenizer.json")

# deterministic embedded corpus: the domain's prompt scaffolding
# (eval/inference.py:75, data/conversation.py separators) + video-QA English
CORPUS = """
USER: <video> ASSISTANT: </s>
A chat between a curious user and an artificial intelligence assistant .
The assistant gives helpful , detailed , and polite answers to the user's questions .
Question : what is the person doing in the video ? Answer the question using a single word or phrase .
what happens at the beginning of the video ? who is there ? where does the man go ?
the man is walking down the street . a woman opens the door and smiles .
a dog runs across the yard . two people are talking in the kitchen .
he picks up the ball and throws it . she pours water into a glass .
the children are playing outside . a person rides a bicycle on the road .
first , the cat jumps onto the table . then it knocks over the cup .
yes no one two three four five six seven eight nine ten left right before after
short answer : describe the video in detail . what color is the car ? it is red .
how many people are in the room ? there are three people sitting at a table .
"""


def _train_bpe(corpus: str, n_merges: int):
    """Minimal deterministic BPE: metaspace words, most-frequent pair first,
    ties broken by lexicographic pair order."""
    words = collections.Counter(
        "▁" + w for line in corpus.strip().splitlines()
        for w in line.split())
    # each word as a tuple of symbols
    seqs = {w: list(w) for w in words}
    merges: list[tuple[str, str]] = []
    for _ in range(n_merges):
        pairs: collections.Counter = collections.Counter()
        for w, freq in words.items():
            s = seqs[w]
            for a, b in zip(s, s[1:]):
                pairs[(a, b)] += freq
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0][0] + "\x00" + kv[0][1]))
        if best[1] < 2:
            break
        (a, b), _ = best
        merges.append((a, b))
        ab = a + b
        for w, s in seqs.items():
            i, out = 0, []
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(ab)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    alphabet = sorted({c for w in words for c in w})
    return alphabet, merges


def build(path: str = ASSET) -> str:
    from tokenizers import Tokenizer, decoders, models, normalizers, processors

    specials = ["<unk>", "<s>", "</s>"]
    byte_tokens = [f"<0x{i:02X}>" for i in range(256)]
    budget = VOCAB_SIZE - len(specials) - len(byte_tokens)

    alphabet, merges = _train_bpe(CORPUS, n_merges=budget)
    # alphabet chars + merged pieces must fit the budget; drop the
    # lowest-priority merges if needed (alphabet chars are mandatory: every
    # merge decomposes to them)
    n_merge_slots = budget - len(alphabet)
    assert n_merge_slots > 0, "corpus alphabet exceeds the vocab budget"
    merges = merges[:n_merge_slots]

    vocab: dict[str, int] = {}
    for t in specials + byte_tokens + alphabet:
        vocab[t] = len(vocab)
    for a, b in merges:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
    assert len(vocab) <= VOCAB_SIZE, len(vocab)

    tok = Tokenizer(models.BPE(
        vocab=vocab, merges=merges, unk_token="<unk>",
        fuse_unk=True, byte_fallback=True))
    tok.normalizer = normalizers.Sequence([
        normalizers.Prepend("▁"),
        normalizers.Replace(" ", "▁"),
    ])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "),
        decoders.ByteFallback(),
        decoders.Fuse(),
        decoders.Strip(" ", 1, 0),
    ])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B",
        special_tokens=[("<s>", vocab["<s>"])])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tok.save(path)
    return path


if __name__ == "__main__":
    p = build()
    # smoke: round-trip through the real transformers class
    from transformers import LlamaTokenizerFast

    t = LlamaTokenizerFast(
        tokenizer_file=p, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>", add_bos_token=True, add_eos_token=False)
    enc = t("USER: what is the person doing? ASSISTANT:")
    print(p)
    print(enc["input_ids"])
    print(t.convert_ids_to_tokens(enc["input_ids"]))
    print(repr(t.decode(enc["input_ids"], skip_special_tokens=True)))
