"""Autoregressive decode: greedy and temperature / top-p sampling with HF
repetition penalty and per-sequence early stop on EOS or stop sequences.

Model-agnostic: the caller passes ``step_fn(tokens (B, 1), caches, index)``
-> (logits (B, V), caches). The output buffer is (B, max_new_tokens) padded
with pad_token_id after EOS. A Python loop replaces the JAX package's
``lax.while_loop``; it stops once every sequence has finished.
"""

from __future__ import annotations

import dataclasses

import torch

from videotgb_torch.ops.attention import NEG_INF


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int = 128
    eos_token_id: int = 1
    pad_token_id: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    do_sample: bool = False


def apply_repetition_penalty(logits, generated, penalty: float):
    """Divide positive / multiply negative logits of every token id in
    ``generated`` (B, T) by ``penalty``."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros_like(logits, dtype=torch.bool)
    seen.scatter_(1, generated.long(), True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def top_p_filter(logits, top_p: float):
    """Keep the smallest set of tokens with cumulative probability >= top_p
    (always the top one); the rest get NEG_INF."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, 1, cutoff_idx)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, NEG_INF))


def check_stop_sequences(tokens, t: int, stop_sequences):
    """True where a stop sequence is a suffix of tokens[:, :t+1]."""
    hit = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    for seq in stop_sequences:
        n = len(seq)
        if t < n - 1:
            continue
        window = tokens[:, t - n + 1:t + 1]
        seq_t = torch.tensor(seq, dtype=tokens.dtype, device=tokens.device)
        hit = hit | torch.all(window == seq_t[None, :], dim=-1)
    return hit


def decode(step_fn, caches, start_tokens, config: DecodeConfig,
           generator=None, stop_sequences=()):
    """Greedy / sampling decode. Returns (B, max_new_tokens) int64 ids of
    the tokens after ``start_tokens``, pad after each sequence finishes."""
    cfg = config
    b = start_tokens.shape[0]
    dev = start_tokens.device
    tokens = torch.full((b, cfg.max_new_tokens), cfg.pad_token_id,
                        dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    cur = start_tokens.long()
    for t in range(cfg.max_new_tokens):
        logits, caches = step_fn(cur[:, None], caches, t)
        logits = apply_repetition_penalty(logits.float(), tokens,
                                          cfg.repetition_penalty)
        if cfg.do_sample:
            scaled = logits / max(cfg.temperature, 1e-6)
            scaled = top_p_filter(scaled, cfg.top_p)
            probs = torch.softmax(scaled, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id), nxt)
        tokens[:, t] = nxt
        newly_done = nxt == cfg.eos_token_id
        if stop_sequences:
            newly_done = newly_done | check_stop_sequences(tokens, t,
                                                           stop_sequences)
        finished = finished | newly_done
        cur = nxt
        if bool(finished.all()):
            break
    return tokens
