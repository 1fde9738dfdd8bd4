"""Autoregressive decode: greedy and temperature / top-p sampling with HF
repetition penalty and per-sequence early stop on EOS or stop sequences
(:func:`decode`), and beam search with HF's done-hypotheses semantics
(:func:`beam_search`, ``num_beams`` > 1, ``length_penalty``).

Model-agnostic: the caller passes ``step_fn(tokens (B, 1), caches, index)``
-> (logits (B, V), caches); caches are nested lists / dicts of tensors
whose axis 0 is the batch, which beam search reorders every step. The
output buffer is (B, max_new_tokens) padded with pad_token_id after EOS.
:func:`decode` steps on a device index in chunks that a CUDA graph captures
(``utils/graphs.py``), with one host read a chunk; beam search keeps a
Python loop with a host index and one host read a step.
"""

from __future__ import annotations

import dataclasses

import torch

from videotgb_torch.ops.attention import NEG_INF
from videotgb_torch.parallel.sharding import all_ranks, global_draw


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int = 128
    eos_token_id: int = 1
    pad_token_id: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    num_beams: int = 1
    length_penalty: float = 1.0
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


def check_stop_sequences(tokens, t, stop_sequences):
    """True where a stop sequence is a suffix of tokens[:, :t+1]. ``t`` is
    a host int or a 0-dim int64 device tensor (the window is then gathered
    at the device index, as the JAX package's ``dynamic_slice``)."""
    b = tokens.shape[0]
    hit = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    for seq in stop_sequences:
        n = len(seq)
        if not torch.is_tensor(t):
            if t < n - 1:
                continue
            window = tokens[:, t - n + 1:t + 1]
            match = torch.ones_like(hit)
        else:
            pos = (t - n + 1 + torch.arange(n, device=tokens.device)
                   ).clamp(min=0)
            window = torch.gather(tokens, 1, pos[None].expand(b, n))
            match = (t >= n - 1).expand(b)
        for j, tok in enumerate(seq):  # ints: no host-to-device copy
            match = match & (window[:, j] == tok)
        hit = hit | match
    return hit


# decode steps per captured chunk: on the card one CUDA graph of CHUNK
# steps serves every chunk of a call, and the host tests the finish flag
# once a chunk
CHUNK = 8


def _next_token(logits, tokens, cfg: DecodeConfig, generator):
    """The next ids (B,) from step logits: repetition penalty, then argmax,
    or temperature, top-p and a draw. The draw is ``torch.multinomial``'s
    own for one sample (argmax of p / q, q ~ Exp(1) from ``generator``),
    without its host-side checks of the probabilities: the same ids for the
    same generator state, and nothing a CUDA-graph capture refuses. Under
    a data-parallel split the draw is this rank's rows of the global
    batch's (``parallel.sharding.global_draw``)."""
    logits = apply_repetition_penalty(logits.float(), tokens,
                                      cfg.repetition_penalty)
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(cfg.temperature, 1e-6)
    scaled = top_p_filter(scaled, cfg.top_p)
    probs = torch.softmax(scaled, dim=-1)
    q = global_draw(lambda shape: torch.empty(
        shape, device=probs.device).exponential_(1, generator=generator),
        probs.shape)
    return torch.argmax(probs / q, dim=-1)


def _buffers(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _buffers(v)]
    return []


def decode(step_fn, caches, start_tokens, config: DecodeConfig,
           generator=None, stop_sequences=()):
    """Greedy / sampling decode (the JAX package's ``lax.while_loop``).
    Returns (B, max_new_tokens) int64 ids of the tokens after
    ``start_tokens``, pad after each sequence finishes.

    Step 0 calls ``step_fn`` with the host int 0 (the T5 cross prefill, the
    LLaMA prefill's logits); the later steps run in chunks of ``CHUNK`` (or
    of the steps left, when fewer) through ``utils.graphs.loop``, their
    index a 0-dim int64 device tensor advanced on the device, and
    ``step_fn`` must write its caches in place. Once every row has
    finished, or the horizon is reached, the loop stops after its chunk: a
    finished row writes pad, and steps past the horizon write columns and a
    cache slot (the last) that nothing reads, so the ids equal a
    step-by-step loop's for any ``CHUNK``."""
    from videotgb_torch.utils.graphs import loop

    cfg = config
    b = start_tokens.shape[0]
    dev = start_tokens.device
    n = cfg.max_new_tokens
    k = max(min(CHUNK, n - 1), 1)  # a short decode takes one short chunk
    chunks = -(-(n - 1) // k)
    tokens = torch.full((b, 1 + chunks * k), cfg.pad_token_id,
                        dtype=torch.long, device=dev)
    logits, caches = step_fn(start_tokens.long()[:, None], caches, 0)
    cur = _next_token(logits, tokens, cfg, generator)
    tokens[:, 0] = cur
    finished = cur == cfg.eos_token_id
    if stop_sequences:
        finished = finished | check_stop_sequences(tokens, 0, stop_sequences)
    t = torch.ones((), dtype=torch.long, device=dev)
    held = _buffers(caches)

    def chunk():
        for _ in range(k):
            logits, new_caches = step_fn(cur[:, None], caches,
                                         t.clamp(max=n - 1))
            if any(x is not y for x, y in zip(_buffers(new_caches), held)):
                raise ValueError("decode: step_fn must write its caches in "
                                 "place after step 0")
            nxt = _next_token(logits, tokens, cfg, generator)
            nxt = torch.where(finished, cfg.pad_token_id, nxt)
            tokens.scatter_(1, t.expand(b, 1), nxt[:, None])
            done = nxt == cfg.eos_token_id
            if stop_sequences:
                done = done | check_stop_sequences(tokens, t, stop_sequences)
            finished.logical_or_(done)
            cur.copy_(nxt)
            t.add_(1)
        return finished.all()

    if chunks:
        loop(chunk, chunks)
    return tokens[:, :n]


def _insert_hypothesis(d_scores, d_tokens, d_count, accept, score, hyp, k):
    """Where ``accept``, insert one hypothesis per sample into the k-slot
    done set, replacing the current worst (HF ``BeamHypotheses.add``: keep
    the best k by length-penalized score; empty slots hold NEG_INF, so the
    first minimum fills them first)."""
    worst = torch.argmin(d_scores, dim=1)
    worst_score = d_scores.min(dim=1).values
    accept = accept & ((d_count < k) | (score > worst_score))
    slot = (torch.nn.functional.one_hot(worst, k).bool()
            & accept[:, None])
    d_scores = torch.where(slot, score[:, None], d_scores)
    d_tokens = torch.where(slot[..., None], hyp[:, None, :], d_tokens)
    d_count = torch.clamp(d_count + accept.long(), max=k)
    return d_scores, d_tokens, d_count


def _reorder_caches(caches, index):
    """Every tensor of the nested lists / dicts ``caches`` gathered along
    its batch axis 0 by ``index``."""
    if torch.is_tensor(caches):
        return caches.index_select(0, index)
    if isinstance(caches, dict):
        return {k: _reorder_caches(v, index) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(_reorder_caches(v, index) for v in caches)
    return caches


def beam_search(step_fn, caches, start_tokens, config: DecodeConfig,
                penalty_length_offset: int = 1):
    """Beam search with HF done-hypotheses semantics (transformers
    ``BeamSearchScorer`` / ``BeamHypotheses``, ``early_stopping=False``):

    * each step ranks the top 2k candidates of (beam score + logp) over
      k x V, ties to the lower index as ``jax.lax.top_k`` breaks them;
    * candidates ending in EOS that rank within the top k retire into a
      per-sample done set, scored ``sum_logp / (t + offset) **
      length_penalty`` at the step they finish;
    * the k best non-EOS candidates continue as live beams;
    * a finished sample freezes its beams, extending them with pad;
    * a sample stops once k hypotheses are done and the best live beam,
      normalized at the current length, can no longer beat the worst;
    * at the horizon, live beams of unfinished samples join the done set
      normalized at ``t - 1 + offset``, and the best done hypothesis is
      returned.

    ``caches`` must already hold B * num_beams rows (repeat the batch per
    beam before building them); ``start_tokens`` is (B,). The repetition
    penalty reads each beam's own tokens. Stop sequences do not apply.
    Returns (B, max_new_tokens) int64, EOS at the finishing position, pad
    after."""
    cfg = config
    b = start_tokens.shape[0]
    k = cfg.num_beams
    horizon = cfg.max_new_tokens
    dev = start_tokens.device
    batch_iota = torch.arange(b, device=dev)
    beam_iota = torch.arange(k, device=dev)[None, :]

    tokens = torch.full((b * k, horizon), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    # beam 0 live, the others at NEG_INF: the first step seeds k distinct
    # tokens from beam 0
    scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b)
    cur = start_tokens.long().repeat_interleave(k)
    d_scores = torch.full((b, k), NEG_INF, device=dev)
    d_tokens = torch.full((b, k, horizon), cfg.pad_token_id,
                          dtype=torch.long, device=dev)
    d_count = torch.zeros(b, dtype=torch.long, device=dev)
    b_done = torch.zeros(b, dtype=torch.bool, device=dev)

    steps = 0
    for t in range(horizon):
        steps = t + 1
        logits, caches = step_fn(cur[:, None], caches, t)
        logits = apply_repetition_penalty(logits.float(), tokens,
                                          cfg.repetition_penalty)
        logp = torch.log_softmax(logits, dim=-1)
        v = logp.shape[-1]
        cand = (scores[:, None] + logp).reshape(b, k * v)
        top_scores, top_idx = torch.sort(cand, dim=1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :2 * k], top_idx[:, :2 * k]
        src2k = top_idx // v
        tok2k = top_idx % v
        is_eos = tok2k == cfg.eos_token_id
        pen = float(t + penalty_length_offset) ** cfg.length_penalty

        # retire EOS candidates ranked within the top k
        for j in range(k):
            hyp = tokens[batch_iota * k + src2k[:, j]].clone()
            hyp[:, t] = cfg.eos_token_id
            d_scores, d_tokens, d_count = _insert_hypothesis(
                d_scores, d_tokens, d_count, is_eos[:, j] & ~b_done,
                top_scores[:, j] / pen, hyp, k)

        # the k best non-EOS candidates continue (2k candidates hold at
        # most k EOS entries, one per source beam)
        live = ~is_eos
        rank_live = torch.cumsum(live.long(), dim=1) - 1
        pick = torch.stack(
            [(live & (rank_live == s)).int().argmax(dim=1) for s in range(k)],
            dim=1)
        new_scores = torch.gather(top_scores, 1, pick)
        src_sel = torch.gather(src2k, 1, pick)
        tok_sel = torch.gather(tok2k, 1, pick)

        # finished samples freeze: beams stay in place, extended with pad
        frozen = b_done[:, None]
        src_sel = torch.where(frozen, beam_iota, src_sel)
        tok_sel = torch.where(frozen, cfg.pad_token_id, tok_sel)
        new_scores = torch.where(frozen, scores.reshape(b, k), new_scores)

        flat_src = (batch_iota[:, None] * k + src_sel).reshape(-1)
        tokens = tokens[flat_src]
        caches = _reorder_caches(caches, flat_src)
        cur = tok_sel.reshape(-1)
        tokens[:, t] = cur
        scores = new_scores.reshape(-1)

        # HF's early-stop heuristic (early_stopping=False) on the best live
        # beam at the current length
        best_possible = new_scores[:, 0] / pen
        b_done = b_done | ((d_count >= k)
                           & (d_scores.min(dim=1).values >= best_possible))
        if bool(all_ranks(b_done.all())):
            break

    # hitting the horizon stops inside the last step, so the live beams
    # normalize at the length of that step's EOS retirements
    pen = float(steps - 1 + penalty_length_offset) ** cfg.length_penalty
    scores_bk = scores.reshape(b, k)
    tokens_bk = tokens.reshape(b, k, horizon)
    for s in range(k):
        d_scores, d_tokens, d_count = _insert_hypothesis(
            d_scores, d_tokens, d_count, ~b_done, scores_bk[:, s] / pen,
            tokens_bk[:, s], k)
    return d_tokens[batch_iota, torch.argmax(d_scores, dim=1)]
