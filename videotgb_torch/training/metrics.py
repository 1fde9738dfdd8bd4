"""Metrics as functional accumulator dicts (counterpart of
``videotgb_tpu/training/metrics.py``, the same values). States hold 0-d f32
tensors; an update on CUDA tensors keeps its sums on the card, so nothing
syncs until a compute is read on the host.

  Accuracy  — my_metrics.py:6-38   (argmax / top-k over -100-masked targets)
  IoU       — my_metrics.py:40-111 (span mean-IoU + IoU>=0.3 / >=0.5 rates)
  MeanMetric— my_metrics.py:114-129 (running scalar mean; torchmetrics MeanMetric)
  rouge_n   — my_metrics.py:131-179 (token-recall pseudo-label scorer; host-side)
  bleu1     — torchmetrics BLEUScore(n_gram=1) used as val/score
              (reference: LSTP_SF_blip2_module.py:107-119)

In a data-parallel run each rank updates a state on its rows, and
:func:`all_reduce_state` sums the states over the ranks before a compute
(the JAX package's ``all_reduce_state`` under a shard_map).
"""

from __future__ import annotations

import collections
import math
from typing import Iterable, Mapping

import torch

State = dict[str, torch.Tensor]
IGNORE_INDEX = -100


def _zero() -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32)


# ---------------------------------------------------------------- mean metric
def mean_init() -> State:
    return {"total": _zero(), "count": _zero()}


def mean_update(state: State, value, weight=1.0) -> State:
    value = torch.as_tensor(value).to(torch.float32)
    weight = torch.as_tensor(weight, dtype=torch.float32)
    return {"total": state["total"] + value * weight,
            "count": state["count"] + weight}


def mean_compute(state: State) -> torch.Tensor:
    return state["total"] / torch.clamp(state["count"], min=1.0)


def all_reduce_state(state: State) -> State:
    """Each entry of a metric state summed over the ranks (every rank
    calls it); the state itself in one process."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return state
    keys = sorted(state)
    total = torch.stack([torch.as_tensor(state[k], dtype=torch.float32)
                         for k in keys])
    torch.distributed.all_reduce(total)
    return dict(zip(keys, total))


# ------------------------------------------------------------------- accuracy
def accuracy_init() -> State:
    return {"correct": _zero(), "total": _zero()}


def accuracy_update(state: State, logits: torch.Tensor, target: torch.Tensor,
                    topk: int = 1) -> State:
    """logits (N, C) or predictions (N,); targets (N,) with -100 = ignore."""
    valid = target != IGNORE_INDEX
    if logits.dim() == 2:
        if topk == 1:
            hit = torch.argmax(logits, dim=-1) == target
        else:
            top = torch.topk(logits, topk, dim=-1).indices
            hit = torch.any(top == target[:, None], dim=-1)
    else:
        hit = logits == target
    return {"correct": state["correct"] + (hit & valid).sum(),
            "total": state["total"] + valid.sum()}


def accuracy_compute(state: State) -> torch.Tensor:
    return state["correct"] / torch.clamp(state["total"], min=1.0)


# ------------------------------------------------------------------ span IoU
def iou_init() -> State:
    return {"correct": _zero(), "correct_3": _zero(), "correct_5": _zero(),
            "total": _zero()}


def span_iou(start_pred: torch.Tensor, end_pred: torch.Tensor,
             start_target: torch.Tensor, end_target: torch.Tensor
             ) -> torch.Tensor:
    """Elementwise span IoU with the reference's exact branch structure
    (my_metrics.py:89-107): exact match -> 1; disjoint (start_pred >= end_target
    or end_pred <= start_target) -> 0; else inclusive-interval IoU."""
    exact = (start_pred == start_target) & (end_pred == end_target)
    disjoint = (start_pred >= end_target) | (end_pred <= start_target)
    ll = torch.minimum(start_pred, start_target)
    lr = torch.maximum(start_pred, start_target)
    rr = torch.maximum(end_pred, end_target)
    rl = torch.minimum(end_pred, end_target)
    inter = torch.clamp(rl - lr + 1, min=0).to(torch.float32)
    union = (rr - ll + 1).to(torch.float32)
    iou = inter / torch.clamp(union, min=1.0)
    one, zero = torch.ones_like(iou), torch.zeros_like(iou)
    return torch.where(exact, one, torch.where(disjoint, zero, iou))


def iou_update(state: State, start_logits: torch.Tensor,
               end_logits: torch.Tensor, start_target: torch.Tensor,
               end_target: torch.Tensor) -> State:
    """start/end_logits (B, L); targets (B,) with -100 = ignore."""
    valid = (start_target != IGNORE_INDEX) & (end_target != IGNORE_INDEX)
    start_pred = torch.argmax(start_logits, dim=-1)
    end_pred = torch.argmax(end_logits, dim=-1)
    iou = span_iou(start_pred, end_pred, start_target.long(),
                   end_target.long())
    iou = torch.where(valid, iou, torch.zeros_like(iou))
    return {
        "correct": state["correct"] + iou.sum(),
        "correct_3": state["correct_3"] + ((iou >= 0.3) & valid).sum(),
        "correct_5": state["correct_5"] + ((iou >= 0.5) & valid).sum(),
        "total": state["total"] + valid.sum(),
    }


def iou_compute(state: State
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    total = torch.clamp(state["total"], min=1.0)
    return (state["correct"] / total, state["correct_3"] / total,
            state["correct_5"] / total)


# ------------------------------------------------------- host-side text metrics
def rouge_n(
    gold: str | list[str],
    pred: str | list[str],
    ignore: tuple[str, ...] | None = (",", "."),
) -> float | list[float]:
    """Token-recall scorer used to build pseudo span labels.

    Faithful port of my_metrics.py:131-179 including its batch-size division
    quirk in the list branch (each pairwise score is divided by len(gold));
    the downstream monotone-stack span extraction is invariant to that uniform
    scale.
    """
    if isinstance(gold, list):
        scores = []
        for g, p in zip(gold, pred):
            g_tokens, p_tokens = g.split(), p.split()
            hit, total = 0, 0
            for token in g_tokens:
                if ignore is not None and token in ignore:
                    continue
                if token in p_tokens:
                    hit += 1
                total += 1
            score = hit / total if total else 0.0
            if len(gold) > 0:
                score /= len(gold)
            scores.append(score)
        return scores
    g_tokens, p_tokens = gold.split(), pred.split()
    hit, total = 0, 0
    for token in g_tokens:
        if ignore is not None and token in ignore:
            continue
        if token in p_tokens:
            hit += 1
        total += 1
    return hit / total if total else 0.0


def bleu1(preds: Iterable[str], targets: Iterable[Iterable[str] | str]) -> float:
    """Corpus BLEU with unigram precision only (torchmetrics
    BLEUScore(n_gram=1) semantics), the reference's val/test "score"."""
    pred_len = 0
    target_len = 0
    numerator = 0
    denominator = 0
    for pred, refs in zip(preds, targets):
        if isinstance(refs, str):
            refs = [refs]
        pred_tokens = pred.split()
        ref_token_lists = [r.split() for r in refs]
        pred_len += len(pred_tokens)
        # closest reference length
        if ref_token_lists:
            target_len += min(
                (abs(len(r) - len(pred_tokens)), len(r)) for r in ref_token_lists
            )[1]
        pred_counts = collections.Counter(pred_tokens)
        max_ref_counts: collections.Counter = collections.Counter()
        for r in ref_token_lists:
            for tok, cnt in collections.Counter(r).items():
                max_ref_counts[tok] = max(max_ref_counts[tok], cnt)
        numerator += sum(min(cnt, max_ref_counts[tok]) for tok, cnt in pred_counts.items())
        denominator += len(pred_tokens)
    if denominator == 0 or numerator == 0:
        return 0.0
    precision = numerator / denominator
    brevity = 1.0 if pred_len > target_len else math.exp(1 - target_len / max(pred_len, 1))
    return brevity * precision


# ------------------------------------------------------------- metric bundles
class MetricBag:
    """A named collection of metric states with uniform reset/compute, the
    stand-in for the per-module torchmetrics attributes
    (reference: LSTP_SF_blip2_module.py:107-119)."""

    INITS = {"mean": mean_init, "accuracy": accuracy_init, "iou": iou_init}
    COMPUTES = {"mean": mean_compute, "accuracy": accuracy_compute, "iou": iou_compute}

    def __init__(self, spec: Mapping[str, str]):
        self.spec = dict(spec)
        self.states: dict[str, State] = {}
        self.reset()

    def reset(self) -> None:
        self.states = {name: self.INITS[kind]() for name, kind in self.spec.items()}

    def compute(self) -> dict[str, object]:
        out: dict[str, object] = {}
        for name, state in self.states.items():
            value = self.COMPUTES[self.spec[name]](state)
            out[name] = (tuple(float(v) for v in value)
                         if isinstance(value, tuple) else float(value))
        return out
