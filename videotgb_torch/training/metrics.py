"""Host-side text metrics (the port's copy of ``rouge_n`` from
``videotgb_tpu/training/metrics.py``, same scores). The rest of that module
is training-state code; it comes with the trainer's evaluation (ROADMAP.md
queue 1 item 4).
"""

from __future__ import annotations


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
