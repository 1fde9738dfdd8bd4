"""Recompute judge statistics from saved judgments.

Port of eval/debug.py (reference: eval/debug.py:1-33 — reload results.json
and recompute yes/no accuracy + mean score without re-querying the judge).

The port's copy of ``videotgb_tpu/evalsuite/debug.py``.

Usage: python -m videotgb_torch.evalsuite.debug --output_dir results/judged
   or: python -m videotgb_torch.evalsuite.debug --combined results/combined.json
"""

from __future__ import annotations

import argparse
import json

from videotgb_torch.evalsuite.evaluate import combine_and_score


def stats_from_combined(path: str) -> dict:
    with open(path) as f:
        combined = json.load(f)
    score_sum = count = yes = no = 0
    for result, _ in combined.values():
        try:
            count += 1
            score_sum += int(result["score"])
            pred = str(result["pred"]).lower()
            if "yes" in pred:
                yes += 1
            elif "no" in pred:
                no += 1
        except Exception:
            continue
    return {
        "yes_count": yes, "no_count": no,
        "accuracy": yes / max(yes + no, 1),
        "average_score": score_sum / max(count, 1),
        "count": count,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default=None,
                   help="per-id judgment dir (recombines)")
    p.add_argument("--combined", default=None, help="combined.json path")
    args = p.parse_args(argv)
    if args.combined:
        stats = stats_from_combined(args.combined)
    elif args.output_dir:
        stats = combine_and_score(args.output_dir)
    else:
        raise SystemExit("pass --output_dir or --combined")
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
