"""Hyperparameter search (the Optuna-multirun analogue; the port's copy of
the JAX package's ``utils/sweep.py``, running ``videotgb_torch.train``).

The reference sweeps with hydra's Optuna TPE plugin
(reference: configs/hparams_search/videoinstruct_optuna.yaml). This module
needs no Optuna: it implements the same samplers natively over the
same override grammar: a sweep spec maps dotted config keys to choices /
ranges, each trial composes the config with those overrides, runs the train
entry, and the best trial by the optimized metric wins.

Samplers: ``tpe`` (default, matching the reference's Optuna TPESampler —
after ``n_startup`` random trials, completed trials split into a good
gamma-quantile and the rest; numeric params maximize the KDE density ratio
l(x)/g(x) over candidates drawn from the good model, categorical params the
smoothed count ratio) and ``random``.

Usage:
    python -m videotgb_torch.utils.sweep --trials 8 --metric val/iou_score \\
        --mode max --sampler tpe experiment=smoke_tg_synthetic \\
        "sweep.model.optimizer.lr=loguniform(1e-5,1e-3)" \\
        "sweep.data.batch_size=choice(2,4)"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import random
import re
import sys
from typing import Any, Callable

from videotgb_torch.utils.logging import get_logger
from videotgb_torch.utils.task import get_metric_value

log = get_logger("videotgb_torch.sweep")

_CHOICE = re.compile(r"choice\((.+)\)")
_UNIFORM = re.compile(r"uniform\(([^,]+),([^)]+)\)")
_LOGUNIFORM = re.compile(r"loguniform\(([^,]+),([^)]+)\)")


@dataclasses.dataclass(frozen=True)
class Space:
    """One hyperparameter's domain; callable = draw a random sample."""

    kind: str  # "choice" | "uniform" | "loguniform" | "const"
    options: tuple = ()
    lo: float = 0.0
    hi: float = 1.0

    def __call__(self, rng: random.Random) -> Any:
        if self.kind == "choice":
            return rng.choice(self.options)
        if self.kind == "uniform":
            return rng.uniform(self.lo, self.hi)
        if self.kind == "loguniform":
            return math.exp(rng.uniform(math.log(self.lo), math.log(self.hi)))
        return self.options[0]


def parse_space(spec: str) -> Space:
    if m := _CHOICE.match(spec):
        return Space("choice",
                     tuple(_literal(x) for x in m.group(1).split(",")))
    if m := _UNIFORM.match(spec):
        return Space("uniform", lo=float(m.group(1)), hi=float(m.group(2)))
    if m := _LOGUNIFORM.match(spec):
        return Space("loguniform", lo=float(m.group(1)), hi=float(m.group(2)))
    return Space("const", (_literal(spec),))


def _literal(text: str) -> Any:
    text = text.strip()
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def _kde_score(x: float, centers: list[float], sigma: float) -> float:
    if not centers:
        return 1.0
    return sum(
        math.exp(-0.5 * ((x - c) / sigma) ** 2) for c in centers
    ) / (len(centers) * sigma)


def tpe_suggest(
    space: dict[str, Space],
    completed: list[dict],
    rng: random.Random,
    gamma: float = 0.25,
    n_startup: int = 4,
    n_ei: int = 24,
) -> dict:
    """One TPE suggestion. ``completed`` = [{"params", "value"}] with value
    already oriented so LARGER IS BETTER (caller negates for mode=min)."""
    if len(completed) < n_startup:
        return {k: s(rng) for k, s in space.items()}
    ranked = sorted(completed, key=lambda h: -h["value"])
    n_good = max(1, math.ceil(gamma * len(ranked)))
    good, bad = ranked[:n_good], ranked[n_good:]

    out = {}
    for key, s in space.items():
        gvals = [h["params"][key] for h in good]
        bvals = [h["params"][key] for h in bad]
        if s.kind in ("const",):
            out[key] = s(rng)
            continue
        if s.kind == "choice":
            n_opt = len(s.options)
            prior = 1.0 / n_opt
            ratios = []
            for opt in s.options:
                lg = (gvals.count(opt) + prior) / (len(gvals) + 1.0)
                lb = (bvals.count(opt) + prior) / (len(bvals) + 1.0)
                ratios.append(lg / lb)
            # sample candidates from the good model, keep the best ratio
            # (pure argmax would never explore)
            weights = [(gvals.count(o) + prior) for o in s.options]
            cands = rng.choices(range(n_opt), weights=weights, k=n_ei)
            out[key] = s.options[max(cands, key=lambda i: ratios[i])]
            continue
        # numeric: KDE density ratio in the (log-)transformed domain
        tf = math.log if s.kind == "loguniform" else (lambda v: v)
        itf = math.exp if s.kind == "loguniform" else (lambda v: v)
        lo, hi = tf(s.lo), tf(s.hi)
        g = [tf(v) for v in gvals]
        b = [tf(v) for v in bvals]
        width = hi - lo
        sig_g = max(width * 1.06 * max(len(g), 1) ** -0.2, width * 0.05)
        sig_b = max(width * 1.06 * max(len(b), 1) ** -0.2, width * 0.05)

        def score(x):
            lg = _kde_score(x, g, sig_g) + 1e-12
            lb = _kde_score(x, b, sig_b) + 1e-12
            return lg / lb

        best_x, best_s = None, -math.inf
        for _ in range(n_ei):
            center = rng.choice(g) if g else rng.uniform(lo, hi)
            x = min(max(rng.gauss(center, sig_g), lo), hi)
            sc = score(x)
            if sc > best_s:
                best_x, best_s = x, sc
        out[key] = itf(best_x)
    return out


def run_sweep(
    base_overrides: list[str],
    space: dict[str, Callable],
    trials: int,
    metric: str,
    mode: str = "max",
    seed: int = 0,
    train_fn: Callable | None = None,
    sampler: str = "tpe",
) -> dict:
    if train_fn is None:
        from videotgb_torch.config import compose
        from videotgb_torch.train import CONFIG_DIR, train
        from videotgb_torch.utils.task import setup_run_dir

        # multirun dirs (reference configs/hydra/default.yaml:12-15): all
        # trials share one dated sweep dir, each trial writes into
        # <sweep_dir>/<job_num>. The sweep dir is frozen at the first trial
        # (each compose() re-stamps ${now:...}; trials must not scatter).
        sweep_state = {"dir": None, "job": 0}

        def train_fn(overrides):
            cfg = compose(CONFIG_DIR, "train", overrides)
            hydra_cfg = cfg.get("hydra")
            if hydra_cfg is not None:
                if sweep_state["dir"] is None:
                    sweep_state["dir"] = hydra_cfg["sweep"]["dir"]
                setup_run_dir(cfg, job_name="train", overrides=overrides,
                              multirun_dir=sweep_state["dir"],
                              job_num=sweep_state["job"])
                sweep_state["job"] += 1
            return train(cfg)

    rng = random.Random(seed)
    best = None
    history = []
    sign = 1.0 if mode == "max" else -1.0
    for trial in range(trials):
        if sampler == "tpe":
            completed = [
                {"params": h["params"], "value": sign * h["value"]}
                for h in history if "value" in h
            ]
            sampled = tpe_suggest(space, completed, rng)
        else:
            sampled = {k: fn(rng) for k, fn in space.items()}
        overrides = base_overrides + [f"{k}={v}" for k, v in sampled.items()]
        log.info("trial %d/%d: %s", trial + 1, trials, sampled)
        try:
            metrics = train_fn(overrides)
            value = get_metric_value(metrics, metric)
        except Exception as e:
            log.error("trial %d failed: %s", trial + 1, e)
            history.append({"params": sampled, "error": str(e)})
            continue
        history.append({"params": sampled, "value": value})
        better = (
            best is None
            or (mode == "max" and value > best["value"])
            or (mode == "min" and value < best["value"])
        )
        if better:
            best = {"params": sampled, "value": value}
    result = {"best": best, "history": history, "metric": metric}
    log.info("sweep done: best=%s", best)
    return result


def main(argv: list[str] | None = None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser()
    parser.add_argument("--trials", type=int, default=8)
    parser.add_argument("--metric", default="val/iou_score")
    parser.add_argument("--mode", choices=["max", "min"], default="max")
    parser.add_argument("--sampler", choices=["tpe", "random"], default="tpe")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", default=None)
    args, rest = parser.parse_known_args(argv)

    space = {}
    base = []
    for item in rest:
        key, _, value = item.partition("=")
        if key.startswith("sweep."):
            space[key[len("sweep."):]] = parse_space(value)
        else:
            base.append(item)
    result = run_sweep(base, space, args.trials, args.metric, args.mode,
                       args.seed, sampler=args.sampler)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2, default=str)
    return result


if __name__ == "__main__":
    main()
