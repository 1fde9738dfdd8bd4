"""Experiment metric writers: CSV, TensorBoard, W&B (availability-gated);
the port's copy of ``videotgb_tpu/utils/writers.py``, the same files.

The reference wires any subset of 7 Lightning loggers via hydra
(reference: configs/logger/*.yaml — wandb project "LSTP-Chat", tensorboard,
csv, ...). Here a writer is a small object with ``log_metrics(dict, step)``
and ``log_hyperparams(dict)``; :func:`build_writers` instantiates whatever
the environment supports and MultiWriter fans out (the many_loggers
analogue). In a multi-process run only rank 0 writes: the other ranks'
:func:`build_writers` is an empty MultiWriter.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Mapping

from videotgb_torch.utils.logging import get_logger, is_process_zero

log = get_logger("videotgb_torch.writers")


class CSVWriter:
    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.csv")
        self._fields: list[str] = []
        if os.path.exists(self.path):  # resume: adopt the existing header
            with open(self.path) as f:
                reader = csv.reader(f)
                self._fields = next(reader, []) or []

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        with open(os.path.join(os.path.dirname(self.path), "hparams.json"), "w") as f:
            json.dump(dict(params), f, indent=2, default=str)

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        new_fields = [k for k in row if k not in self._fields]
        rewrite = bool(new_fields) and os.path.exists(self.path)
        self._fields += new_fields
        if rewrite:
            with open(self.path) as f:
                rows = list(csv.DictReader(f))
        else:
            rows = []
        mode = "w" if rewrite or not os.path.exists(self.path) else "a"
        with open(self.path, mode, newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields)
            if mode == "w":
                writer.writeheader()
                for r in rows:
                    writer.writerow(r)
            writer.writerow(row)

    def finish(self) -> None:
        pass


class TensorBoardWriter:
    def __init__(self, directory: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(directory)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._writer.add_text("hparams", json.dumps(dict(params), default=str))

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        for key, value in metrics.items():
            self._writer.add_scalar(key, float(value), step)

    def finish(self) -> None:
        self._writer.close()


class WandbWriter:
    def __init__(self, project: str = "LSTP-Chat", **kwargs):
        import wandb

        self._run = wandb.init(project=project, **kwargs)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._run.config.update(dict(params), allow_val_change=True)

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        self._run.log(dict(metrics), step=step)

    def finish(self) -> None:
        self._run.finish()


class AimWriter:
    """Aim run tracker (reference configs/logger/aim.yaml). Import-guarded:
    build_writers degrades to a warning when the lib is absent."""

    def __init__(self, repo: str | None = None, experiment: str = "LSTP-Chat"):
        import aim

        self._run = aim.Run(repo=repo, experiment=experiment)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._run["hparams"] = json.loads(json.dumps(dict(params), default=str))

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        for key, value in metrics.items():
            self._run.track(float(value), name=key, step=step)

    def finish(self) -> None:
        self._run.close()


class CometWriter:
    """Comet-ML experiment (reference configs/logger/comet.yaml)."""

    def __init__(self, project_name: str = "LSTP-Chat", **kwargs):
        import comet_ml

        self._exp = comet_ml.Experiment(project_name=project_name, **kwargs)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._exp.log_parameters(dict(params))

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        self._exp.log_metrics(dict(metrics), step=step)

    def finish(self) -> None:
        self._exp.end()


class MLFlowWriter:
    """MLflow run (reference configs/logger/mlflow.yaml)."""

    def __init__(self, experiment_name: str = "LSTP-Chat",
                 tracking_uri: str | None = None):
        import mlflow

        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment_name)
        self._run = mlflow.start_run()

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        # mlflow rejects non-scalar params; stringify like its own autolog
        self._mlflow.log_params({k: str(v)[:500] for k, v in params.items()})

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        self._mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items()}, step=step)

    def finish(self) -> None:
        self._mlflow.end_run()


class NeptuneWriter:
    """Neptune run (reference configs/logger/neptune.yaml)."""

    def __init__(self, project: str | None = None, **kwargs):
        import neptune

        self._run = neptune.init_run(project=project, **kwargs)

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        self._run["hparams"] = json.dumps(dict(params), default=str)

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        for key, value in metrics.items():
            self._run[key].append(float(value), step=step)

    def finish(self) -> None:
        self._run.stop()


class MultiWriter:
    def __init__(self, writers: list):
        self.writers = writers

    def log_hyperparams(self, params: Mapping[str, Any]) -> None:
        for w in self.writers:
            w.log_hyperparams(params)

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        for w in self.writers:
            w.log_metrics(metrics, step)

    def finish(self) -> None:
        for w in self.writers:
            w.finish()


def build_writers(names: list[str], output_dir: str, **kwargs) -> MultiWriter:
    writers = []
    for name in (names if is_process_zero() else ()):
        try:
            if name == "csv":
                writers.append(CSVWriter(os.path.join(output_dir, "csv")))
            elif name == "tensorboard":
                writers.append(TensorBoardWriter(os.path.join(output_dir, "tb")))
            elif name == "wandb":
                writers.append(WandbWriter(**kwargs))
            elif name == "aim":
                writers.append(AimWriter(**kwargs))
            elif name == "comet":
                writers.append(CometWriter(**kwargs))
            elif name == "mlflow":
                writers.append(MLFlowWriter(**kwargs))
            elif name == "neptune":
                writers.append(NeptuneWriter(**kwargs))
            else:
                log.warning("unknown writer %s skipped", name)
        except Exception as e:
            log.warning("writer %s unavailable: %s", name, e)
    return MultiWriter(writers)
