"""Run logging (the port's copy of ``videotgb_tpu/utils/logging.py``;
reference: src/utils/pylogger.py, rich_utils.py). In a multi-process run
only rank 0 logs (the reference's rank_zero_only)."""

from __future__ import annotations

import logging
import sys
from typing import Any, Mapping

_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"


def is_process_zero() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


class _RankZeroFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return is_process_zero()


# run-scoped extra handlers (the per-run job log file, hydra
# job_logging.handlers.file analogue): every videotgb_torch.* logger — the loggers
# don't propagate — gets each handler attached, including loggers created
# after the handler was registered (get_logger re-checks on every call).
_EXTRA_HANDLERS: list[logging.Handler] = []


def get_logger(name: str = "videotgb_torch") -> logging.Logger:
    """A ``videotgb_torch*`` logger writing to stderr and to the run's job log
    on process 0 only (reference src/utils/pylogger.py:6-21)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        handler.addFilter(_RankZeroFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    for extra in _EXTRA_HANDLERS:
        if extra not in logger.handlers:
            logger.addHandler(extra)
    return logger


def add_file_handler(path: str) -> logging.Handler:
    """Attach a job-log file handler to every ``videotgb_torch*`` logger,
    present and future (the reference's hydra job_logging file handler,
    configs/hydra/default.yaml:17-21). Returns the handler; pass it to
    :func:`remove_file_handler` when the run ends."""
    handler = logging.FileHandler(path)
    handler.setFormatter(
        logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    handler.addFilter(_RankZeroFilter())
    _EXTRA_HANDLERS.append(handler)
    for name, logger in logging.Logger.manager.loggerDict.items():
        if name.startswith("videotgb_torch") and isinstance(logger, logging.Logger):
            if handler not in logger.handlers:
                logger.addHandler(handler)
    return handler


def job_log_paths() -> list[str]:
    """The files the run-scoped handlers write (a spawned rank attaches
    them again: a new process has none)."""
    return [h.baseFilename for h in _EXTRA_HANDLERS
            if isinstance(h, logging.FileHandler)]


def remove_file_handler(handler: logging.Handler) -> None:
    if handler in _EXTRA_HANDLERS:
        _EXTRA_HANDLERS.remove(handler)
    for name, logger in logging.Logger.manager.loggerDict.items():
        if name.startswith("videotgb_torch") and isinstance(logger, logging.Logger):
            if handler in logger.handlers:
                logger.removeHandler(handler)
    handler.close()


def print_config_tree(cfg: Mapping[str, Any], logger: logging.Logger | None = None) -> str:
    """Plain-text config tree (reference prints a rich tree,
    src/utils/rich_utils.py:18-75)."""
    lines: list[str] = []

    def walk(node: Any, indent: int) -> None:
        pad = "  " * indent
        if isinstance(node, Mapping):
            for key, value in node.items():
                if isinstance(value, (Mapping, list)):
                    lines.append(f"{pad}{key}:")
                    walk(value, indent + 1)
                else:
                    lines.append(f"{pad}{key}: {value}")
        elif isinstance(node, list):
            for value in node:
                lines.append(f"{pad}- {value}")

    walk(cfg, 0)
    text = "\n".join(lines)
    (logger or get_logger()).info("config:\n%s", text)
    return text
