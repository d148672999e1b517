"""Training logger hooks (port of ``peanut_tpu.utils.loggers``; mmseg's
TextLoggerHook / MMSegWandbHook).

The runner writes ``train_log.jsonl`` itself; these hooks are further
sinks: a console formatter, and a wandb sink that is a no-op (with a
one-time notice) where wandb is not installed.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List

logger = logging.getLogger("peanut_tpu_torch")


class LoggerHook:
    def log(self, record: Dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class TextLoggerHook(LoggerHook):
    """Console formatter in the reference's text log shape."""

    def log(self, record: Dict) -> None:
        parts = [f"Iter [{record.get('iter', '?')}]"]
        for k, v in record.items():
            if k == "iter":
                continue
            parts.append(f"{k}: {v:.4f}" if isinstance(v, float) else
                         f"{k}: {v}")
        logger.info(", ".join(parts))


class WandbLoggerHook(LoggerHook):
    """W&B sink; a no-op where wandb is not installed."""

    def __init__(self, project: str = "peanut-tpu", **init_kw):
        try:
            import wandb
        except ImportError:
            logger.info("wandb not installed; WandbLoggerHook is a no-op")
            self._wandb = self._run = None
            return
        self._run = wandb.init(project=project, **init_kw)
        self._wandb = wandb

    def log(self, record: Dict) -> None:
        if self._run is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "iter"},
                            step=record.get("iter"))


class CompositeLogger(LoggerHook):
    def __init__(self, hooks: List[LoggerHook]):
        self.hooks = hooks

    def log(self, record: Dict) -> None:
        for h in self.hooks:
            h.log(record)


def read_train_log(path: str) -> List[Dict]:
    """The records of a runner's ``train_log.jsonl``."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
