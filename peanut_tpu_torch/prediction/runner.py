"""Iteration-based training runner (port of
``peanut_tpu.prediction.runner``; mmcv's IterBasedRunner and its hooks as
the reference uses them).

Every ``log_interval`` iterations one record of the window's mean losses,
the time an iteration and the ETA goes to the loggers and to
``work_dir/train_log.jsonl``; every ``checkpoint_interval`` iterations and
at the end a checkpoint goes to ``work_dir/iter_N``; a new runner resumes
from the latest one.  The losses stay on the device until a log record
reads them (one synchronisation a window).  In a process group only rank
0 writes logs and checkpoints (mmcv's hooks are rank-0-only); every rank
resumes from the latest checkpoint in ``work_dir``, so they must share it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Optional

import torch

from ..core.checkpoint import (find_latest_checkpoint, load_checkpoint,
                               save_checkpoint)
from ..core.mesh import rank
from .train import TrainConfig, TrainState

logger = logging.getLogger("peanut_tpu_torch")


class IterRunner:
    def __init__(self, step_fn, state: TrainState, loader: Iterable,
                 cfg: TrainConfig, work_dir: str, auto_resume: bool = True,
                 eval_hook=None, loggers=None):
        """``step_fn(state, batch) -> {name: loss}`` advances ``state`` by
        one step (``train.make_train_step``)."""
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.cfg = cfg
        self.eval_hook = eval_hook    # prediction.metrics.EvalHook or None
        if loggers is None:
            from ..utils.loggers import TextLoggerHook
            loggers = [TextLoggerHook()]
        self.loggers = loggers
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.log_path = os.path.join(work_dir, "train_log.jsonl")
        self.resumed_from = None
        if auto_resume:
            latest = find_latest_checkpoint(work_dir)
            if latest:
                step = load_checkpoint(latest, self.state)
                self.resumed_from = latest
                logger.info("resumed from %s (iter %s)", latest, step)

    def _append(self, rec: Dict) -> None:
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def run(self, max_iters: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        max_iters = max_iters or cfg.max_iters
        window: Dict[str, list] = {}
        t_start = t_window = time.time()
        it = self.state.step
        primary = rank() == 0
        data_iter = iter(self.loader)
        try:
            while it < max_iters:
                metrics = self.step_fn(self.state, next(data_iter))
                it += 1
                for k, v in metrics.items():
                    window.setdefault(k, []).append(v)
                if it % cfg.log_interval == 0:
                    means = {k: float(torch.stack(v).float().mean())
                             for k, v in window.items()}
                    window.clear()
                    dt = time.time() - t_window
                    t_window = time.time()
                    ips = cfg.log_interval / dt
                    rec = {"iter": it, "time_per_iter": round(1.0 / ips, 4),
                           "eta_min": round((max_iters - it)
                                            / max(ips, 1e-9) / 60, 1),
                           **{k: round(v, 5) for k, v in means.items()}}
                    if primary:
                        for hook in self.loggers:
                            hook.log(rec)
                        self._append(rec)
                if self.eval_hook is not None:
                    res = self.eval_hook.maybe_run(it, self.state)
                    if res and primary:
                        logger.info("eval@%d: %s", it, res)
                        self._append({"iter": it, "eval": res})
                if primary and (it % cfg.checkpoint_interval == 0
                                or it == max_iters):
                    path = os.path.join(self.work_dir, f"iter_{it}")
                    save_checkpoint(path, self.state, step=it)
                    logger.info("checkpoint -> %s", path)
        finally:
            close = getattr(data_iter, "close", None)
            if close is not None:
                close()              # stops a PrefetchLoader's threads
        logger.info("training done: %d iters in %.1f min", max_iters,
                    (time.time() - t_start) / 60)
        return self.state
