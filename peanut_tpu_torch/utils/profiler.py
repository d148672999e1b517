"""Per-stage wall-clock timers for the runtime's tick pipeline (a copy of
``peanut_tpu.utils.profiler.StageTimer``).

A stage's time is host wall clock.  Device work is asynchronous, so a stage
that only enqueues kernels reads short and the wait lands in the stage that
first needs a device result (``tick_wait`` in the batched runtime).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict

import numpy as np


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough to leave on."""

    def __init__(self):
        self.samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':<28}{'count':>7}{'mean ms':>10}{'p95 ms':>10}"
                 f"{'total s':>10}"]
        for name, s in rows:
            lines.append(f"{name:<28}{s['count']:>7}{s['mean_ms']:>10.2f}"
                         f"{s['p95_ms']:>10.2f}{s['total_s']:>10.2f}")
        return "\n".join(lines)

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def reset(self):
        self.samples.clear()
