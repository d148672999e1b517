"""Where a cluster sweep's time goes, on the card (B4 and B2).

    python3 scripts/torch_sweep_breakdown.py

Prints one JSON line per measurement:

* ``barrier``: microseconds of one cluster barrier, from a kernel that runs
  nothing but barriers, at each cluster size (one grid and 16 grids);
* ``block_sweep2``: one launch with ``inner`` 0 (loads, stores, the chain's
  row blocks) and 40; the difference over blocks x 40 prices one pass;
* ``block_sweep``: ``inner`` 0, ``scan_chunk`` 1 (a round of both scans, a
  cluster barrier and a stencil pass, 40 a block) and 40 (one scan a
  block, then 40 passes with a barrier between each two).

All at the paths' widths (242, 482, 960) with the launch plan's cluster
size and 4, 8 and 16 blocks.  Times are CUDA-event means of 10
launches after a warm-up.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from peanut_tpu_torch.kernels import fmm_sweep  # noqa: E402
from peanut_tpu_torch.kernels.fmm import BIG  # noqa: E402


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def grids(rng, b, n, dev):
    trav = torch.as_tensor(rng.rand(b, n, n) > 0.25, device=dev)
    src = torch.zeros_like(trav)
    src[:, n // 2, n // 2] = True
    return ~trav & ~src, src, torch.where(src, 0.0, BIG).float()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    for c in fmm_sweep.CLUSTER_SIZES:
        print(json.dumps({"phase": "barrier", "cluster": c,
                          "us_1_grid": fmm_sweep.cluster_barrier_us(c),
                          "us_16_grids": fmm_sweep.cluster_barrier_us(
                              c, grids=16)}), flush=True)
    for b, n in ((1, 242), (1, 482), (1, 960), (16, 482)):
        wall, src, d = grids(rng, b, n, dev)
        blocks = -(-n // 16)
        plan_c = {o: fmm_sweep.launch_plan(o, d, 16).cluster for o in (1, 2)}
        for c in sorted({plan_c[1], plan_c[2], 4, 8, 16}):
            try:
                fmm_sweep.sweep_plan(2, b, n, 16, {}, cluster=c)
            except ValueError:
                continue
            t0 = cuda_ms(lambda: fmm_sweep.block_sweep2(
                d, wall, src, cluster=c, inner=0))
            t40 = cuda_ms(lambda: fmm_sweep.block_sweep2(
                d, wall, src, cluster=c))
            print(json.dumps({
                "phase": "block_sweep2", "grids": b, "n": n, "cluster": c,
                "plan": c == plan_c[2], "ms_inner0": t0, "ms": t40,
                "us_per_pass": (t40 - t0) / (blocks * 40) * 1e3}),
                flush=True)
            t0 = cuda_ms(lambda: fmm_sweep.block_sweep(
                d, wall, cluster=c, inner=0))
            t1 = cuda_ms(lambda: fmm_sweep.block_sweep(d, wall, cluster=c))
            t40 = cuda_ms(lambda: fmm_sweep.block_sweep(
                d, wall, cluster=c, scan_chunk=40))
            print(json.dumps({
                "phase": "block_sweep", "grids": b, "n": n, "cluster": c,
                "plan": c == plan_c[1], "ms_inner0": t0, "ms": t1,
                "ms_scan_chunk40": t40,
                # scan_chunk 1: a round is both scans, one cluster barrier
                # and one stencil pass
                "us_per_round": (t1 - t0) / (blocks * 40) * 1e3,
                # scan_chunk 40: one scan a block, then 40 stencil passes
                # with a cluster barrier between each two
                "us_per_pass_chunk40": (t40 - t0) / (blocks * 40) * 1e3}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
