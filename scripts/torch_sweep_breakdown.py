"""Where a cluster kernel's time goes, on the card (B4, B2 and B1).

    python3 scripts/torch_sweep_breakdown.py

Prints one JSON line per measurement:

* ``barrier``: microseconds of one cluster barrier, from a kernel that runs
  nothing but barriers, at each cluster size (one grid and 16 grids);
* ``block_sweep2``: one launch with ``inner`` 0 (loads, stores, the chain's
  row blocks) and 40; the difference over blocks x 40 prices one pass;
* ``block_sweep``: ``inner`` 0, ``scan_chunk`` 1 (a round of both scans, a
  cluster barrier and a stencil pass, 40 a block) and 40 (one scan a
  block, then 40 passes with a barrier between each two);
* ``fused_eikonal`` (B1) at its two path shapes (the 16 x 482^2 blanket,
  the 8 x 480^2 column-scan solve): ``inner`` 0 (loads, the column scans,
  the row-block chain), then scan_chunk 1, 4 (the schedule) and ``inner``
  (one scan round a row block), split into µs a scan round and a local
  pass (``chip_smoke.fused_breakdown``);
* ``fused_probe``: the blanket's passes as four B4 sweeps at scan_chunk 4,
  one cluster barrier after every pass, as B1 without ghost rows would run.

The sweeps at the paths' widths (242, 482, 960), all with the launch
plan's cluster size and 4, 8 and 16 blocks.  Times are CUDA-event means of
10 launches after a warm-up.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import B1_CASES, cuda_ms, fused_breakdown  # noqa: E402
from peanut_tpu_torch.kernels import fmm_sweep  # noqa: E402
from peanut_tpu_torch.kernels.fmm import BIG  # noqa: E402


def grids(rng, b, n, dev):
    trav = torch.as_tensor(rng.rand(b, n, n) > 0.25, device=dev)
    src = torch.zeros_like(trav)
    src[:, n // 2, n // 2] = True
    return ~trav & ~src, src, torch.where(src, 0.0, BIG).float()


def fused(rng, dev) -> None:
    for name in ("blanket_16x482", "vscan_8x480"):
        p = B1_CASES[name]
        (b, n), kw = p["shape"], {k: v for k, v in p.items() if k != "shape"}
        wall, src, d0 = grids(rng, b, n, dev)
        trav = ~wall
        block = kw["block"]
        plan_c = fmm_sweep.launch_plan(1, trav, block,
                                       fused_chunk=kw["scan_chunk"]).cluster
        for c in sorted({plan_c, 4, 8, 16}):
            try:        # the chunks of the breakdown, at this cluster size
                for chunk in (1, kw["scan_chunk"], kw["inner"]):
                    fmm_sweep.sweep_plan(1, b, n, block, {}, cluster=c,
                                         fused=(n, chunk))
            except ValueError:
                continue
            print(json.dumps({
                "phase": "fused_eikonal", "case": name, "cluster": c,
                "plan": c == plan_c,
                **fused_breakdown(trav, src, kw, cluster=c, reps=10)}),
                flush=True)
        if name.startswith("blanket"):
            def probe():
                d = d0
                for _ in range(kw["rounds"]):
                    for reverse in (False, True):
                        d = fmm_sweep.block_sweep(
                            d, wall, reverse, block=block, inner=kw["inner"],
                            scan_chunk=kw["scan_chunk"])
            print(json.dumps({
                "phase": "fused_probe", "case": name,
                "b4_cluster": fmm_sweep.launch_plan(1, d0, block).cluster,
                "ms": cuda_ms(probe, reps=10)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    fused(rng, dev)
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
                d, wall, src, cluster=c, inner=0), reps=10)
            t40 = cuda_ms(lambda: fmm_sweep.block_sweep2(
                d, wall, src, cluster=c), reps=10)
            print(json.dumps({
                "phase": "block_sweep2", "grids": b, "n": n, "cluster": c,
                "plan": c == plan_c[2], "ms_inner0": t0, "ms": t40,
                "us_per_pass": (t40 - t0) / (blocks * 40) * 1e3}),
                flush=True)
            t0 = cuda_ms(lambda: fmm_sweep.block_sweep(
                d, wall, cluster=c, inner=0), reps=10)
            t1 = cuda_ms(lambda: fmm_sweep.block_sweep(d, wall, cluster=c),
                         reps=10)
            t40 = cuda_ms(lambda: fmm_sweep.block_sweep(
                d, wall, cluster=c, scan_chunk=40), reps=10)
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
