"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--ticks N]

Phases (each prints one JSON line):
  1. device  — the card's name, count, and nvidia-smi's name + power limit;
  2. build   — nvcc builds every kernel in peanut_tpu_torch/kernels/csrc
               (one process per source, in parallel); ptxas registers and
               shared memory per kernel;
  3. kernels — each CUDA kernel against its plain PyTorch version on the card
               at the main path's shapes, on seeded cluttered floor plans with
               point and blob goals: reachability, max/mean |diff| against the
               stated tolerance, and CUDA-event times of kernel and plain
               version beside the kernel's bound; then fused_eikonal's time
               split into its scan phases and stencil passes;
  4. slice   — BatchRunner with 16 FakeNavEnvs under NavConfig(use_gt_seg=1,
               only_explore=1, switch_step=999) at the default geometry:
               steps/s, tick times, StageTimer stages, peak memory and the
               kernels' launch counts in the measured ticks (must be > 0);
               then the planning windows of the kernel schedule against the
               plain schedule on those envs' maps (equal short-term-goal
               decisions), and a small solve against the heap-marching oracle.
Then the kernels line, the nvidia-smi line and, last, the result line.  Any
failed phase exits non-zero without the result line.  Without a card, or
without the repository beside this script, it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The card's published peaks used for bounds (H100 SXM data sheet, at the
# full 700 W power limit): float32 outside the tensor cores, HBM3 rate.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# Operations per cell, counted as a sequential program needs them (a
# segmented min-plus scan is one add and one min per cell plus the final
# min; not the log-depth Hillis-Steele steps the kernel runs):
GODUNOV1_OPS = 17    # 2 neighbour mins, Godunov solve (~12), min, wall
SCAN_OPS = 3         # add, min, final min
GODUNOV2_OPS = 70    # 2 direction picks (~12), order-2 Godunov (~55), update


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_floorplan(rng, n, room=96, wall_t=2, door=7, clutter=120):
    """Rooms + corridors + clutter (True = traversible), the generator of
    tests/test_fmm_oracle.py at planning-window size."""
    occ = np.zeros((n, n), bool)
    occ[:wall_t] = occ[-wall_t:] = True
    occ[:, :wall_t] = occ[:, -wall_t:] = True
    for x in range(room, n - room // 2, room):
        occ[:, x:x + wall_t] = True
        for y0 in range(0, n - door - 4, room):
            dy = rng.randint(y0 + 2, y0 + room - door - 2)
            occ[dy:dy + door, x:x + wall_t] = False
    for y in range(room, n - room // 2, room):
        occ[y:y + wall_t, :] = True
        for x0 in range(0, n - door - 4, room):
            dx = rng.randint(x0 + 2, x0 + room - door - 2)
            occ[y:y + wall_t, dx:dx + door] = False
    for _ in range(clutter):
        cy, cx = rng.randint(wall_t + 2, n - 14, 2)
        hh, ww = rng.randint(2, 12, 2)
        occ[cy:cy + hh, cx:cx + ww] = True
    return ~occ


def make_goals(rng, trav, blob):
    free = np.argwhere(trav)
    gy, gx = free[rng.randint(len(free))]
    src = np.zeros_like(trav)
    if blob:
        src[max(gy - 2, 0):gy + 3, max(gx - 2, 0):gx + 3] = True
        src &= trav
    src[gy, gx] = True
    return src


def plans(rng, b, n):
    """b floor plans of n x n with alternating point and blob goals."""
    trav = np.stack([make_floorplan(rng, n) for _ in range(b)])
    src = np.stack([make_goals(rng, trav[i], blob=i % 2 == 1)
                    for i in range(b)])
    return trav, src


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compare(got: torch.Tensor, want: torch.Tensor, tol: float):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    reach = bool((np.isfinite(g) == np.isfinite(w)).all()
                 and ((g < 5e9) == (w < 5e9)).all())
    m = np.isfinite(w) & (w < 5e9)
    err = np.abs(g[m] - w[m]) if m.any() else np.zeros(1)
    return {"reachability_equal": reach, "max_abs_err": float(err.max()),
            "mean_abs_err": float(err.mean()), "tolerance": tol,
            "ok": reach and float(err.max()) <= tol}


def bound(cells: int, bytes_per_cell: float, ops: float):
    t_bytes = cells * bytes_per_cell / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        import peanut_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"peanut_tpu_torch not importable beside this script: {e}")
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.envs import FakeNavEnv
    from peanut_tpu_torch.envs.batch_runner import BatchRunner
    from peanut_tpu_torch.kernels import _build
    from peanut_tpu_torch.kernels.fmm import BIG, eikonal_distance
    from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                    fused_eikonal_reference)
    from peanut_tpu_torch.kernels.fmm_sweep import (block_sweep2,
                                                    block_sweep2_reference)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    emit({"phase": "device", "kind": name, "count": count,
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    try:
        for stem in ("fmm_fused", "fmm_sweep2"):
            _build.library(stem)
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    from peanut_tpu_torch.kernels import fmm_fused, fmm_sweep
    smem = {  # dynamic shared memory per block at the main path's shapes
        "fused_eikonal_482_block16":
            fmm_fused._lib().fused_eikonal_smem_bytes(482, 482, 16),
        "fused_eikonal_480_block8":
            fmm_fused._lib().fused_eikonal_smem_bytes(480, 480, 8),
        "block_sweep2_482_block16":
            fmm_sweep._lib().block_sweep2_smem_bytes(482, 16)}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "nvcc_seconds": round(_build.build_seconds, 2),
          "dir": str(_build.build_dir()), "dynamic_smem_bytes": smem,
          "ptxas": _build.ptxas_report()})

    # ---- 3. kernels vs plain versions ----------------------------------
    rng = np.random.RandomState(args.seed)
    # bitwise by design (same operation order, association and rounding as
    # the plain version; see the notes in the .cu sources); the tolerance
    # admits no more than float32 rounding noise on ~1000-cell distances
    TOL = 1e-3
    results = {}
    ok = True

    # B1: the order-2 planning blanket and the order-1 goal-weighting field
    b1_cases = {
        "blanket_16x482": dict(shape=(16, 482), rounds=2, block=16, inner=40,
                               scan_chunk=4, vscan=False),
        "vscan_8x480": dict(shape=(8, 480), rounds=4, block=8, inner=24,
                            scan_chunk=4, vscan=True),
    }
    for case, p in b1_cases.items():
        (b, n), kw = p["shape"], {k: v for k, v in p.items() if k != "shape"}
        trav_np, src_np = plans(rng, b, n)
        trav = torch.as_tensor(trav_np, device=dev)
        src = torch.as_tensor(src_np, device=dev)
        got = fused_eikonal(trav, src, **kw)
        want = fused_eikonal_reference(trav, src, **kw)
        torch.cuda.synchronize()
        cmp = compare(got, want, TOL)
        ms = cuda_ms(lambda: fused_eikonal(trav, src, **kw), reps=10)
        plain_ms = cuda_ms(lambda: fused_eikonal_reference(trav, src, **kw),
                           reps=1)
        cells = b * n * n
        ops = cells * kw["rounds"] * 2 * (
            GODUNOV1_OPS * kw["inner"]
            + 2 * SCAN_OPS * (kw["inner"] // kw["scan_chunk"]))
        if kw["vscan"]:
            ops += cells * kw["rounds"] * 2 * SCAN_OPS
        bound_ms, bound_by = bound(cells, 2 + 4, ops)
        results[f"B1_{case}"] = dict(cmp, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)
        ok &= cmp["ok"]
        emit({"phase": "kernel", "kernel": f"fused_eikonal/{case}",
              **results[f"B1_{case}"]})

    # B2: both directions on the planning shape, from the refinement's
    # from-scratch start and from a forward-swept field
    b, n = 16, 482
    trav_np, src_np = plans(rng, b, n)
    src = torch.as_tensor(src_np, device=dev)
    wall = torch.as_tensor(~trav_np & ~src_np, device=dev)
    d0 = torch.where(src, 0.0, BIG).float()
    d1 = block_sweep2_reference(d0, wall, src, False)
    for reverse, d_in in ((False, d0), (True, d1)):
        got = block_sweep2(d_in, wall, src, reverse)
        want = block_sweep2_reference(d_in, wall, src, reverse)
        torch.cuda.synchronize()
        cmp = compare(got, want, TOL)
        ms = cuda_ms(lambda: block_sweep2(d_in, wall, src, reverse), reps=10)
        plain_ms = cuda_ms(
            lambda: block_sweep2_reference(d_in, wall, src, reverse), reps=1)
        cells = b * n * n
        bound_ms, bound_by = bound(cells, 4 + 1 + 1 + 4,
                                   cells * 40 * GODUNOV2_OPS)
        key = "B2_" + ("up" if reverse else "down") + "_16x482"
        results[key] = dict(cmp, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        ok &= cmp["ok"]
        emit({"phase": "kernel", "kernel": f"block_sweep2/{key}",
              **results[key]})
    if not ok:
        fail("a kernel disagrees with its plain version")

    # where a fused_eikonal launch spends its time: one round at the blanket
    # shape with the row scans every pass, every 4th pass (the schedule) and
    # once per block; the differences price one scan phase (both row scans
    # of a block) and one Jacobi stencil pass
    trav_np, src_np = plans(rng, 16, 482)
    trav = torch.as_tensor(trav_np, device=dev)
    src = torch.as_tensor(src_np, device=dev)
    t_chunk = {c: cuda_ms(lambda c=c: fused_eikonal(
        trav, src, rounds=1, block=16, inner=40, scan_chunk=c,
        vscan=False), reps=5) for c in (1, 4, 40)}
    relax = 2 * -(-482 // 16)          # block relaxations in one round
    scan_us = (t_chunk[1] - t_chunk[40]) / (relax * 39) * 1e3
    stencil_us = (t_chunk[40] - relax * scan_us / 1e3) / (relax * 40) * 1e3
    emit({"phase": "kernel_breakdown", "kernel": "fused_eikonal",
          "round_ms_by_scan_chunk": t_chunk,
          "scan_phase_us_per_block": scan_us,
          "stencil_pass_us_per_block": stencil_us})

    # ---- 4. the slice: 16-env explore-only GT-semantics serving --------
    cfg = NavConfig(use_gt_seg=1, only_explore=1, switch_step=999)
    n_envs = 16
    runner = BatchRunner(
        cfg, [lambda s=s: FakeNavEnv(cfg, size_m=14.0, seed=args.seed + s)
              for s in range(n_envs)], device=dev)
    runner.reset_all()
    for _ in range(3):
        runner.tick()
    runner.warmup_rare_paths()
    runner.reset_timers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_eikonal.launches = 0
    block_sweep2.launches = 0
    tick_ms = []
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        t1 = time.perf_counter()
        runner.tick()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"fused_eikonal": fused_eikonal.launches,
                "block_sweep2": block_sweep2.launches}
    rt = runner.runtime
    stage_ms = {k: round(v / args.ticks * 1e3, 3)
                for k, v in runner.stage_totals().items()}
    emit({"phase": "slice", "envs": n_envs, "ticks": args.ticks,
          "env_steps_per_sec": n_envs * args.ticks / dt,
          "tick_ms_median": float(np.median(tick_ms)),
          "tick_ms_mean": dt / args.ticks * 1e3,
          "stage_ms_per_tick": stage_ms,
          "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
          "launches": launches, "episodes_done": len(runner.metrics)})
    if min(launches.values()) <= 0:
        fail(f"the main path did not launch every kernel: {launches}")

    # kernel schedule vs plain schedule on these envs' maps: same windows
    # in, same short-term-goal decisions out
    st = rt.state
    n = rt.n
    lmb = torch.as_tensor(np.stack([s.lmb for s in rt.slots]),
                          device=dev).long()
    starts, starts_exact = rt._planner_cells(lmb.cpu().numpy())
    loc_r = torch.as_tensor(starts[:, 0], device=dev).long()
    loc_c = torch.as_tensor(starts[:, 1], device=dev).long()
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    single = torch.zeros_like(st.local_maps[:, 0])
    single[torch.arange(n, device=dev), st.cur_goal[:, 0].long(),
           st.cur_goal[:, 1].long()] = 1.0
    wins = {}
    for plain in (False, True):
        wins[plain] = rt._plan(st.local_maps, st.collision, st.visited, lmb,
                               loc_r, loc_c, no, single, no, no,
                               plain=plain).window.cpu().numpy()
    dec = [[rt._stg_from_window(wins[p][i], starts_exact[i], starts[i])
            for i in range(n)] for p in (False, True)]
    same = [(a[0], a[1], a[3], a[4]) == (b[0], b[1], b[3], b[4])
            for a, b in zip(*dec)]
    finite = bool(np.isfinite(wins[False]).all())
    emit({"phase": "plan_check", "windows_shape": list(wins[False].shape),
          "windows_finite": finite,
          "window_max_abs_diff": float(np.abs(wins[False] - wins[True]).max()),
          "stg_decisions_equal": int(sum(same)), "envs": n})
    if not all(same) or not finite or wins[False].shape != (n, 11, 11):
        fail("planning windows or decisions differ between the kernel and "
             "plain schedules")

    # a small solve against the repo's heap-marching oracle (the accuracy
    # bounds of tests/test_fmm_oracle.py)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from heap_fmm_oracle import heap_fmm
    orng = np.random.RandomState(args.seed + 1)
    trav_np = make_floorplan(orng, 160, room=60, clutter=30)
    src_np = make_goals(orng, trav_np, blob=False)
    got = eikonal_distance(torch.as_tensor(trav_np[None], device=dev),
                           torch.as_tensor(src_np[None], device=dev))[0]
    got = got.double().cpu().numpy()
    want = heap_fmm(trav_np, src_np)
    reach = bool((np.isfinite(got) == np.isfinite(want)).all())
    m = np.isfinite(want)
    err = np.abs(got[m] - want[m])
    emit({"phase": "oracle", "reachability_equal": reach,
          "max_cell_err": float(err.max()), "mean_cell_err": float(err.mean()),
          "bounds": [1.2, 0.5]})
    if not reach or err.max() > 1.2 or err.mean() > 0.5:
        fail("the CUDA solve misses the heap-oracle bounds")
    runner.close()

    kernels = []
    for name_, src_file, replaces, keys, count_key in (
            ("fused_eikonal", "peanut_tpu_torch/kernels/csrc/fmm_fused.cu",
             "peanut_tpu/kernels/fmm_fused.py:256",
             ("B1_blanket_16x482", "B1_vscan_8x480"), "fused_eikonal"),
            ("block_sweep2", "peanut_tpu_torch/kernels/csrc/fmm_sweep2.cu",
             "peanut_tpu/kernels/fmm_pallas.py:298",
             ("B2_down_16x482", "B2_up_16x482"), "block_sweep2")):
        main_case = results[keys[0]]
        kernels.append({
            "name": name_, "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": launches[count_key],
            "max_abs_err": max(results[k]["max_abs_err"] for k in keys),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "cases": {k: {kk: results[k][kk] for kk in
                          ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                      for k in keys}})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
