"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--ticks N]
                          [--only b3|b1|wide|paths|train|zoo|zoo_train|
                                  zoo_tools]

With --only, the device line and one phase alone, with no result line: "b3"
phase 5's roi_window_pool lines, "b1" phase 3's fused_eikonal lines, "wide"
phase 3's lines over 1024 cells (run from a copy of another tree, it times
that tree's kernels beside these, in one call), "paths" phase 3's B1, B2
and B4 lines at the paths' shapes (to time another tree's beside these),
"train" phase 11, "zoo" phase 12, "zoo_train" phase 13, "zoo_tools" phase
14.

Phases (each prints one JSON line):
  1. device  — the card's name, count, and nvidia-smi's name + power limit;
  2. build   — nvcc builds every kernel in peanut_tpu_torch/kernels/csrc
               (one process per source, in parallel); ptxas registers and
               shared memory per kernel; the HMMA instructions of
               roi_window's bf16 kernels in cuobjdump's SASS (none fails);
               the launch plans of the two sweeps and of fused_eikonal at
               the paths' shapes (and B1 at 1 and 16 x 1042^2) with
               cudaOccupancyMaxActiveClusters at each cluster size; then one
               cluster barrier's time at each size the plans use;
  3. kernels — each CUDA kernel against its plain PyTorch version on the card
               at the main path's shapes, on seeded cluttered floor plans with
               point and blob goals: reachability, max/mean |diff| against the
               stated tolerance, and CUDA-event times of kernel and plain
               version beside the kernel's bound (B1/B2/B4 bit-equal, with
               their cluster size, chain of row blocks x passes (B1: x scan
               rounds), time per link and the floor the chain's cluster
               barriers set), at both tilings of the 16-env tick (block
               16 and the serving profile's block 8, inner 24) and the
               exact profile's 8 x 960^2 goal-weighting field; then lines
               over 1024 cells (wide_lines: B4 at 1x48x1040, 2000, 2049,
               4096; B1 at 2x48x1040, 2x1040x48, 1x2000x48 and 2x4096x48
               with column scans, 1x1024^2 and 1x1042^2 blankets, and rows
               past full ghost rows: 1x1608^2 at block 8, 16x1700^2 at
               block 16), and past the shared-memory kernels, through the
               long-line kernels (csrc/fmm_long.cu): B4 at 1x48x8192 and
               1x16x40000, B1 with column scans at 2x8192x48 and rows at
               1x16x6000 (block 8), B2 at 1x16x20000 (block 16), with
               their plain versions' times, bounds and launches; all
               bit-equal; then fused_eikonal's time split into its scan
               rounds and local stencil passes;
  4. slice   — BatchRunner with 16 FakeNavEnvs under NavConfig(use_gt_seg=1,
               only_explore=1, switch_step=999) at the default geometry:
               steps/s, tick times, StageTimer stages, peak memory and the
               kernels' launch counts in the measured ticks (must be > 0);
               then the planning windows of the kernel schedule against the
               plain schedule on those envs' maps (equal short-term-goal
               decisions), and a small solve against the heap-marching oracle;
  5. kernel  — roi_window_pool (B3) at the four window shapes of one
               random-weight R101-FPN detect of 8 FakeNavEnv frames at
               800x1088 (square p=7 and p=14, x- and y-elongated p=7), in
               float32 and bfloat16 against its plain version within 2e-5
               of the largest |value| (both sides contract the same
               rounded operands), bfloat16 also within the elementwise
               rtol/atol 2e-2 of tests/test_roi_window.py, and a pool
               that skips rounding A_y must miss the bar; in both types
               kernel, plain and library (window gather + two torch.bmm)
               times beside the bound, and (kernel_breakdown) each launch
               split into the output write, the window loads and the
               contraction, bfloat16 also timed with ring stages of
               32-512 rows.
               Then nms_chain, one dependent step of a walk (a shuffle and
               the shared-memory read it addresses), and nms_keep (the
               pack and the greedy walk) on the RPN's and the box head's
               suppression matrices of that detect, bit-equal to its
               plain version, with times, the pack's alone and the chain
               floor (n steps);
  6. detect  — the whole detect in float32 through the kernel against the
               plain ROI path (the golden-test bar, masks compared as
               probabilities within 1e-4 and IoU on the decided pixels),
               then frames/s in bfloat16 at batch 8 with the stage split
               and peak memory;
  7. slice_seg — BatchRunner with 16 FakeNavEnvs under NavConfig(use_gt_seg=0,
               only_explore=1, switch_step=999, serve_bf16=True): steps/s,
               tick times, stages (detect included), peak memory and the
               launches of B1, B2, B3 and nms_keep in the measured ticks
               (all > 0);
 7b. serve_16, exact_16 — bench.py::bench_env_steps's two profiles:
               BatchRunner with 16 FakeNavEnvs under NavConfig(use_gt_seg=0,
               serve_bf16=True) and the serving profile's settings
               (dd_downscale=2, dd_order=1, dd_block/plan_block 8,
               dd_inner/plan_inner 24, pred_async=1; 20 ticks) or the exact
               one's (dd_downscale=1, synchronous prediction; 10 ticks),
               Mask R-CNN R101-FPN and PSPNet-R50-v1c from seeds, 5 warm-up
               ticks and warmup_rare_paths first: steps/s, median tick, the
               stages per tick, peak memory and the launches of B1, B2, B3
               and nms_keep (all > 0); then pred_parity: 8 envs with GT
               semantics, 12 ticks of the serving profile and 4 of the
               exact one (its plain solves take ~37 s a tick), the
               prediction branch's goal-weighting solve through the
               kernels and through the plain versions: equal actions and
               goals, bit-equal target_pred and dd_wt;
  8. single_explore — the single-env agent through cli/collect_maps.main:
               one episode of 100 steps on FakeNavEnv(size_m=14.0) with GT
               semantics at the default geometry (240^2 local window, 242^2
               planning solves): steps/s, per-step ms of each stage, the
               local map's host round trip, and the launches of B2, B3, B4
               and nms_keep in the episode (B2 and B4 > 0);
  9. plan_check_2d — planner inputs recorded in phase 8 solved through the
               kernels and through the plain versions: bit-equal fields and
               the same short-term-goal decisions;
 10. single_nav — the single-env agent through cli/collect.main: one
               50-step episode with Mask R-CNN and PSPNet loaded from
               random-weight checkpoints that the script writes (480^2
               local window, 482^2 planning and 960^2 goal-weighting
               solves, PSPNet on the 720^2 crop): the same readings, and
               B2, B3, B4 and nms_keep all launched; then its first
               detect's B3 (float32, timed) and nms_keep calls against
               their plain versions;
 11. train  — PSPNet-R50-v1c training at the recipe's full width (batch 8,
               crop 960, 14 channels, remat=1) on synthetic 960^2 maps
               written from --seed: cli.train_prediction_model for 4
               iterations (checkpoints every 2), then again to 6, which
               must resume from iter 4; iter_6 loaded into PredictionModel
               serves what the trained model computes (1e-5) and
               cli.test evaluates it; ten steps on one fixed batch lower
               the loss, timed (median step ms, forward + backward and
               Adam, maps/s, peak memory at remat=1; one step's peak at
               remat=0; then three steps with TF32 on, PyTorch's default
               for cuDNN); the tiny PSPNet's step on the card against the
               CPU's (float64: loss 1e-5 relative, gradients 1e-4 of the
               largest; float32 with TF32 off: the loss within 1e-5, the
               gradients reported);
 12. zoo    — the model zoo's serving path, every family the port builds
               (forty-four: the twenty ResNetV1c EncoderDecoder ones, ann
               ... upernet, the ten transformer ones, beit ... vit, the
               cascade ones, knet and point_rend, and the twelve light-CNN
               ones, bisenetv1 ... unet), each its 80k Cityscapes config
               at the config's own widths from --seed with random batch
               statistics, non-zero attention gates, layer scales and
               seeded PReLU slopes: the card against the CPU in float64 on a
               128x256 input (1e-8 of the largest |logit|), then one
               512x1024 forward timed in float32 (TF32 off) and bfloat16
               (zoo_family; BEiT's tables and MAE's positional embedding
               bound by each model's first input, so at the size it runs);
               cli/serve.py's handler in a thread on the card serving
               configs/upernet/upernet_r50_512x1024_80k_cityscapes.py, 5
               POST /probs of a seeded 1024x2048x3 .npy: every reply 200,
               (19, 1024, 2048) and equal to inference_segmentor called
               directly (zoo_serve: ms per request, peak memory); the same
               for configs/hrnet/fcn_hr18_512x1024_80k_cityscapes.py
               (zoo_serve_hrnet) and for
               configs/swin/upernet_swin-t_512x512_160k_ade20k.py on a
               512x683 image (ADE20K's test scale on a 4:3 image, not a
               multiple of the 7x7 windows: replies (150, 512, 683);
               zoo_serve_swin); UPerNet's slide inference (crop
               512x1024, stride 341x683) at 1024x2048 timed, and against
               the CPU in float64 at 128x256, crop 64x128, stride 43x85
               (zoo_slide); cli/benchmark.py on UPerNet at its defaults
               (--size 720 --batch 4) in bfloat16 and float32
               (zoo_benchmark: maps/s).  The zoo launches no kernel of
               csrc/.
 13. zoo_train — the zoo's training half at published width:
               configs/convnext/upernet_convnext_512x512_160k_ade20k.py
               (UPerNet over ConvNeXt-T, UPerHead 512 channels, FCN
               auxiliary head 256) with 6 classes in both heads and 14
               input channels, written out with dump_config, trained by
               cli.train_prediction_model --config at batch 8, crop 512
               (the config's own) on synthetic 640^2 maps for 6
               iterations (checkpoints every 3), then again to 9, which
               must resume from iter 6 with the logged loss falling
               (the last three iterations' mean below the first three's);
               iter_9 loaded by apis.init_segmentor serves what the
               trained model computes (1e-5 of the largest |logit|);
               one batch from the loader (host, one worker), then 10
               steps after 2 warm-up ones on it, float32 with TF32 off and
               then on: median step ms split into forward + backward and
               Adam, maps/s, peak memory; then card against CPU, one train
               step (dropout 0, batch 2 at 64x64) in float64 (loss 1e-5
               relative, gradients 1e-4 of the largest) and float32
               (reported) for UPerNet-ConvNeXt-T, UPerNet-ViT-B,
               PSPNet-MobileNetV2-d8 and Fast-SCNN at their published
               backbones with narrow heads, PointRend's training forward
               (stage and point logits within 1e-8, the points equal) and
               one layer-decay AdamW step of UPerNet-ViT-B (1e-8 of the
               largest update).  No kernel of csrc/ either.
 14. zoo_tools — the zoo's tools and converters, data from --seed: an
               mmcls ConvNeXt-T state dict (dims 96-768, depths 3/3/9/3,
               ~28 M parameters) through cli.convert model convnext into
               UPerNet-ConvNeXt-T's backbone (the zoo_train config), and a
               Microsoft Swin-T one (with mmseg's per-stage norms) through
               cli.convert model swin into
               configs/swin/upernet_swin-t_512x512_160k_ade20k.py's (its
               patch merging's biases, which the checkpoint lacks, kept):
               arrays, leftovers (none), and the backbone's features on
               the card against the CPU in float64 at 224x224 (1e-9 of
               the largest); cli.export of that UPerNet-ConvNeXt-T at
               (1, 512, 512, 3) and of configs/pspnet/peanut_prediction.py
               at (1, 720, 720, 14), float32 with TF32 off: export
               seconds, artifact MB, the reloaded program against the
               eager model (rtol = atol = 1e-5) and both forwards' median
               ms of 10 (CUDA events); cli.tools confusion_matrix with the
               converted UPerNet-ConvNeXt-T over eight seeded 512x512
               images of a CustomDataset on the card and on the CPU: both
               overall accuracies, the pixels whose predictions differ,
               each a near-tie (the two largest logits within 1e-4);
               cli.tools collect_env on the card as one JSON line
               (zoo_tools_env).  No kernel of csrc/.
Phase 3 also holds B4 (the first-order block sweep) bit-equal to its plain
version at the single-env agent's shapes.  Then the kernels line, the
nvidia-smi line and, last, the result line.  Any failed phase exits
non-zero without the result line.  Without a card, or without the
repository beside this script, it fails.
"""

from __future__ import annotations

import argparse
import contextlib
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
PEAK_BF16_OPS = 989e12     # dense, tensor cores
PEAK_BYTES = 3.35e12

# Operations per cell, counted as a sequential program needs them (a
# segmented min-plus scan is one add and one min per cell plus the final
# min; not the log-depth Hillis-Steele steps the kernel runs):
GODUNOV1_OPS = 17    # 2 neighbour mins, Godunov solve (~12), min, wall
SCAN_OPS = 3         # add, min, final min
GODUNOV2_OPS = 70    # 2 direction picks (~12), order-2 Godunov (~55), update
# the cluster kernels' fields on their kernel lines
SWEEP_FIELDS = ("cluster", "blocks_x_passes", "us_per_pass", "chain_floor_ms")
# B1 (fused_eikonal) on the tick: the order-2 planning blanket and the
# order-1 goal-weighting field; and the blanket at the exact profile's
# full-resolution width
B1_CASES = {
    "blanket_16x482": dict(shape=(16, 482), rounds=2, block=16, inner=40,
                           scan_chunk=4, vscan=False),
    "vscan_8x480": dict(shape=(8, 480), rounds=4, block=8, inner=24,
                        scan_chunk=4, vscan=True),
    "blanket_16x962": dict(shape=(16, 962), rounds=2, block=16, inner=40,
                           scan_chunk=4, vscan=False),
    # the serving profile's planning blanket (plan_block 8, plan_inner 24)
    # and the exact profile's goal-weighting blanket (K = 8 of 960^2)
    "blanket_16x482_b8": dict(shape=(16, 482), rounds=2, block=8, inner=24,
                              scan_chunk=4, vscan=False),
    "blanket_8x960": dict(shape=(8, 960), rounds=2, block=16, inner=40,
                          scan_chunk=4, vscan=False),
}


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


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
    """Mean device time of fn() over reps calls, by CUDA events.  The card
    first spins ~10 ms (torch.cuda._sleep), so the host has enqueued the
    calls before the first event runs: a short kernel is timed on the
    card, not at the rate its wrapper launches it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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


def fused_links(n: int, kw: dict) -> int:
    """The chain of a fused_eikonal launch on n x n grids: row blocks x 2
    passes x rounds x scan rounds, one cluster barrier each (the ghost rows
    spare one a pass)."""
    return (-(-n // kw["block"]) * 2 * kw["rounds"]
            * (kw["inner"] // kw["scan_chunk"]))


def fused_breakdown(trav, src, kw: dict, cluster=None, reps: int = 5):
    """Where a fused_eikonal launch spends its time: inner 0 (loads, column
    scans, the row-block chain), then scan_chunk 1, the schedule's and
    ``inner`` (one scan round a row block).  A launch less inner 0's is
    scan rounds x the µs of a round (a block's row scans, the ghost rows'
    stores, a cluster barrier) + passes x the µs of a local pass, solved
    from chunk 1 and ``inner`` as if a pass cost the same at each chunk."""
    from peanut_tpu_torch.kernels.fmm_fused import fused_eikonal

    def run(**over):
        return cuda_ms(lambda: fused_eikonal(trav, src, cluster=cluster,
                                             **{**kw, **over}), reps=reps)
    inner, chunk, n = kw["inner"], kw["scan_chunk"], trav.shape[1]
    t0 = run(inner=0)
    t = {c: run(scan_chunk=c) for c in (1, chunk, inner)}
    relax = fused_links(n, {**kw, "inner": 1, "scan_chunk": 1})
    us_round = (t[1] - t[inner]) / (relax * inner - relax) * 1e3
    us_pass = ((t[inner] - t0) * 1e3 - relax * us_round) / (relax * inner)
    links = fused_links(n, kw)
    return {"ms_inner0": t0, "ms_by_scan_chunk": t, "scan_rounds": links,
            "us_per_scan_round_schedule": (t[chunk] - t0) / links * 1e3,
            "us_per_scan_round": us_round, "us_per_local_pass": us_pass}


# ---------------------------------------------------------------------------
# Mask R-CNN (kernel B3 and the use_gt_seg=0 slice)

# B3 against its plain version, relative to the largest |value|: both sides
# contract the same (bf16-rounded) operands in float32 and differ only in
# association, in bfloat16 as in float32
ROI_TOL = 2e-5
ROI_TOL_BF16_ELEMENTWISE = 2e-2     # rtol = atol, tests/test_roi_window.py
SEG_TICKS = 10       # measured ticks of slice_seg
ROI_SHAPES = ("square_p7_n8000", "x_elongated_p7", "y_elongated_p7",
              "square_p14_n800")
NMS_CALLS = ("rpn_40x1000", "box_8x1000")


class Patch:
    """Within the block, ``module.name`` is ``wrap(original)``."""

    def __init__(self, module, name, wrap):
        self.module, self.name, self.wrap = module, name, wrap

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.wrap(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def capture(module, name, calls, when=lambda: True):
    """Records the arguments of every call of ``module.name`` made while
    ``when()`` holds in ``calls``: for roi_window_pool in a detect, box
    stage square, x-, y-elongated, then the mask stage the same; for
    nms_keep, the RPN, then the box head."""
    def wrap(fn):
        def recorded(*a):
            if when():
                calls.append(a)
            return fn(*a)
        return recorded
    return Patch(module, name, wrap)


def roi_support(w: torch.Tensor):
    """First index and length of each ROI's nonzero-weight span."""
    nz = (w != 0).any(1)
    idx = torch.arange(nz.shape[1], device=w.device)
    lo = torch.where(nz, idx, nz.shape[1]).amin(1)
    hi = torch.where(nz, idx, -1).amax(1) + 1
    return lo, torch.clamp(hi - lo, min=0)


def roi_bound(flat, ay, ax, row0, col0, p):
    """Least time for these inputs: the distinct buffer cells the windows'
    weighted supports cover read once + hat matrices + origins + output
    written once, at 3.35 TB/s; or the operations per ROI over its R x X
    support in the cheaper contraction order: y first, 2 C p R X products
    of A_y (bf16 operands on the tensor cores at 989 TFLOP/s when the
    buffer is bf16, else float32 at 67 TFLOP/s) and 2 C p^2 X float32
    (A_x is float32) at 67 TFLOP/s; or x first, 2 C p R X + 2 C p^2 R, all
    float32 (the intermediate is float32).  Returns (ms, bound_by, cells,
    y-first operations, operations ms)."""
    n, c = ay.shape[0], flat.shape[-1]
    hs, ws = flat.shape[0], flat.shape[1]
    ylo, rows = roi_support(ay.to(flat.dtype))
    xlo, cols = roi_support(ax)
    ok = (rows > 0) & (cols > 0)
    rows_, cols_ = rows[ok].double(), cols[ok].double()
    y_ops = float((2 * c * p * rows_ * cols_).sum())
    x_ops = float((2 * c * p * p * cols_).sum())
    alt_ops = float((2 * c * p * rows_ * cols_
                     + 2 * c * p * p * rows_).sum())
    peak_y = PEAK_BF16_OPS if flat.dtype == torch.bfloat16 else PEAK_F32_OPS
    t_ops = min(y_ops / peak_y + x_ops / PEAK_F32_OPS,
                alt_ops / PEAK_F32_OPS) * 1e3
    r0 = (row0 + ylo).clamp(0, hs)[ok].long()
    r1 = (row0 + ylo + rows).clamp(0, hs)[ok].long()
    c0 = (col0 + xlo).clamp(0, ws)[ok].long()
    c1 = (col0 + xlo + cols).clamp(0, ws)[ok].long()
    diff = torch.zeros((hs + 1, ws + 1), dtype=torch.int64, device=ay.device)
    for rr, cc, v in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1), (r1, c1, 1)):
        diff.index_put_((rr, cc), torch.full_like(rr, v), accumulate=True)
    cells = int((diff.cumsum(0).cumsum(1)[:hs, :ws] > 0).sum())
    nbytes = (cells * c * flat.element_size()
              + 4 * (ay.numel() + ax.numel() + 2 * n) + 4 * n * p * p * c)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", cells, y_ops + x_ops, t_ops)


def library_pool(padded, pad, ay, ax, row0, col0, win_y, win_x):
    """The yardstick: gather each window of a zero-padded copy of the buffer
    (made beforehand), then two torch.bmm."""
    n, p = ay.shape[0], ay.shape[1]
    c = padded.shape[-1]
    dev = padded.device
    rows = (row0.long() + pad)[:, None] + torch.arange(win_y, device=dev)
    cols = (col0.long() + pad)[:, None] + torch.arange(win_x, device=dev)
    win = padded[rows[:, :, None], cols[:, None, :]]       # (n, wy, wx, C)
    t = torch.bmm(ay.to(padded.dtype), win.reshape(n, win_y, win_x * c))
    t = t.reshape(n, p, win_x, c).transpose(1, 2).reshape(n, win_x, p * c)
    return torch.bmm(ax, t.float())                          # (n, px, py*C)


def check_pool(call, timed: bool):
    """Kernel vs plain version on one captured call, within ROI_TOL of the
    largest |value|: with random weights the pooled sums reach ~4e4 and
    the two sum in other orders, so an element that cancels to near zero
    carries the rounding of its large partial sums.  In bfloat16 also the
    elementwise bar of tests/test_roi_window.py, and the plain version
    over a float32 copy of the buffer (A_y left unrounded) must miss the
    ROI_TOL bar, or the bar could not tell a kernel that skips the
    rounding.  With ``timed``, kernel/plain/library ms, the bound and
    ``pool_breakdown``."""
    from peanut_tpu_torch.kernels.roi_window import (
        roi_window_pool, roi_window_pool_reference)
    flat, ay, ax, row0, col0, win_y, win_x = call
    got = roi_window_pool(*call)
    want = roi_window_pool_reference(*call)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    limit = ROI_TOL * max(scale, 1.0)
    finite = bool(torch.isfinite(got).all())
    out = {"n": ay.shape[0], "p": ay.shape[1], "window": [win_y, win_x],
           "dtype": str(flat.dtype).replace("torch.", ""),
           "max_abs_err": err, "max_abs_want": scale,
           "median_abs_want": float(want.abs().median()),
           "max_err_rel_to_max": err / max(scale, 1e-30),
           "tolerance": ROI_TOL, "limit_abs": limit, "finite": finite}
    ok = finite and err <= limit
    if flat.dtype == torch.bfloat16:
        elem = ROI_TOL_BF16_ELEMENTWISE
        out["elementwise_ok"] = bool(
            (diff <= elem + elem * want.abs()).all())
        unrounded = roi_window_pool_reference(flat.float(), *call[1:])
        out["unrounded_ay_max_abs_err"] = float(
            (unrounded - want).abs().max())
        out["bar_sees_unrounded_ay"] = out["unrounded_ay_max_abs_err"] > limit
        del unrounded
        ok = ok and out["elementwise_ok"] and out["bar_sees_unrounded_ay"]
    out["ok"] = ok
    if timed:
        pad = max(win_y, win_x)
        padded = torch.nn.functional.pad(flat, (0, 0, pad, pad, pad, pad))
        out["ms"] = cuda_ms(lambda: roi_window_pool(*call), reps=10)
        out["plain_ms"] = cuda_ms(lambda: roi_window_pool_reference(*call),
                                  reps=2)
        out["library_ms"] = cuda_ms(lambda: library_pool(
            padded, pad, ay, ax, row0, col0, win_y, win_x), reps=3)
        del padded
        (out["bound_ms"], out["bound_by"], out["cells_read"],
         out["operations"], out["operations_ms"]) = roi_bound(
             flat, ay, ax, row0, col0, ay.shape[1])
        out.update(pool_breakdown(call))
    return out


RING_SWEEP = (32, 64, 128, 256, 512)     # rows of a ring stage


def pool_breakdown(call):
    """Where a roi_window_pool launch's time goes: the output write alone
    (with the hats and their support), the window loads, the contraction
    (uncounted part launches of the kernel); and in bfloat16 its time with
    ring stages of each RING_SWEEP row count that fits shared memory,
    beside the rows it serves with.  Empty where the package has no part
    launches."""
    from peanut_tpu_torch.kernels import roi_window as rw
    if not hasattr(rw, "roi_window_pool_part"):
        return {}
    flat = call[0]
    part = {k: cuda_ms(lambda k=k: rw.roi_window_pool_part(*call, part=k),
                       reps=10)
            for k in ("write", "load_write", "whole")}
    out = {"breakdown_ms": {
        "write": part["write"],
        "loads": part["load_write"] - part["write"],
        "contraction": part["whole"] - part["load_write"],
        "whole": part["whole"]}}
    if flat.dtype != torch.bfloat16:
        return out
    sweep = {}
    for rows in RING_SWEEP:
        try:
            rw.roi_window_pool_part(*call, part="whole", rows=rows)
        except ValueError:             # past shared memory
            continue
        sweep[str(rows)] = cuda_ms(lambda r=rows: rw.roi_window_pool_part(
            *call, part="whole", rows=r), reps=10)
    return dict(out, ring_rows=rw.ring_rows(), ms_by_ring_rows=sweep)


def check_nms(call, timed: bool, step_us: float = 0.0):
    """nms_keep against its plain version on one captured call (bit-equal:
    both give the unique greedy keep set).  The bound moves valid, keep
    and, per kept box, its sup row right of the diagonal (the rest of sup
    cannot change the answer), at 3.35 TB/s.  The chain floor: n dependent
    steps of the walk at ``step_us`` each (phase nms_chain); the pack, the
    kernel that reads sup, timed alone."""
    from peanut_tpu_torch.kernels.nms import (nms_keep, nms_keep_reference,
                                              nms_pack)
    sup, valid = call
    got = nms_keep(sup, valid)
    want = nms_keep_reference(sup, valid)
    n = sup.shape[-1]
    out = {"problems": valid.numel() // n, "n": n,
           "kept": int(want.sum()), "valid": int(valid.sum()),
           "equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got.float() - want.float()).abs().max())}
    if timed:
        out["ms"] = cuda_ms(lambda: nms_keep(sup, valid), reps=10)
        out["plain_ms"] = cuda_ms(lambda: nms_keep_reference(sup, valid),
                                  reps=3)
        right = (n - 1 - torch.arange(n, device=sup.device)).double()
        row_bytes = float((want.double() * right).sum())
        out["bytes"] = 2.0 * valid.numel() + row_bytes
        out["bound_ms"] = out["bytes"] / PEAK_BYTES * 1e3
        out["bound_by"] = "bytes"
        out["library_ms"] = None
        out["pack_ms"] = cuda_ms(lambda: nms_pack(sup), reps=10)
        out["chain_floor_ms"] = n * step_us / 1e3
        out["ms_over_floor_plus_pack"] = out["ms"] / (
            out["chain_floor_ms"] + out["pack_ms"])
    return out


MASK_PROB_TOL = 1e-4


def detections_agree(a, b):
    """The golden test's bar (tests/test_mask_rcnn.py): equal finite count
    and classes, scores within 1e-3, boxes within 1.0, mask IoU >= 0.97.
    Random weights leave wide mask regions with logits near 0, where the
    two ROI paths' rounding flips pixels that sit within ~1e-6 of the 0.5
    threshold; so the mask probabilities must agree within 1e-4, and the
    IoU bar holds on the decided pixels (further than 1e-4 from 0.5 in both
    paths)."""
    a = {k: v.float().cpu().numpy() for k, v in a.items()}
    b = {k: v.float().cpu().numpy() for k, v in b.items()}
    fin = np.isfinite(b["scores"])
    res = {"finite_equal": bool((np.isfinite(a["scores"]) == fin).all()),
           "detections": int(fin.sum())}
    if not res["finite_equal"]:
        return dict(res, ok=False)
    res["classes_equal"] = bool((a["classes"][fin] == b["classes"][fin])
                                .all())
    res["score_max_diff"] = float(np.abs(a["scores"][fin]
                                         - b["scores"][fin]).max())
    res["box_max_diff"] = float(np.abs(a["boxes"][fin]
                                       - b["boxes"][fin]).max())
    pa, pb = a["masks"][fin], b["masks"][fin]
    ma, mb = pa > 0.5, pb > 0.5
    decided = ((np.abs(pa - 0.5) > MASK_PROB_TOL)
               & (np.abs(pb - 0.5) > MASK_PROB_TOL))
    iou_all = (ma & mb).sum((1, 2)) / np.maximum((ma | mb).sum((1, 2)), 1)
    union = (decided & (ma | mb)).sum((1, 2))
    iou = (decided & ma & mb).sum((1, 2)) / np.maximum(union, 1)
    iou = np.where(union > 0, iou, 1.0)
    flip = ma ^ mb
    res.update({
        "mask_prob_max_diff": float(np.abs(pa - pb).max()),
        "mask_iou_min_decided": float(iou.min()),
        "mask_iou_min_all_pixels": float(iou_all.min()),
        "undecided_pixel_share": float(1.0 - decided.mean()),
        "flipped_pixels": int(flip.sum()),
        "flipped_max_dist_from_half": float(np.maximum(
            np.abs(pa - 0.5), np.abs(pb - 0.5))[flip].max())
        if flip.any() else 0.0})
    res["ok"] = (res["classes_equal"] and res["score_max_diff"] <= 1e-3
                 and res["box_max_diff"] <= 1.0
                 and res["mask_prob_max_diff"] <= MASK_PROB_TOL
                 and res["mask_iou_min_decided"] >= 0.97
                 and res["detections"] > 0)
    return res


def seg_frames(cfg, seed, n):
    """n FakeNavEnv frames at the default 640x480 geometry, uint8 on the
    card, with their goal categories."""
    from peanut_tpu_torch.constants import hm3d_to_coco
    from peanut_tpu_torch.envs import FakeNavEnv
    rgbs, cats = [], []
    for s in range(n):
        env = FakeNavEnv(cfg, size_m=14.0, seed=seed + s, emit_gt_seg=False)
        obs = env.reset()
        for a in (1, 3, 1):
            obs = env.step(a)
        rgbs.append(np.asarray(obs["rgb"], np.uint8))
        cats.append(int(hm3d_to_coco[int(np.asarray(
            obs["objectgoal"]).reshape(-1)[0])]))
    return torch.as_tensor(np.stack(rgbs), device="cuda"), cats


def synced(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def mask_rcnn_phases(args, dev):
    """Phases 5-7; returns (B3 cases, nms_keep cases, slice_seg
    launches)."""
    import peanut_tpu_torch.models.boxes as boxes_mod
    import peanut_tpu_torch.models.roi_align as roi_align_mod
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.envs import FakeNavEnv
    from peanut_tpu_torch.envs.batch_runner import BatchRunner
    from peanut_tpu_torch.kernels.fmm_fused import fused_eikonal
    from peanut_tpu_torch.kernels.fmm_sweep import block_sweep2
    from peanut_tpu_torch.kernels.nms import nms_keep
    from peanut_tpu_torch.kernels.roi_window import (
        roi_window_pool, roi_window_pool_reference)
    from peanut_tpu_torch.models import MaskRCNN
    from peanut_tpu_torch.perception import MaskRCNNSegmenter

    t0 = time.perf_counter()
    model = MaskRCNN(num_classes=9, depth=101, seed=args.seed)
    init_s = time.perf_counter() - t0
    cfg32 = NavConfig(use_gt_seg=0, only_explore=1, switch_step=999)
    seg32 = MaskRCNNSegmenter(cfg32, model=model, device=dev)
    rgb, cats = seg_frames(cfg32, args.seed, 8)
    goal = torch.as_tensor(cats, device=dev)

    # float32 (single-nav's kernel): every window shape timed, and the
    # whole detect, kernel vs plain
    img32 = seg32.preprocess(rgb)
    calls = []
    with capture(roi_align_mod, "roi_window_pool", calls):
        det_k = model.detect_batch(img32)
    if len(calls) != 6:
        fail(f"expected 6 ROI pool calls in a detect, got {len(calls)} "
             "(the square window covers every ROI at this geometry?)")
    b3_f32 = {}
    for i, name in enumerate(ROI_SHAPES):
        b3_f32[name] = check_pool(calls[i], timed=True)
        emit({"phase": "kernel", "kernel": f"roi_window_pool/float32_{name}",
              **b3_f32[name]})
    del calls
    with Patch(roi_align_mod, "roi_window_pool",
               lambda _: roi_window_pool_reference):
        det_p = model.detect_batch(img32)
    agree = detections_agree(det_k, det_p)
    del det_k, det_p, img32

    # bfloat16 (serving): the kernel lines with times and bounds
    cfg16 = NavConfig(use_gt_seg=0, only_explore=1, switch_step=999,
                      serve_bf16=True)
    seg16 = MaskRCNNSegmenter(cfg16, model=model, device=dev)
    img16 = seg16.preprocess(rgb)
    calls, nms_calls = [], []
    with capture(roi_align_mod, "roi_window_pool", calls), \
            capture(boxes_mod, "nms_keep", nms_calls):
        det = model.detect_batch(img16)
    b3 = {}
    for i, name in enumerate(ROI_SHAPES):
        b3[name] = check_pool(calls[i], timed=True)
        emit({"phase": "kernel", "kernel": f"roi_window_pool/{name}",
              **b3[name]})
    b3.update({f"float32_{k}": v for k, v in b3_f32.items()})
    emit({"phase": "kernel_breakdown", "kernel": "roi_window_pool",
          "ms": {k: v.get("breakdown_ms") for k, v in b3.items()},
          "ms_by_ring_rows": {k: v.get("ms_by_ring_rows")
                              for k, v in b3.items()}})
    del calls
    if not all(c["ok"] for c in b3.values()):
        fail("roi_window_pool disagrees with its plain version, or the "
             "bar cannot see a pool that skips rounding A_y")
    if args.only == "b3":
        return b3, None, None
    if len(nms_calls) != len(NMS_CALLS):
        fail(f"expected {len(NMS_CALLS)} NMS calls in a detect, got "
             f"{len(nms_calls)}")
    # the walk's chain floor: one dependent step, a shuffle and the shared-
    # memory read it addresses
    from peanut_tpu_torch.kernels.nms import chain_step_us
    step_us = chain_step_us()
    emit({"phase": "nms_chain", "us_per_step": step_us,
          "floor_ms_by_n": {str(c[0].shape[-1]): c[0].shape[-1] * step_us
                            / 1e3 for c in nms_calls}})
    nms = {}
    for name, call in zip(NMS_CALLS, nms_calls):
        nms[name] = check_nms(call, timed=True, step_us=step_us)
        emit({"phase": "kernel", "kernel": f"nms_keep/{name}", **nms[name]})
    del nms_calls
    if not all(c["equal"] for c in nms.values()):
        fail("nms_keep disagrees with its plain version")

    # detect: frames/s at batch 8 in bf16, the stage split, peak memory
    h, w = img16.shape[1], img16.shape[2]
    for _ in range(2):
        model.detect_batch(img16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t1 = time.perf_counter()
    for _ in range(iters):
        det = model.detect_batch(img16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    stages = {k: [] for k in ("backbone_fpn", "rpn_proposals",
                              "box_head_roialign_nms", "mask_head_roialign",
                              "paste")}
    for _ in range(3):
        pyr, t = synced(lambda: model.features(img16))
        stages["backbone_fpn"].append(t)
        props, t = synced(lambda: model.proposals(pyr, h, w))
        stages["rpn_proposals"].append(t)
        (bx, sc, cl), t = synced(lambda: model.box_inference(
            pyr, *props, h, w, roi_ctx=model.roi_context(pyr)))
        stages["box_head_roialign_nms"].append(t)
        ms, t = synced(lambda: model.mask_inference(pyr, bx, cl))
        stages["mask_head_roialign"].append(t)
        sem, t = synced(lambda: seg16.paste(bx.float(), sc.float(), cl,
                                            ms.float(), goal))
        stages["paste"].append(t)
    del pyr, props
    finite = bool(all(torch.isfinite(det[k].float()).all()
                      for k in ("boxes", "masks")))
    emit({
        "phase": "detect", "model": "R101-FPN", "batch": 8,
        "image": [h, w], "dtype": "bfloat16",
        "maskrcnn_r101_800x1088_frames_per_sec": 8 * iters / dt,
        "ms_per_batch": dt / iters * 1e3,
        "stage_ms": {k: float(np.median(v)) for k, v in stages.items()},
        "peak_memory_mib": peak, "init_seconds": init_s,
        "detections_per_image": float(torch.isfinite(
            det["scores"]).sum(1).float().mean()),
        "outputs_finite": finite,
        "kernel_vs_plain_float32": agree})
    if not agree["ok"] or not finite:
        fail("the detect through kernel B3 misses the plain ROI path's "
             "detections (golden-test bar) or is not finite")

    # the slice with Mask R-CNN semantics: 16 envs, serving dtype
    n_envs = 16
    runner = BatchRunner(
        cfg16, [lambda s=s: FakeNavEnv(cfg16, size_m=14.0,
                                       seed=args.seed + s, emit_gt_seg=False)
                for s in range(n_envs)], segmenter=seg16, device=dev)
    runner.reset_all()
    for _ in range(3):
        runner.tick()
    runner.warmup_rare_paths()
    runner.reset_timers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_eikonal.launches = 0
    block_sweep2.launches = 0
    roi_window_pool.launches = 0
    nms_keep.launches = 0
    tick_ms = []
    t1 = time.perf_counter()
    for _ in range(SEG_TICKS):
        t2 = time.perf_counter()
        runner.tick()
        tick_ms.append((time.perf_counter() - t2) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = {"fused_eikonal": fused_eikonal.launches,
                "block_sweep2": block_sweep2.launches,
                "roi_window_pool": roi_window_pool.launches,
                "nms_keep": nms_keep.launches}
    rt = runner.runtime
    maps_finite = bool(torch.isfinite(rt.state.local_maps).all())
    sem_cells = float((rt.state.local_maps[:, 4:4 + seg16.n_cats] > 0)
                      .sum())
    emit({"phase": "slice_seg", "envs": n_envs, "ticks": SEG_TICKS,
          "config": "NavConfig(use_gt_seg=0, only_explore=1, "
                    "switch_step=999, serve_bf16=True)",
          "env_steps_per_sec": n_envs * SEG_TICKS / dt,
          "tick_ms_median": float(np.median(tick_ms)),
          "tick_ms_mean": dt / SEG_TICKS * 1e3,
          "stage_ms_per_tick": {k: round(v / SEG_TICKS * 1e3, 3)
                                for k, v in runner.stage_totals().items()},
          "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
          "launches": launches, "maps_finite": maps_finite,
          "semantic_map_cells": sem_cells,
          "episodes_done": len(runner.metrics)})
    runner.close()
    if min(launches.values()) <= 0:
        fail(f"the seg slice did not launch every kernel: {launches}")
    if not maps_finite or sem_cells <= 0:
        fail("the seg slice's maps are not finite or hold no Mask R-CNN "
             "semantics")
    return b3, nms, launches, model


# ---------------------------------------------------------------------------
# The 16-env serving tick with target prediction (bench.py::bench_env_steps)

# bench.py:308-311: the serving profile (half-resolution first-order goal
# field, 8-row tiling, the prediction program after the tick's collect) and
# the exact one (the order-2 field at full resolution, synchronous
# prediction in the tick), both with Mask R-CNN and bf16 serving
PROFILES = {
    "serve_16": dict(dd_downscale=2, dd_order=1, dd_block=8, dd_inner=24,
                     plan_block=8, plan_inner=24, pred_async=1),
    "exact_16": dict(dd_downscale=1),
}
PROFILE_TICKS = {"serve_16": 20, "exact_16": 10}
PARITY_ENVS = 8
# the exact profile's plain goal-weighting solve (order 2 at 8 x 960^2)
# takes ~37 s a tick on the H100, and under random PSPNet weights every
# tick triggers: 4 of its ticks keep the script inside its time limit
PARITY_TICKS = {"serve_16": 12, "exact_16": 4}
SERVE_STAGES = ("env_phase", "dispatch", "tick_wait", "pred_dispatch",
                "pred_goal_wait", "detect")


def kernel_counts(reset: bool = False) -> dict:
    """The launch counts of every kernel (set to 0 with ``reset``)."""
    from peanut_tpu_torch.kernels import fmm_long
    from peanut_tpu_torch.kernels.fmm_fused import fused_eikonal
    from peanut_tpu_torch.kernels.fmm_sweep import block_sweep, block_sweep2
    from peanut_tpu_torch.kernels.nms import nms_keep
    from peanut_tpu_torch.kernels.roi_window import roi_window_pool
    fns = {"fused_eikonal": fused_eikonal, "block_sweep2": block_sweep2,
           "roi_window_pool": roi_window_pool, "nms_keep": nms_keep,
           "block_sweep": block_sweep,
           **{name: getattr(fmm_long, name) for name in LONG_CASES}}
    if reset:
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def serving_phases(args, dev, maskrcnn):
    """Phases serve_16, exact_16 and pred_parity; returns the launches of
    each profile's measured ticks."""
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.envs import FakeNavEnv
    from peanut_tpu_torch.envs.batch_runner import BatchRunner
    from peanut_tpu_torch.agent.batched_runtime import BatchedNavRuntime
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                peanut_prediction_config)
    from peanut_tpu_torch.perception import MaskRCNNSegmenter
    from peanut_tpu_torch.prediction import PredictionModel

    # PSPNet-R50-v1c from a seed; bf16 like the serving configs
    pspnet = build_segmentor(peanut_prediction_config(), seed=args.seed)
    launches = {}
    for name, kw in PROFILES.items():
        cfg = NavConfig(use_gt_seg=0, serve_bf16=True, **kw)
        ticks = PROFILE_TICKS[name]
        runner = BatchRunner(
            cfg, [lambda s=s: FakeNavEnv(cfg, size_m=14.0,
                                         seed=args.seed + s,
                                         emit_gt_seg=False)
                  for s in range(16)],
            prediction_model=PredictionModel(cfg, model=pspnet, device=dev),
            segmenter=MaskRCNNSegmenter(cfg, model=maskrcnn, device=dev),
            device=dev)
        runner.reset_all()
        for _ in range(5):
            runner.tick()
        runner.warmup_rare_paths()
        runner.reset_timers()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_counts(reset=True)
        tick_ms = []
        t0 = time.perf_counter()
        for _ in range(ticks):
            t1 = time.perf_counter()
            runner.tick()
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = kernel_counts()
        st = runner.runtime.state
        stages = {k: v / ticks * 1e3 for k, v in runner.stage_totals().items()}
        reading = {
            "phase": name, "envs": 16, "ticks": ticks,
            "config": f"NavConfig(use_gt_seg=0, serve_bf16=True, {kw})",
            "steps_per_sec": 16 * ticks / dt,
            "tick_ms_median": float(np.median(tick_ms)),
            "tick_ms_mean": dt / ticks * 1e3,
            "stage_ms_per_tick": {k: stages.get(k, 0.0)
                                  for k in SERVE_STAGES},
            "stage_ms_per_tick_all": stages,
            "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "launches": launches[name],
            "goal_fields_set": int(st.dd_valid.sum()),
            "episodes_done": len(runner.metrics)}
        emit(reading)
        finite = bool(torch.isfinite(st.local_maps).all()
                      and torch.isfinite(st.target_pred).all())
        runner.close()
        need = ("fused_eikonal", "block_sweep2", "roi_window_pool",
                "nms_keep")
        if min(launches[name][k] for k in need) <= 0:
            fail(f"{name} did not launch every kernel: {launches[name]}")
        if not finite or reading["goal_fields_set"] <= 0:
            fail(f"{name}: maps not finite, or no prediction ran")

    # pred_parity: the prediction branch through the kernels and through
    # the plain versions (its goal-weighting solve), GT semantics, 8 envs
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    parity = {}
    try:
        for name, kw in PROFILES.items():
            cfg = NavConfig(use_gt_seg=1, serve_bf16=True, **kw)
            pm = PredictionModel(cfg, model=pspnet, device=dev)
            runs = []
            for plain in (False, True):
                rt = BatchedNavRuntime(cfg, PARITY_ENVS, prediction_model=pm,
                                       device=dev, plain=plain)
                envs = [FakeNavEnv(cfg, size_m=14.0, seed=args.seed + s)
                        for s in range(PARITY_ENVS)]
                obs = [e.reset() for e in envs]
                for i in range(PARITY_ENVS):
                    rt.reset_env(i)
                t0 = time.perf_counter()
                c0 = kernel_counts()["fused_eikonal"]
                acts, fields = [], []
                for _ in range(PARITY_TICKS[name]):
                    out = rt.act_batch(obs)
                    rt.wait_pending_goal()
                    acts.append([a["action"] for a in out])
                    fields.append({k: getattr(rt.state, k).clone() for k in
                                   ("cur_goal", "target_pred", "dd_wt")})
                    obs = [e.step(a) for e, a in zip(envs, out)]
                torch.cuda.synchronize()
                runs.append(dict(
                    acts=acts, fields=fields,
                    seconds=time.perf_counter() - t0,
                    b1=kernel_counts()["fused_eikonal"] - c0,
                    triggers=int(rt.state.dd_valid.sum())))
            k_run, p_run = runs
            eq = {f: all(torch.equal(a[f], b[f]) for a, b in
                         zip(k_run["fields"], p_run["fields"]))
                  for f in ("cur_goal", "target_pred", "dd_wt")}
            parity[name] = dict(
                actions_equal=k_run["acts"] == p_run["acts"],
                cur_goal_equal=eq["cur_goal"],
                target_pred_bit_equal=eq["target_pred"],
                dd_wt_bit_equal=eq["dd_wt"],
                b1_launches_kernel_run=k_run["b1"],
                b1_launches_plain_run=p_run["b1"],
                envs_with_goal_field=k_run["triggers"],
                seconds_kernel_run=k_run["seconds"],
                seconds_plain_run=p_run["seconds"])
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    emit({"phase": "pred_parity", "envs": PARITY_ENVS,
          "ticks": PARITY_TICKS, "profiles": parity})
    for name, p in parity.items():
        if not (p["actions_equal"] and p["cur_goal_equal"]
                and p["target_pred_bit_equal"] and p["dd_wt_bit_equal"]):
            fail(f"pred_parity {name}: the kernels' prediction branch "
                 f"differs from the plain versions': {p}")
        if p["envs_with_goal_field"] <= 0:
            fail(f"pred_parity {name}: no prediction ran")
    return launches


# ---------------------------------------------------------------------------
# The single-env agent (kernel B4) through its CLIs

EXPLORE_STEPS = 100
NAV_STEPS = 50
PLAN_CHECKS = 2      # recorded planner inputs held against the plain solve


def drive_cli(module, argv, seed, counters, record=None):
    """Run ``module.main(argv)`` on FakeNavEnv(size_m=14.0) with every
    kernel count set to 0 just before and read just after.  Returns (agent,
    per-step seconds, launches)."""
    from peanut_tpu_torch.envs import FakeNavEnv

    agents, step_s = [], []

    def make_env(cfg, fake, env_seed=None):
        return FakeNavEnv(cfg, size_m=14.0,
                          seed=seed if env_seed is None else env_seed)

    def timed_agent(cls):
        def make(*a, **kw):
            agent = cls(*a, **kw)
            act = agent.act

            def timed(obs):
                t0 = time.perf_counter()
                out = act(obs)
                step_s.append(time.perf_counter() - t0)
                return out
            agent.act = timed
            agents.append(agent)
            return agent
        return make

    with contextlib.ExitStack() as stack:
        for p in [Patch(module, "make_env", lambda _: make_env),
                  Patch(module, "PeanutAgent", timed_agent)] + (record or []):
            stack.enter_context(p)
        for c in counters:
            c.launches = 0
        module.main(argv)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    return agents[0], step_s, launches


def stage_report(agent, steps):
    """Per-step ms of each StageTimer stage (total / steps) and its calls."""
    return {k: {"ms_per_step": v["total_s"] / steps * 1e3,
                "calls": v["count"], "mean_ms": v["mean_ms"]}
            for k, v in agent.timer.summary().items()}


def round_trip_ms(local_map, dev) -> float:
    """The local window's trip to the card and back, as the agent makes it
    every step (host timed, median of 10)."""
    from peanut_tpu_torch import upload
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        upload(local_map[None], dev).cpu().numpy()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def single_reading(name, agent, step_s, launches, dev, extra):
    st = agent.agent_state
    steps = len(step_s)
    out = {"phase": name, "steps": steps,
           "steps_per_sec": steps / sum(step_s),
           "step_ms_median": float(np.median(step_s)) * 1e3,
           "first_step_ms": step_s[0] * 1e3,
           "stage": stage_report(agent, steps),
           "host_round_trip_ms": round_trip_ms(st.local_map, dev),
           "local_map_bytes": st.local_map.nbytes,
           "launches": launches,
           "maps_finite": bool(np.isfinite(st.full_map).all()
                               and np.isfinite(st.local_map).all()),
           "explored_cells": int((st.local_map[1] > 0).sum()),
           "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    out.update(extra)
    emit(out)
    return out


@torch.no_grad()
def single_env_phases(args, dev):
    """Phases 8-10; returns the launches of each single-env phase and
    single_nav's checks of B3 and nms_keep at its own shapes."""
    import tempfile

    import peanut_tpu_torch.cli.collect as collect_cli
    import peanut_tpu_torch.cli.collect_maps as maps_cli
    import peanut_tpu_torch.models.boxes as boxes_mod
    import peanut_tpu_torch.models.roi_align as roi_align_mod
    from peanut_tpu_torch.kernels.fmm import (eikonal_distance,
                                              masked_fill_unreachable)
    from peanut_tpu_torch.kernels.fmm_fused import fused_eikonal
    from peanut_tpu_torch.kernels.fmm_sweep import block_sweep, block_sweep2
    from peanut_tpu_torch.kernels.nms import nms_keep
    from peanut_tpu_torch.kernels.roi_window import roi_window_pool
    from peanut_tpu_torch.models import MaskRCNN
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                 peanut_prediction_config)
    from peanut_tpu_torch.planning import FMMPlanner

    counters = (fused_eikonal, block_sweep, block_sweep2, roi_window_pool,
                nms_keep)
    common = ["--fake_env", "1", "--num_episodes", "1",
              "--seed", str(args.seed)]

    # ---- 8. single_explore: map collection -----------------------------
    plans_seen = []

    def record_goal(fn):
        def wrapped(self, goal_map):
            plans_seen.append({"trav": self.traversible.copy(),
                               "goal": goal_map.copy()})
            return fn(self, goal_map)
        return wrapped

    def record_stg(fn):
        def wrapped(self, state):
            out = fn(self, state)
            plans_seen[-1].update(state=list(state), stg=out)
            return out
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        n = str(EXPLORE_STEPS)
        agent, step_s, explore = drive_cli(
            maps_cli, common + ["--use_gt_seg", "1", "--max_episode_length",
                                n, "--timestep_limit", n, "--out_dir", tmp],
            args.seed, counters,
            record=[Patch(FMMPlanner, "set_multi_goal", record_goal),
                    Patch(FMMPlanner, "get_short_term_goal", record_stg)])
        saved = [np.load(os.path.join(tmp, "val_80", f))["maps"]
                 for f in sorted(os.listdir(os.path.join(tmp, "val_80")))]
    reading = single_reading(
        "single_explore", agent, step_s, explore, dev,
        {"config": "cli/collect_maps.py: use_gt_seg=1 (only_explore=1, "
                   "switch_step=999, global_downscaling=4 forced)",
         "npz_saved": [[list(m.shape), str(m.dtype)] for m in saved]})
    if (len(step_s) != EXPLORE_STEPS or not reading["maps_finite"]
            or reading["explored_cells"] <= 0
            or explore["block_sweep"] <= 0 or explore["block_sweep2"] <= 0
            or len(saved) != 1 or saved[0].shape != (20, 14, 960, 960)
            or saved[0].dtype != np.uint8):
        fail(f"single_explore: steps, maps, npz or launches wrong: {reading}")

    # ---- 9. plan_check_2d: recorded 242^2 planner inputs, kernels vs plain
    done = [r for r in plans_seen if "state" in r]
    checks = []
    for rec in done[-PLAN_CHECKS:]:
        fields, decisions = {}, {}
        for plain in (False, True):
            d = eikonal_distance(
                torch.as_tensor(rec["trav"], device=dev),
                torch.as_tensor(rec["goal"] == 1, device=dev),
                n_iters=2, plain=plain)
            fields[plain] = masked_fill_unreachable(d).cpu().numpy()
            planner = FMMPlanner(rec["trav"], device=dev)
            planner.fmm_dist = fields[plain]
            decisions[plain] = planner.get_short_term_goal(rec["state"])
        checks.append({
            "shape": list(rec["trav"].shape),
            "fields_bit_equal": bool(np.array_equal(fields[False],
                                                    fields[True])),
            "decisions_equal": decisions[False] == decisions[True]
            == tuple(rec["stg"]),
            "stg": [float(x) for x in decisions[False][:3]]})
    emit({"phase": "plan_check_2d", "recorded": len(done), "checks": checks})
    if len(checks) != PLAN_CHECKS or not all(
            c["fields_bit_equal"] and c["decisions_equal"] for c in checks):
        fail("plan_check_2d: the kernel solve differs from the plain solve")
    del plans_seen, done

    # ---- 10. single_nav: Mask R-CNN + PSPNet from checkpoints ----------
    with tempfile.TemporaryDirectory() as tmp:
        seg_path = os.path.join(tmp, "mask_rcnn_R_101_cat9.pth")
        pred_path = os.path.join(tmp, "pred_model_wts.pth")
        torch.save({"model": MaskRCNN(num_classes=9, depth=101,
                                      seed=args.seed).state_dict()},
                   seg_path)
        torch.save({"state_dict": build_segmentor(
            peanut_prediction_config(), seed=args.seed).state_dict(),
            "meta": {}}, pred_path)
        n = str(NAV_STEPS)
        # the first detect's B3 and NMS calls (batch 1, float32), held
        # against the plain versions after the run
        detects, pool_calls, nms_calls = [], [], []

        def count_detect(fn):
            def wrapped(self, imgs):
                detects.append(imgs.shape[0])
                return fn(self, imgs)
            return wrapped

        def first_detect():
            return len(detects) == 1

        torch.cuda.reset_peak_memory_stats()
        agent, step_s, nav = drive_cli(
            collect_cli, common + ["--max_episode_length", n,
                                   "--timestep_limit", n,
                                   "--seg_model_wts", seg_path,
                                   "--pred_model_wts", pred_path],
            args.seed, counters,
            record=[Patch(MaskRCNN, "detect_batch", count_detect),
                    capture(roi_align_mod, "roi_window_pool", pool_calls,
                            when=first_detect),
                    capture(boxes_mod, "nms_keep", nms_calls,
                            when=first_detect)])
    nav_checks = {
        "roi_window_pool": {f"single_nav_{i}": check_pool(c, timed=True)
                            for i, c in enumerate(pool_calls)},
        "nms_keep": {name: check_nms(c, timed=False)
                     for name, c in zip(("single_nav_rpn", "single_nav_box"),
                                        nms_calls)}}
    del pool_calls
    emit({"phase": "single_nav_kernel_checks", "detect_batch": detects[0],
          **nav_checks})
    if (not nav_checks["roi_window_pool"] or len(nms_calls) != 2
            or not all(c["ok"] for c in
                       nav_checks["roi_window_pool"].values())
            or not all(c["equal"] for c in nav_checks["nms_keep"].values())):
        fail("single_nav: roi_window_pool or nms_keep disagrees with its "
             "plain version at the single-env shapes, or was not captured")
    del nms_calls
    st = agent.agent_state
    pred_ok = bool(st.target_pred is not None
                   and st.target_pred.shape == st.local_map.shape[1:]
                   and np.isfinite(st.target_pred).all()
                   and np.isfinite(st.value).all())
    reading = single_reading(
        "single_nav", agent, step_s, nav, dev,
        {"config": "cli/collect.py single-env, NavConfig defaults "
                   "(use_gt_seg=0, only_explore=0 forced), random-weight "
                   "checkpoints",
         "prediction_finite": pred_ok,
         "semantic_cells": int((st.full_map[4:] > 0).sum())})
    if (len(step_s) != NAV_STEPS or not reading["maps_finite"] or not pred_ok
            or min(nav[k] for k in ("block_sweep", "block_sweep2",
                                    "roi_window_pool", "nms_keep")) <= 0
            or "goal_solve" not in reading["stage"]):
        fail(f"single_nav: steps, maps, prediction or launches wrong: "
             f"{reading}")
    return explore, nav, nav_checks


# bitwise by design (same operation order, association and rounding as the
# plain version; see the notes in the .cu sources); the tolerance admits no
# more than float32 rounding noise on ~1000-cell distances
TOL = 1e-3
WIDE_TOL = TOL       # the lines over 1024 cells too


def b1_cases(rng, dev, barrier_us) -> dict:
    """B1 at the paths' shapes (B1_CASES) against its plain version, with
    its time, bound and chain; one kernel line each.  The plain version at
    960^2 and over is timed by the one call it is compared by."""
    from peanut_tpu_torch.kernels import fmm_sweep
    from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                    fused_eikonal_reference)
    results = {}
    for case, p in B1_CASES.items():
        (b, n), kw = p["shape"], {k: v for k, v in p.items() if k != "shape"}
        trav_np, src_np = plans(rng, b, n)
        trav = torch.as_tensor(trav_np, device=dev)
        src = torch.as_tensor(src_np, device=dev)
        got = fused_eikonal(trav, src, **kw)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = fused_eikonal_reference(trav, src, **kw)
        t1.record()
        torch.cuda.synchronize()
        cmp = dict(compare(got, want, TOL),
                   bit_equal=bool(torch.equal(got, want)))
        ms = cuda_ms(lambda: fused_eikonal(trav, src, **kw), reps=10)
        plain_ms = (t0.elapsed_time(t1) if n > 482 else cuda_ms(
            lambda: fused_eikonal_reference(trav, src, **kw), reps=1))
        plan = fmm_sweep.launch_plan(1, trav, kw["block"],
                                     fused_chunk=kw["scan_chunk"])
        links = fused_links(n, kw)
        cells = b * n * n
        ops = cells * kw["rounds"] * 2 * (
            GODUNOV1_OPS * kw["inner"]
            + 2 * SCAN_OPS * (kw["inner"] // kw["scan_chunk"]))
        if kw["vscan"]:
            ops += cells * kw["rounds"] * 2 * SCAN_OPS
        bound_ms, bound_by = bound(cells, 2 + 4, ops)
        results[f"B1_{case}"] = dict(
            cmp, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, cluster=plan.cluster, blocks_x_passes=links,
            us_per_pass=ms / links * 1e3,
            chain_floor_ms=links * barrier_us.get(plan.cluster, 0.0) / 1e3)
        emit({"phase": "kernel", "kernel": f"fused_eikonal/{case}",
              **results[f"B1_{case}"]})
    return results


# the long-line kernels (csrc/fmm_long.cu) past the shared-memory
# kernels' lines: wide_lines's cases of each, the first the kernels line's
LONG_CASES = {"fused_eikonal_long": ("B1_rows_1x16x6000_b8",
                                     "B1_vscan_2x8192x48"),
              "block_sweep_long": ("B4_1x16x40000", "B4_1x48x8192"),
              "block_sweep2_long": ("B2_1x16x20000",)}


def wide_lines(args, dev) -> dict:
    """Lines over 1024 cells: B4's rows, B1's rows and, with column scans,
    columns (lines of 48 cells the other way); B1 at the exact profile's
    1042^2 blanket beside 1024^2; past 2048 cells (a group of up to four
    warps a line) and rows too wide for B1's full ghost rows (1608^2 at
    block 8, 16 x 1700^2 at block 16); then the long-line kernels'
    shapes (LONG_CASES: order-1 lines over 4096 cells, B1 rows past its
    shared memory with one ghost row, B2 rows past its shared memory at
    C = 16); bit-equal to the plain versions, with times (the long
    cases' plain versions, bounds and launches too).  Returns the cases."""
    from peanut_tpu_torch.kernels import fmm_long, fmm_sweep
    from peanut_tpu_torch.kernels.fmm import BIG, _axis_relax
    from peanut_tpu_torch.kernels.fmm_fused import (fused_eikonal,
                                                    fused_eikonal_reference)
    from peanut_tpu_torch.kernels.fmm_sweep import (block_sweep,
                                                    block_sweep2,
                                                    block_sweep2_reference,
                                                    block_sweep_reference)
    rng = np.random.RandomState(args.seed + 3)
    wide = {}
    blanket = {k: v for k, v in B1_CASES["blanket_16x962"].items()
               if k != "shape"}
    vscan_kw = {k: v for k, v in B1_CASES["vscan_8x480"].items()
                if k != "shape"}
    rows_b8 = {k: v for k, v in B1_CASES["blanket_16x482_b8"].items()
               if k != "shape"}
    # one round: the plain version steps 1024 row blocks a sweep from
    # Python (~18 s a round at 2 x 8192 x 48)
    long_vscan = dict(vscan_kw, rounds=1)
    long_keys = {k for ks in LONG_CASES.values() for k in ks}
    for f in (fmm_long.fused_eikonal_long, fmm_long.block_sweep_long,
              fmm_long.block_sweep2_long):
        f.launches = 0
    for key, shape, kw in (("B4_1x48x1040", (1, 48, 1040), None),
                           ("B4_1x48x2000", (1, 48, 2000), None),
                           ("B4_1x48x2049", (1, 48, 2049), None),
                           ("B4_1x48x4096", (1, 48, 4096), None),
                           ("B1_vscan_2x48x1040", (2, 48, 1040), vscan_kw),
                           ("B1_vscan_2x1040x48", (2, 1040, 48), vscan_kw),
                           ("B1_vscan_1x2000x48", (1, 2000, 48), vscan_kw),
                           ("B1_vscan_2x4096x48", (2, 4096, 48), vscan_kw),
                           ("B1_blanket_1x1024", (1, 1024, 1024), blanket),
                           ("B1_blanket_1x1042", (1, 1042, 1042), blanket),
                           ("B1_vscan_1x1608_b8", (1, 1608, 1608), vscan_kw),
                           ("B1_blanket_16x1700", (16, 1700, 1700),
                            blanket),
                           ("B4_1x48x8192", (1, 48, 8192), None),
                           ("B4_1x16x40000", (1, 16, 40000), None),
                           ("B1_vscan_2x8192x48", (2, 8192, 48), long_vscan),
                           ("B1_rows_1x16x6000_b8", (1, 16, 6000), rows_b8),
                           ("B2_1x16x20000", (1, 16, 20000), "B2")):
        if shape[1] == shape[2]:
            trav_np, src_np = plans(rng, shape[0], shape[1])
        else:
            trav_np = rng.rand(*shape) > 0.25
            src_np = np.zeros(shape, bool)
            for i in range(shape[0]):
                src_np[i, rng.randint(shape[1]), rng.randint(shape[2])] = True
        trav = torch.as_tensor(trav_np, device=dev)
        src = torch.as_tensor(src_np, device=dev)
        cells = int(np.prod(shape))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if kw is None:
            wall = ~trav & ~src
            d_in = _axis_relax(torch.where(src, 0.0, BIG).float(), wall)
            run = lambda: block_sweep(d_in, wall, False)      # noqa: E731
            t0.record()
            want = block_sweep_reference(d_in, wall, False)
            t1.record()
            plan = fmm_sweep.launch_plan(1, d_in, 16)
            # as phase 3's B4: inner 40 passes, 2 x 40 row scans
            bnd = bound(cells, 4 + 1 + 4,
                        cells * 40 * (GODUNOV1_OPS + 2 * SCAN_OPS))
        elif kw == "B2":
            wall = ~trav & ~src
            d_in = torch.where(src, 0.0, BIG).float()
            run = lambda: block_sweep2(d_in, wall, src, False)  # noqa: E731
            t0.record()
            want = block_sweep2_reference(d_in, wall, src, False)
            t1.record()
            plan = fmm_sweep.launch_plan(2, d_in, 16)
            bnd = bound(cells, 4 + 1 + 1 + 4, cells * 40 * GODUNOV2_OPS)
        else:
            run = lambda: fused_eikonal(trav, src, **kw)      # noqa: E731
            t0.record()
            want = fused_eikonal_reference(trav, src, **kw)
            t1.record()
            plan = fmm_sweep.launch_plan(1, trav, kw["block"],
                                         fused_chunk=kw["scan_chunk"])
            ops = cells * kw["rounds"] * 2 * (
                GODUNOV1_OPS * kw["inner"]
                + 2 * SCAN_OPS * (kw["inner"] // kw["scan_chunk"]))
            if kw["vscan"]:
                ops += cells * kw["rounds"] * 2 * SCAN_OPS
            bnd = bound(cells, 2 + 4, ops)
        got = run()
        torch.cuda.synchronize()
        wide[key] = dict(compare(got, want, WIDE_TOL),
                         bit_equal=bool(torch.equal(got, want)),
                         ms=cuda_ms(run, reps=3), cluster=plan.cluster,
                         seg=plan.seg, ghosts=plan.ghosts,
                         smem_bytes=plan.smem_bytes, long=plan.long)
        if key in long_keys:
            wide[key].update(plain_ms=t0.elapsed_time(t1), bound_ms=bnd[0],
                             bound_by=bnd[1])
            if not plan.long:
                fail(f"{key}: the plan is not the long-line kernel's")
    wide["long_launches"] = {
        f.__name__: f.launches for f in (fmm_long.fused_eikonal_long,
                                         fmm_long.block_sweep_long,
                                         fmm_long.block_sweep2_long)}
    emit({"phase": "wide_lines", "cases": wide})
    if not all(c["ok"] and c["bit_equal"] for k, c in wide.items()
               if k != "long_launches"):
        fail("a kernel disagrees with its plain version on lines over "
             "1024 cells")
    if not all(wide["long_launches"].values()):
        fail(f"a long-line kernel never launched: {wide['long_launches']}")
    return wide


# ---- the train phase: PSPNet-R50-v1c training and evaluation ----------
TRAIN_MAP = 960          # the recipe's crop and the synthetic maps' size
TRAIN_BATCH = 8
TRAIN_ITERS = (4, 6)     # the first run, then the resumed one
OVERFIT_STEPS = 10
TIMED_FROM = 2           # overfit steps before this one warm up
PARITY_BASE = 8          # the CPU tests' tiny PSPNet (base width 8)
PARITY_LOSS_TOL = 1e-5   # relative
PARITY_GRAD_TOL = 1e-4   # of the largest |gradient|
SERVE_TOL = 1e-5         # checkpoint -> PredictionModel, probabilities


def write_train_maps(dirpath: str, seed: int, size: int = TRAIN_MAP,
                     n_files: int = 2) -> None:
    """The verify recipe's synthetic episodes at ``size``: 20 timesteps of
    a growing explored square with obstacle rows, sparse goal channels
    (uncompressed npz: 258 MB a file at 960^2 writes and reads in a
    fraction of the compressed file's time)."""
    rng = np.random.RandomState(seed)
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n_files):
        seq = np.zeros((20, 14, size, size), np.uint8)
        for t in range(20):
            r = size // 20 + t * size // 25
            seq[t, 1, :r, :r] = 255
            seq[t, 0, :r:4, :r] = 255
        seq[:, 4:10] = (rng.rand(1, 6, size, size) > 0.97) * 255
        np.savez(os.path.join(dirpath, f"f{i:05d}.npz"), maps=seq)


def tiny_pspnet_config() -> dict:
    """tests/test_torch_training.py's tiny PSPNet (dropout 0)."""
    from peanut_tpu_torch.models.pspnet import peanut_prediction_config
    cfg = peanut_prediction_config()
    cfg["backbone"].update(base_channels=PARITY_BASE,
                           stem_channels=PARITY_BASE)
    cfg["decode_head"].update(in_channels=PARITY_BASE * 32,
                              channels=PARITY_BASE * 8, dropout_ratio=0.0)
    cfg["auxiliary_head"].update(in_channels=PARITY_BASE * 16,
                                 channels=PARITY_BASE * 4, dropout_ratio=0.0)
    return cfg


def card_against_cpu(dev, seed: int) -> dict:
    """One train step of the tiny PSPNet (batch 2, crop 64) from the same
    state on the card and on the CPU: in float64 the gate (loss within
    1e-5 relative, gradients within 1e-4 of the largest |gradient|); in
    float32 with TF32 off the same numbers, reported (float32 gradients of
    this net are rounding-bound: tests/test_torch_training.py)."""
    from peanut_tpu_torch.models.pspnet import build_segmentor
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   loss_and_grads)
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 14, 64, 64) * np.float64([1, 3])[:, None, None, None]
    gt = (rng.rand(2, 6, 64, 64) > 0.9) * 255.0
    tcfg = TrainConfig(lr=1e-3, max_iters=50, seed=seed)
    out = {}
    for dtype in (torch.float64, torch.float32):
        res = {}
        for where in ("cpu", dev):
            model = build_segmentor(tiny_pspnet_config(), seed=seed)
            state = create_train_state(model.to(dtype), tcfg, device=where)
            batch = {"img": torch.as_tensor(img, dtype=dtype, device=where),
                     "gt": torch.as_tensor(gt, dtype=dtype, device=where)}
            loss = loss_and_grads(state, batch, tcfg)["loss"]
            res[str(where)] = (float(loss), {
                n: p.grad.detach().double().cpu()
                for n, p in state.model.named_parameters()})
        (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
        top = max(float(g.abs().max()) for g in gc.values())
        err = max(float((gg[n] - gc[n]).abs().max()) for n in gc)
        out[str(dtype).replace("torch.", "")] = {
            "loss_cpu": lc, "loss_card": lg,
            "loss_rel_err": abs(lg - lc) / abs(lc),
            "grad_err_of_largest": err / top}
    return out


def training_phase(args, dev, smi_line: str) -> dict:
    """Gates 1-5 of the train phase (module docstring); returns its
    reading."""
    import tempfile

    from peanut_tpu_torch.cli import test as test_cli
    from peanut_tpu_torch.cli import train_prediction_model
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                 peanut_prediction_config)
    from peanut_tpu_torch.prediction import PredictionModel
    from peanut_tpu_torch.prediction.dataset import (PrefetchLoader,
                                                     SemMapDataset,
                                                     training_pipeline)
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   loss_and_grads,
                                                   upload_batch)
    from peanut_tpu_torch.utils.loggers import read_train_log

    reading = {"phase": "train", "nvidia_smi": smi_line,
               "model": "PSPNet-R50-v1c", "batch": TRAIN_BATCH,
               "crop": TRAIN_MAP, "channels": 14, "classes": 6}
    try:
        import cv2
        reading["cv2"] = cv2.__version__
    except ImportError:
        reading["cv2"] = None
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_train_maps(os.path.join(tmp, "train_80"), args.seed)
        reading["maps_write_s"] = time.perf_counter() - t0
        work = os.path.join(tmp, "work")
        argv = ["--data_root", tmp, "--img_dir", "train_80", "--work_dir",
                work, "--batch_size", str(TRAIN_BATCH), "--crop_size",
                str(TRAIN_MAP), "--checkpoint_interval", "2",
                "--log_interval", "1", "--num_workers", "4", "--seed",
                str(args.seed)]
        # 1. full width through the CLI, then resumed to 6
        runs = []
        for iters in TRAIN_ITERS:
            t0 = time.perf_counter()
            state = train_prediction_model.main(
                argv + ["--max_iters", str(iters)])
            torch.cuda.synchronize()
            runs.append({"max_iters": iters, "step": state.step,
                         "wall_s": time.perf_counter() - t0})
        log = read_train_log(os.path.join(work, "train_log.jsonl"))
        reading["cli_runs"] = runs
        reading["log_iters"] = [r["iter"] for r in log]
        reading["log_loss"] = [r["loss"] for r in log]
        reading["checkpoints"] = sorted(os.listdir(work))
        if (state.step != TRAIN_ITERS[1]
                or reading["log_iters"] != list(range(1, 7))
                or not all(np.isfinite(reading["log_loss"]))
                or "iter_6" not in reading["checkpoints"]):
            emit(reading)
            fail("train: the CLI did not resume from iter 4 to step 6")

        # 4. the checkpoint into serving, and the evaluation CLI
        maps_t = upload_batch(
            {"img": np.stack([SemMapDataset(tmp, "train_80")[i]["img"]
                              for i in (3, 17)]),
             "gt": np.zeros((2, TRAIN_MAP, TRAIN_MAP, 6), np.float32)},
            dev)["img"]
        with torch.no_grad():
            want = torch.sigmoid(state.model(maps_t, train=False).float())
        pm = PredictionModel(NavConfig(pred_model_wts=os.path.join(
            work, "iter_6", "model.pth")))
        got = pm.infer(maps_t)
        reading["serve_max_abs_err"] = float((got - want).abs().max())
        reading["serve_bit_equal"] = bool(torch.equal(got, want))
        report = test_cli.main(["--data_root", tmp, "--img_dir",
                                "train_80", "--checkpoint",
                                os.path.join(work, "iter_6"),
                                "--max_samples", "2", "--argmax"])
        reading["test_cli"] = report
        del state, pm, want, got
        if (reading["serve_max_abs_err"] > SERVE_TOL
                or not np.isfinite(report["bce"])):
            emit(reading)
            fail("train: iter_6 does not serve what was trained, or its "
                 "evaluation is not finite")

        # 2 and 5. ten steps on one fixed full-width batch: the loss falls;
        # the time a step (split into forward + backward and Adam) and
        # the peak memory at remat=1, then one step's peak at remat=0
        t0 = time.perf_counter()
        ds = SemMapDataset(tmp, "train_80", pipeline=training_pipeline(
            TRAIN_MAP, rng=np.random.RandomState(args.seed)))
        loader = iter(PrefetchLoader(ds, TRAIN_BATCH, seed=args.seed,
                                     num_workers=1))
        host = next(loader)
        reading["data_s_per_batch_one_worker"] = time.perf_counter() - t0
        loader.close()
        batch = upload_batch(host, dev)
        tcfg = TrainConfig(seed=args.seed)
        # one model for every reading: remat is the backbone's flag
        state = create_train_state(build_segmentor(
            peanut_prediction_config(remat=True), seed=args.seed), tcfg,
            device=dev)
        for remat in (1, 0):
            state.model.backbone.remat = bool(remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, fb_ms, opt_ms = [], [], []
            steps = OVERFIT_STEPS if remat else 1
            try:
                for i in range(steps):
                    e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(3))
                    e0.record()
                    loss = loss_and_grads(state, batch, tcfg)["loss"]
                    e1.record()
                    for group in state.optimizer.param_groups:
                        group["lr"] = tcfg.lr
                    state.optimizer.step()
                    state.step += 1
                    e2.record()
                    torch.cuda.synchronize()
                    losses.append(float(loss))
                    fb_ms.append(e0.elapsed_time(e1))
                    opt_ms.append(e1.elapsed_time(e2))
                peak = torch.cuda.max_memory_allocated()
            except torch.cuda.OutOfMemoryError as e:
                # a reading, not a failure: remat=0 may not fit the card
                reading["remat0"] = {"out_of_memory": str(e)[:200]}
                state.optimizer.zero_grad(set_to_none=True)
                torch.cuda.empty_cache()
                continue
            timed = slice(TIMED_FROM, None) if remat else slice(None)
            step_ms = [a + b for a, b in zip(fb_ms, opt_ms)][timed]
            reading[f"remat{remat}"] = {
                "losses": losses,
                "step_ms_median": float(np.median(step_ms)),
                "fwd_bwd_ms_median": float(np.median(fb_ms[timed])),
                "adam_ms_median": float(np.median(opt_ms[timed])),
                "maps_per_s": TRAIN_BATCH / (np.median(step_ms) / 1e3),
                "timed_steps": len(step_ms),
                "peak_memory_gib": peak / 2 ** 30}
            torch.cuda.empty_cache()
        state.model.backbone.remat = True
        # what PyTorch's defaults give a user of the CLI: TF32 convolutions
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ms = []
            for i in range(TIMED_FROM + 3):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                loss_and_grads(state, batch, tcfg)
                state.optimizer.step()
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
            reading["remat1_tf32"] = {
                "step_ms_median": float(np.median(ms[TIMED_FROM:])),
                "maps_per_s": TRAIN_BATCH / (np.median(ms[TIMED_FROM:])
                                             / 1e3),
                "timed_steps": len(ms) - TIMED_FROM}
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        del state
        torch.cuda.empty_cache()
        r1 = reading["remat1"]
        if not (all(np.isfinite(r1["losses"]))
                and r1["losses"][-1] < r1["losses"][0]):
            emit(reading)
            fail("train: ten steps on one batch did not lower the loss")

    # 3. the card against the CPU
    reading["card_vs_cpu"] = card_against_cpu(dev, args.seed)
    f64 = reading["card_vs_cpu"]["float64"]
    f32 = reading["card_vs_cpu"]["float32"]
    emit(reading)
    if (f64["loss_rel_err"] > PARITY_LOSS_TOL
            or f64["grad_err_of_largest"] > PARITY_GRAD_TOL
            or f32["loss_rel_err"] > PARITY_LOSS_TOL):
        fail("train: the step on the card disagrees with the CPU's")
    return reading



def path_kernels(rng, dev, barrier_us) -> dict:
    """Phase 3's kernel lines at the paths' shapes: B1 (B1_CASES), B2 and
    B4, each against its plain version (bit-equal required), with times,
    bounds and chains.  Returns the results by case."""
    from peanut_tpu_torch.kernels import fmm_sweep
    from peanut_tpu_torch.kernels.fmm import BIG, _axis_relax
    from peanut_tpu_torch.kernels.fmm_sweep import (block_sweep,
                                                    block_sweep2,
                                                    block_sweep2_reference,
                                                    block_sweep_reference)

    def chain(kernel_order, d, block=16, inner=40):
        """The plan's cluster size, the chain's length (row blocks x
        dependent passes; a B4 round of scans and a pass is one link) and
        the floor its cluster barriers set (one a link)."""
        plan = fmm_sweep.launch_plan(kernel_order, d, block)
        links = -(-d.shape[1] // block) * inner
        floor = links * barrier_us.get(plan.cluster, 0.0) / 1e3
        return {"cluster": plan.cluster, "blocks_x_passes": links,
                "chain_floor_ms": floor}

    results = {}
    ok = True

    # B1 (B1_CASES); bit-equal required
    b1 = b1_cases(rng, dev, barrier_us)
    results.update(b1)
    ok &= all(c["ok"] and c["bit_equal"] for c in b1.values())

    # B2: both directions on the planning shape, from the refinement's
    # from-scratch start and from a forward-swept field; the single-env
    # goal-weighting solve's 1 x 960^2
    b, n = 16, 482
    trav_np, src_np = plans(rng, b, n)
    src = torch.as_tensor(src_np, device=dev)
    wall = torch.as_tensor(~trav_np & ~src_np, device=dev)
    d0 = torch.where(src, 0.0, BIG).float()
    d1 = block_sweep2_reference(d0, wall, src, False)
    # the exact profile's goal-weighting refinement: K = 8 grids of 960^2
    trav_np, src_np = plans(rng, 8, 960)
    src8 = torch.as_tensor(src_np, device=dev)
    exact_b2 = (torch.where(src8, 0.0, BIG).float(),
                torch.as_tensor(~trav_np & ~src_np, device=dev), src8)
    single_b2 = {}
    for n in (960, 482, 242):
        trav_np, src_np = plans(rng, 1, n)
        src_n = torch.as_tensor(src_np, device=dev)
        single_b2[n] = (torch.where(src_n, 0.0, BIG).float(),
                        torch.as_tensor(~trav_np & ~src_np, device=dev),
                        src_n)
    for key, reverse, d_in, wall, src, blk, inn in (
            ("B2_down_16x482", False, d0, wall, src, 16, 40),
            ("B2_up_16x482", True, d1, wall, src, 16, 40),
            ("B2_down_1x960", False, *single_b2[960], 16, 40),
            ("B2_down_1x482", False, *single_b2[482], 16, 40),
            ("B2_down_1x242", False, *single_b2[242], 16, 40),
            ("B2_down_16x482_b8", False, d0, wall, src, 8, 24),
            ("B2_down_8x960", False, *exact_b2, 16, 40)):
        kw2 = dict(block=blk, inner=inn)
        got = block_sweep2(d_in, wall, src, reverse, **kw2)
        want = block_sweep2_reference(d_in, wall, src, reverse, **kw2)
        torch.cuda.synchronize()
        cmp = compare(got, want, TOL)
        ms = cuda_ms(lambda: block_sweep2(d_in, wall, src, reverse, **kw2),
                     reps=10)
        plain_ms = cuda_ms(lambda: block_sweep2_reference(
            d_in, wall, src, reverse, **kw2), reps=1)
        cells = d_in.numel()
        bound_ms, bound_by = bound(cells, 4 + 1 + 1 + 4,
                                   cells * inn * GODUNOV2_OPS)
        link = chain(2, d_in, blk, inn)
        results[key] = dict(cmp, bit_equal=bool(torch.equal(got, want)),
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, **link,
                            us_per_pass=ms / link["blocks_x_passes"] * 1e3)
        ok &= cmp["ok"] and results[key]["bit_equal"]
        emit({"phase": "kernel", "kernel": f"block_sweep2/{key}",
              **results[key]})

    # B4: the first-order sweeps of the single-env agent's composed solves
    # (the 482^2 planning solve in both directions, the 960^2 goal-weighting
    # solve) and a batch of 16 planning grids (the composed schedule on the
    # batched tick's shape), from the field the composed schedule hands
    # them (row scans and a Jacobi pass applied); bit-equal required
    for key, b, n, reverse in (("B4_down_1x482", 1, 482, False),
                               ("B4_up_1x482", 1, 482, True),
                               ("B4_down_1x960", 1, 960, False),
                               ("B4_composed_16x482", 16, 482, False),
                               ("B4_down_1x242", 1, 242, False)):
        trav_np, src_np = plans(rng, b, n)
        src = torch.as_tensor(src_np, device=dev)
        wall = torch.as_tensor(~trav_np & ~src_np, device=dev)
        d_in = _axis_relax(torch.where(src, 0.0, BIG).float(), wall)
        if reverse:
            d_in = block_sweep_reference(d_in, wall, False)
        got = block_sweep(d_in, wall, reverse)
        want = block_sweep_reference(d_in, wall, reverse)
        torch.cuda.synchronize()
        cmp = dict(compare(got, want, TOL),
                   bit_equal=bool(torch.equal(got, want)))
        ms = cuda_ms(lambda: block_sweep(d_in, wall, reverse), reps=10)
        plain_ms = cuda_ms(
            lambda: block_sweep_reference(d_in, wall, reverse), reps=1)
        cells = b * n * n
        # inner stencil passes and 2 x inner/scan_chunk row scans (chunk 1)
        bound_ms, bound_by = bound(cells, 4 + 1 + 4, cells * 40 * (
            GODUNOV1_OPS + 2 * SCAN_OPS))
        link = chain(1, d_in)
        results[key] = dict(cmp, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, **link,
                            us_per_pass=ms / link["blocks_x_passes"] * 1e3)
        ok &= cmp["ok"] and cmp["bit_equal"]
        emit({"phase": "kernel", "kernel": f"block_sweep/{key}",
              **results[key]})
    if not ok:
        fail("a kernel disagrees with its plain version")
    return results


# ---- 12. the model zoo's serving path ----------------------------------
ZOO_FAMILIES = ("ann", "apcnet", "ccnet", "danet", "deeplabv3",
                "deeplabv3plus", "dmnet", "dnlnet", "emanet", "encnet",
                "fastfcn", "fcn", "gcnet", "isanet", "nonlocal_net", "ocrnet",
                "psanet", "pspnet", "sem_fpn", "upernet",
                # the transformer families, then the cascade ones
                "beit", "convnext", "dpt", "mae", "segformer", "segmenter",
                "setr", "swin", "twins", "vit", "knet", "point_rend",
                # the light-CNN families
                "bisenetv1", "bisenetv2", "cgnet", "erfnet", "fastscnn",
                "hrnet", "icnet", "mobilenet_v2", "mobilenet_v3", "resnest",
                "stdc", "unet")
ZOO_SERVE = "configs/upernet/upernet_r50_512x1024_80k_cityscapes.py"
ZOO_IMAGE = (1024, 2048)      # cityscapes' test_pipeline img_scale
ZOO_SERVE_HRNET = "configs/hrnet/fcn_hr18_512x1024_80k_cityscapes.py"
ZOO_SERVE_SWIN = "configs/swin/upernet_swin-t_512x512_160k_ade20k.py"
# ADE20K's test scale (2048, 512), keep-ratio, on a 4:3 image
ZOO_IMAGE_SWIN = (512, 683)
ZOO_REQUESTS = 5
ZOO_TIMED = (512, 1024)       # the families' training crop
ZOO_CHECK = (128, 256)        # card against CPU in float64
# UPerNet's slide windows at ZOO_IMAGE, and at ZOO_CHECK
ZOO_SLIDE = dict(mode="slide", crop_size=(512, 1024), stride=(341, 683))
ZOO_SLIDE_CHECK = dict(mode="slide", crop_size=(64, 128), stride=(43, 85))


def zoo_config_path(family: str) -> str:
    """The family's 80k Cityscapes config (PSPNet's only one: PEANUT's)."""
    import glob
    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "configs", family, "*.py")))
    city = [p for p in paths if p.endswith("_512x1024_80k_cityscapes.py")]
    return os.path.relpath((city or paths)[0], root)


@torch.no_grad()
def zoo_weights(model, seed: int):
    """Random batch statistics, non-zero attention gates (at flax's
    initial 0 a gate hides its attention branch), layer scales of order 1
    (ConvNeXt's start at 1e-6, BEiT's at 0.1) and PReLU slopes (CGNet's,
    all 0.01 at init, so a dropped PReLU would hardly show) on a seeded
    model."""
    import re

    from peanut_tpu_torch.models.layers import BatchNorm, PReLU
    g = torch.Generator().manual_seed(seed + 7)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                 generator=g))
    for name, p in model.named_parameters():
        if re.search(r"gamma[12]?$", name):
            p.fill_(0.5 + float(torch.rand((), generator=g)))
    for m in model.modules():
        if isinstance(m, PReLU):
            m.negative_slope.fill_(0.1 + 0.4 * float(torch.rand(
                (), generator=g)))
    return model


def zoo_card_vs_cpu(cfg, dev, seed: int, hw) -> dict:
    """The model of ``cfg`` (seeded, zoo_weights) in float64 on the CPU and
    on the card on one seeded input: the error over the largest |logit|."""
    import copy

    from peanut_tpu_torch.models.builder import build_segmentor
    in_ch = cfg["backbone"].get("in_channels", 3)
    x = torch.as_tensor(np.random.RandomState(seed).rand(1, in_ch, *hw))
    model = zoo_weights(build_segmentor(cfg, seed=seed), seed).double()
    with torch.no_grad():
        want = model(x)
        card = copy.deepcopy(model).to(dev)
        got = card(x.to(dev)).cpu()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    top = float(want.abs().max())
    return {"err_of_largest": float((got - want).abs().max()) / top,
            "largest_abs_logit": top, "finite": finite,
            "shape": list(got.shape)}


def zoo_classes(cfg) -> int:
    head = cfg["decode_head"]
    return (head[-1] if isinstance(head, list) else head)["num_classes"]


def zoo_serve(args, dev, config: str, image_hw, phase: str) -> dict:
    """cli/serve.py's handler in a thread on the card serving ``config``
    (random weights from --seed): ZOO_REQUESTS POST /probs of a seeded
    image against inference_segmentor called directly.  Fails unless
    every reply is 200, finite, of the config's classes at the image's
    size and equal to the direct call."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from peanut_tpu_torch import apis
    from peanut_tpu_torch.cli import serve

    bundle = apis.init_segmentor(config, seed=args.seed, device=dev)
    img = np.random.RandomState(args.seed).rand(*image_hw, 3).astype(
        np.float32) * 255.0
    buf = io.BytesIO()
    np.save(buf, img)
    body = buf.getvalue()
    torch.cuda.reset_peak_memory_stats()
    direct = apis.inference_segmentor(bundle, img)
    t0 = time.perf_counter()
    direct = apis.inference_segmentor(bundle, img)
    direct_ms = (time.perf_counter() - t0) * 1e3
    # the forward alone on the card (what the request's other time is not)
    x = torch.as_tensor(img[None], device=dev)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: bundle.model.inference(x), 2)
    del x
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(bundle))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/probs"
    req_ms, codes, equal = [], [], []
    try:
        for _ in range(ZOO_REQUESTS):
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                codes.append(r.status)
                probs = np.load(io.BytesIO(r.read()))
            req_ms.append((time.perf_counter() - t0) * 1e3)
            equal.append(probs.shape == direct.shape
                         and bool(np.array_equal(probs, direct)))
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    peak = torch.cuda.max_memory_allocated()
    line = {
        "phase": phase, "config": config, "image": list(image_hw),
        "requests": ZOO_REQUESTS, "codes": codes,
        "reply_shape": list(direct.shape), "equal_to_direct": equal,
        "ms_per_request": req_ms,
        "ms_per_request_median": float(np.median(req_ms)),
        "direct_inference_ms": direct_ms, "forward_ms_card": forward_ms,
        "peak_mib": peak / 2 ** 20, "peak_gib": peak / 2 ** 30,
        "probs_finite": bool(np.isfinite(direct).all())}
    emit(line)
    classes = zoo_classes(bundle.cfg["model"])
    del bundle
    torch.cuda.empty_cache()
    if (codes != [200] * ZOO_REQUESTS or not all(equal)
            or line["reply_shape"] != [classes, *image_hw]
            or not line["probs_finite"]):
        fail(f"cli/serve.py did not answer as inference_segmentor: {line}")
    return line


def zoo_forward_ms(model, x, reps: int = 3) -> float:
    with torch.no_grad():
        return cuda_ms(lambda: model(x), reps)


def zoo_phase(args, dev, smi_line: str) -> dict:
    """Phase 12: every family the port builds at its config's widths
    (card against CPU in float64 at 128x256; one 512x1024 forward timed
    in float32, TF32 off, and in bfloat16), cli/serve.py answering 5
    /probs requests for UPerNet-R50 and FCN-HRNet-W18 at 1024x2048 and for
    UPerNet-Swin-T at 512x683, UPerNet's slide inference, and
    cli/benchmark.py at its defaults in both types."""
    import copy
    import io

    from peanut_tpu_torch.cli import benchmark
    from peanut_tpu_torch.core.config_file import load_config
    from peanut_tpu_torch.models.builder import build_segmentor

    t_phase = time.perf_counter()
    readings = {}
    for fam in ZOO_FAMILIES:
        path = zoo_config_path(fam)
        cfg = load_config(path)["model"]
        chk = zoo_card_vs_cpu(cfg, dev, args.seed, ZOO_CHECK)
        in_ch = cfg["backbone"].get("in_channels", 3)
        model = zoo_weights(build_segmentor(cfg, seed=args.seed),
                            args.seed).to(dev)
        x = torch.as_tensor(np.random.RandomState(args.seed).rand(
            1, in_ch, *ZOO_TIMED), dtype=torch.float32, device=dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = model(x)
        ms32 = zoo_forward_ms(model, x)
        peak32 = torch.cuda.max_memory_allocated() / 2 ** 20
        model.to(torch.bfloat16)
        ms16 = zoo_forward_ms(model, x.to(torch.bfloat16))
        line = {"phase": "zoo_family", "family": fam, "config": path,
                "card_vs_cpu_float64": dict(chk, input=list(ZOO_CHECK)),
                "timed_input": list(ZOO_TIMED),
                "out_shape": list(out.shape),
                "out_finite": bool(torch.isfinite(out).all()),
                "ms_float32": ms32, "ms_bf16": ms16,
                "peak_mib_float32": peak32}
        emit(line)
        readings[fam] = line
        del model, x, out
        torch.cuda.empty_cache()
        if (chk["err_of_largest"] > 1e-8 or not chk["finite"]
                or not line["out_finite"]
                or line["out_shape"][1:] != [
                    zoo_classes(cfg), *ZOO_TIMED]):
            fail(f"zoo family {fam}: the card disagrees with the CPU or "
                 f"its output is wrong: {line}")

    # serving: cli/serve.py's handler in a thread on the card, UPerNet-R50
    # and FCN-HRNet-W18 (Cityscapes) at 1024x2048, then UPerNet-Swin-T
    # (ADE20K) at 512x683
    zoo_serve(args, dev, ZOO_SERVE, ZOO_IMAGE, "zoo_serve")
    zoo_serve(args, dev, ZOO_SERVE_HRNET, ZOO_IMAGE, "zoo_serve_hrnet")
    zoo_serve(args, dev, ZOO_SERVE_SWIN, ZOO_IMAGE_SWIN, "zoo_serve_swin")

    # slide inference: UPerNet at 1024x2048 on the card, and the card
    # against the CPU in float64 at 128x256
    cfg = load_config(ZOO_SERVE)["model"]
    cfg["test_cfg"] = dict(ZOO_SLIDE)
    model = zoo_weights(build_segmentor(cfg, seed=args.seed),
                        args.seed).to(dev)
    x = torch.as_tensor(np.random.RandomState(args.seed).rand(
        1, *ZOO_IMAGE, 3), dtype=torch.float32, device=dev)
    with torch.no_grad():
        out = model.inference(x)
        slide_ms = cuda_ms(lambda: model.inference(x), 2)
    small = dict(cfg, test_cfg=dict(ZOO_SLIDE_CHECK))
    x64 = torch.as_tensor(np.random.RandomState(args.seed + 1).rand(
        1, *ZOO_CHECK, 3))
    m64 = zoo_weights(build_segmentor(small, seed=args.seed),
                      args.seed).double()
    with torch.no_grad():
        want = m64.inference(x64)
        got = copy.deepcopy(m64).to(dev).inference(x64.to(dev)).cpu()
    slide_err = float((got - want).abs().max() / want.abs().max())
    slide_line = {"phase": "zoo_slide", "config": ZOO_SERVE,
                  "test_cfg": cfg["test_cfg"], "image": list(ZOO_IMAGE),
                  "ms_float32": slide_ms, "out_shape": list(out.shape),
                  "out_finite": bool(torch.isfinite(out).all()),
                  "card_vs_cpu_float64": {
                      "input": list(ZOO_CHECK), "test_cfg": ZOO_SLIDE_CHECK,
                      "err_of_largest": slide_err}}
    emit(slide_line)
    del model, x, out
    torch.cuda.empty_cache()
    if slide_err > 1e-8 or not slide_line["out_finite"]:
        fail(f"slide inference: {slide_line}")

    # cli/benchmark.py at its defaults (--size 720 --batch 4)
    bench = {}
    for dtype in ("bfloat16", "float32"):
        with contextlib.redirect_stdout(io.StringIO()):   # its own line
            bench[dtype] = benchmark.main([ZOO_SERVE, "--dtype", dtype])
    emit({"phase": "zoo_benchmark", "config": ZOO_SERVE,
          "tf32": torch.backends.cudnn.allow_tf32, **bench,
          "nvidia_smi": smi_line})
    if not all(b["maps_per_sec"] > 0 for b in bench.values()):
        fail(f"cli/benchmark.py: {bench}")
    readings["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "zoo_done", "seconds": readings["seconds"]})
    return readings


ZOO_TRAIN = "configs/convnext/upernet_convnext_512x512_160k_ade20k.py"
ZOO_TRAIN_MAP = 640       # the synthetic maps' side: enough for the crop
ZOO_TRAIN_CROP = 512      # the config's own training crop
ZOO_TRAIN_ITERS = (6, 9)  # the first run, then the resumed one
ZOO_TRAIN_CHECK = (64, 64)    # card against CPU, batch 2
# the card-against-CPU configs: each family's config with 14 channels, 6
# classes, dropout 0 and narrow heads over its published backbone
ZOO_TRAIN_PARITY = {
    "upernet_convnext": ("configs/convnext/upernet_convnext_512x512_160k_"
                         "ade20k.py", dict(channels=64), dict(channels=32)),
    "upernet_vit": ("configs/vit/upernet_vit-b16_512x512_80k_ade20k.py",
                    dict(channels=64), dict(channels=32)),
    "pspnet_m-v2-d8": ("configs/mobilenet_v2/pspnet_m-v2-d8_512x1024_80k_"
                       "cityscapes.py", dict(channels=64),
                       dict(channels=32)),
    "fast_scnn": ("configs/fastscnn/fast_scnn_512x1024_80k_cityscapes.py",
                  dict(channels=32), dict(channels=16)),
}


def zoo_train_config(path: str, decode=None, aux=None,
                     dropout=None) -> dict:
    """A zoo config's model for PEANUT's training: 14 input channels and
    6 classes in both heads (the overrides beside; ``dropout`` the heads'
    ratio where given)."""
    from peanut_tpu_torch.core.config_file import load_config
    cfg = load_config(path)["model"]
    cfg["backbone"]["in_channels"] = 14
    for key, over in (("decode_head", decode), ("auxiliary_head", aux)):
        cfg[key].update(over or {}, num_classes=6)
        if dropout is not None:
            cfg[key]["dropout_ratio"] = dropout
    return cfg


def zoo_train_card_vs_cpu(dev, seed: int) -> dict:
    """One train step (loss and gradients, dropout 0) of each
    ZOO_TRAIN_PARITY config from the same seeded weights (zoo_weights) on
    the card and on the CPU, batch 2 at ZOO_TRAIN_CHECK: float64 (the
    gate: loss 1e-5 relative, gradients 1e-4 of the largest) and float32
    with TF32 off (reported).  Then PointRend's training forward with its
    point logits in float64, and one layer-decay AdamW step of UPerNet-ViT
    fed the CPU's float64 gradients on both."""
    import copy

    from peanut_tpu_torch.core.config_file import load_config
    from peanut_tpu_torch.models.builder import build_segmentor
    from peanut_tpu_torch.prediction.optimizers import (
        make_layer_decay_optimizer)
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   loss_and_grads)
    rng = np.random.RandomState(seed)
    img = rng.rand(2, 14, *ZOO_TRAIN_CHECK)
    gt = (rng.rand(2, 6, *ZOO_TRAIN_CHECK) > 0.9) * 255.0
    tcfg = TrainConfig(lr=1e-3, max_iters=50, seed=seed)
    out, vit_grads = {}, None
    for fam, (path, dec, aux) in ZOO_TRAIN_PARITY.items():
        cfg = zoo_train_config(path, dec, aux, dropout=0.0)
        base = zoo_weights(build_segmentor(cfg, seed=seed), seed)
        out[fam] = {}
        for dtype in (torch.float64, torch.float32):
            res = {}
            for where in ("cpu", dev):
                state = create_train_state(copy.deepcopy(base).to(dtype),
                                           tcfg, device=where)
                batch = {"img": torch.as_tensor(img, dtype=dtype,
                                                device=where),
                         "gt": torch.as_tensor(gt, dtype=dtype,
                                               device=where)}
                loss = loss_and_grads(state, batch, tcfg)["loss"]
                res[str(where)] = (float(loss), {
                    n: p.grad.detach().double().cpu()
                    for n, p in state.model.named_parameters()})
            (lc, gc), (lg, gg) = res["cpu"], res[str(dev)]
            top = max(float(g.abs().max()) for g in gc.values())
            err = max(float((gg[n] - gc[n]).abs().max()) for n in gc)
            out[fam][str(dtype).replace("torch.", "")] = {
                "loss_cpu": lc, "loss_card": lg,
                "loss_rel_err": abs(lg - lc) / abs(lc),
                "grad_err_of_largest": err / top,
                "finite": bool(np.isfinite(lg))}
            if fam == "upernet_vit" and dtype == torch.float64:
                vit_base, vit_grads = base, gc
    # PointRend's training pass: the stage logits and the point logits
    cfg = load_config(zoo_config_path("point_rend"))["model"]
    x = torch.as_tensor(np.random.RandomState(seed).rand(1, 3, 128, 256))
    model = zoo_weights(build_segmentor(cfg, seed=seed), seed).double()
    card = copy.deepcopy(model).to(dev)
    with torch.no_grad():
        want, wx = model(x, train=True, with_points=True)
        got, gx = card(x.to(dev), train=True, with_points=True)
    top = float(want.abs().max())
    out["point_rend"] = {
        "err_of_largest": float((got.cpu() - want).abs().max()) / top,
        "point_logits_err_of_largest": float(
            (gx["point_logits"].cpu() - wx["point_logits"]).abs().max())
        / float(wx["point_logits"].abs().max()),
        "points_equal": bool(torch.equal(gx["points"].cpu(),
                                         wx["points"])),
        "points": list(wx["points"].shape)}
    # the layer-decay AdamW: one step of each from the same gradients
    stepped = {}
    for where in ("cpu", dev):
        m = copy.deepcopy(vit_base).double().to(where).requires_grad_(True)
        opt = make_layer_decay_optimizer(m, 1e-3, decay_rate=0.65,
                                         num_layers=12)
        before = {n: p.detach().clone() for n, p in m.named_parameters()}
        for n, p in m.named_parameters():
            p.grad = vit_grads[n].to(where)
        opt.step()
        stepped[str(where)] = {n: (p.detach() - before[n]).cpu()
                               for n, p in m.named_parameters()}
    a, b = stepped["cpu"], stepped[str(dev)]
    top = max(float(u.abs().max()) for u in a.values())
    out["layer_decay_adamw"] = {
        "update_err_of_largest": max(float((b[n] - a[n]).abs().max())
                                     for n in a) / top,
        "groups": len(opt.param_groups)}
    return out


def zoo_train_phase(args, dev, smi_line: str) -> dict:
    """Phase 13: the zoo's training half at published width
    (module docstring); returns its reading."""
    import copy
    import tempfile

    from peanut_tpu_torch import apis
    from peanut_tpu_torch.cli import train_prediction_model
    from peanut_tpu_torch.core.config_file import dump_config
    from peanut_tpu_torch.prediction.dataset import (PrefetchLoader,
                                                     SemMapDataset,
                                                     training_pipeline)
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   loss_and_grads,
                                                   upload_batch)
    from peanut_tpu_torch.utils.loggers import read_train_log

    t_phase = time.perf_counter()
    reading = {"phase": "zoo_train", "nvidia_smi": smi_line,
               "config": ZOO_TRAIN, "model": "UPerNet-ConvNeXt-T",
               "batch": TRAIN_BATCH, "crop": ZOO_TRAIN_CROP, "channels": 14,
               "classes": 6}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_file = os.path.join(tmp, "upernet_convnext_peanut.py")
        dump_config({"model": zoo_train_config(ZOO_TRAIN)}, cfg_file)
        write_train_maps(os.path.join(tmp, "train_80"), args.seed,
                         size=ZOO_TRAIN_MAP)
        work = os.path.join(tmp, "work")
        argv = ["--config", cfg_file, "--data_root", tmp, "--img_dir",
                "train_80", "--work_dir", work, "--batch_size",
                str(TRAIN_BATCH), "--crop_size", str(ZOO_TRAIN_CROP),
                "--checkpoint_interval", "3", "--num_workers", "1",
                "--log_interval", "1", "--seed", str(args.seed)]
        # the CLI at full width, then resumed to 9
        runs = []
        for iters in ZOO_TRAIN_ITERS:
            t0 = time.perf_counter()
            state = train_prediction_model.main(
                argv + ["--max_iters", str(iters)], device=dev)
            torch.cuda.synchronize()
            runs.append({"max_iters": iters, "step": state.step,
                         "wall_s": time.perf_counter() - t0})
        log = read_train_log(os.path.join(work, "train_log.jsonl"))
        reading["cli_runs"] = runs
        reading["log_iters"] = [r["iter"] for r in log]
        reading["log_loss"] = [r["loss"] for r in log]
        reading["checkpoints"] = sorted(os.listdir(work))
        losses = reading["log_loss"]
        if (state.step != ZOO_TRAIN_ITERS[1]
                or reading["log_iters"] != list(range(1, 10))
                or not all(np.isfinite(losses))
                or "iter_9" not in reading["checkpoints"]):
            emit(reading)
            fail("zoo_train: the CLI did not resume from iter 6 to 9")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            emit(reading)
            fail("zoo_train: the logged loss did not fall")

        # the checkpoint served through apis against the trained model
        ds = SemMapDataset(tmp, "train_80")
        img = ds[7]["img"][:ZOO_TRAIN_CROP, :ZOO_TRAIN_CROP]
        bundle = apis.init_segmentor(cfg_file, os.path.join(work, "iter_9"),
                                     device=dev)
        got = apis.inference_segmentor(bundle, img, logits=True)
        with torch.no_grad():
            want = state.model(torch.as_tensor(
                img.transpose(2, 0, 1)[None].copy(), device=dev),
                train=False)[0].cpu().numpy()
        reading["serve_err_of_largest"] = float(
            np.abs(got - want).max() / np.abs(want).max())
        reading["serve_bit_equal"] = bool(np.array_equal(got, want))
        del bundle
        if (got.shape != (6, ZOO_TRAIN_CROP, ZOO_TRAIN_CROP)
                or reading["serve_err_of_largest"] > SERVE_TOL):
            emit(reading)
            fail("zoo_train: iter_9 through apis does not serve what was "
                 "trained")

        # timed: one batch through the loader (host, one worker), then
        # steps on it split into forward + backward and Adam
        t0 = time.perf_counter()
        loader = iter(PrefetchLoader(SemMapDataset(
            tmp, "train_80", pipeline=training_pipeline(
                ZOO_TRAIN_CROP, rng=np.random.RandomState(args.seed))),
            TRAIN_BATCH, seed=args.seed, num_workers=1))
        host = next(loader)
        data_s = [time.perf_counter() - t0]
        for _ in range(2):
            t0 = time.perf_counter()
            host = next(loader)
            data_s.append(time.perf_counter() - t0)
        loader.close()
        reading["data_ms_per_batch_one_worker"] = [s * 1e3 for s in data_s]
        batch = upload_batch(host, dev)
        tcfg = TrainConfig(seed=args.seed)
        model = copy.deepcopy(state.model)
        del state
        torch.cuda.empty_cache()
        for tf32 in (False, True):
            saved = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                st = create_train_state(copy.deepcopy(model), tcfg,
                                        device=dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                losses_t, fb_ms, opt_ms = [], [], []
                for i in range(TIMED_FROM + OVERFIT_STEPS):
                    e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(3))
                    e0.record()
                    loss = loss_and_grads(st, batch, tcfg)["loss"]
                    e1.record()
                    st.optimizer.step()
                    st.step += 1
                    e2.record()
                    torch.cuda.synchronize()
                    losses_t.append(float(loss))
                    fb_ms.append(e0.elapsed_time(e1))
                    opt_ms.append(e1.elapsed_time(e2))
                peak = torch.cuda.max_memory_allocated()
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = saved
            step_ms = [a + b for a, b in
                       zip(fb_ms, opt_ms)][TIMED_FROM:]
            reading["tf32" if tf32 else "float32"] = {
                "losses": losses_t,
                "step_ms_median": float(np.median(step_ms)),
                "fwd_bwd_ms_median": float(np.median(fb_ms[TIMED_FROM:])),
                "adam_ms_median": float(np.median(opt_ms[TIMED_FROM:])),
                "maps_per_s": TRAIN_BATCH / (np.median(step_ms) / 1e3),
                "timed_steps": len(step_ms),
                "peak_memory_gib": peak / 2 ** 30}
            del st
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
    f32 = reading["float32"]
    if not all(np.isfinite(f32["losses"])):
        emit(reading)
        fail("zoo_train: the timed steps' losses are not finite")

    # the card against the CPU
    reading["card_vs_cpu"] = zoo_train_card_vs_cpu(dev, args.seed)
    reading["seconds"] = time.perf_counter() - t_phase
    emit(reading)
    bad = [f for f, r in reading["card_vs_cpu"].items()
           if f in ZOO_TRAIN_PARITY and (
               r["float64"]["loss_rel_err"] > PARITY_LOSS_TOL
               or r["float64"]["grad_err_of_largest"] > PARITY_GRAD_TOL
               or not r["float32"]["finite"])]
    pr = reading["card_vs_cpu"]["point_rend"]
    ld = reading["card_vs_cpu"]["layer_decay_adamw"]
    if (bad or pr["err_of_largest"] > 1e-8
            or pr["point_logits_err_of_largest"] > 1e-8
            or not pr["points_equal"]
            or ld["update_err_of_largest"] > 1e-8):
        fail(f"zoo_train: the card disagrees with the CPU: {bad} "
             f"{pr} {ld}")
    return reading


ZOO_TOOLS_SWIN = "configs/swin/upernet_swin-t_512x512_160k_ade20k.py"
ZOO_TOOLS_PSPNET = "configs/pspnet/peanut_prediction.py"
# the pieces of a Swin-T that an official checkpoint has no array for: its
# patch merging carries no bias (the port's, as flax's Dense, has one)
SWIN_KEEP = (r"merge\d+\.bias",)
EXPORT_TOL = 1e-5          # cli/export.py's bar, the JAX package's
CONVERT_TOL = 1e-9         # card against CPU, float64, of the largest
TIE_TOL = 1e-4             # a pixel whose two largest logits are this near


def _init(rng, *shape):
    fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    return rng.randn(*shape) / np.sqrt(fan)


def mmcls_convnext_t(seed: int) -> dict:
    """An mmcls ConvNeXt-T state dict (the reference configs' pretrained
    format: dims 96-768, depths 3/3/9/3, ~28 M parameters, its classifier
    head too) of seeded values: kernels scaled by 1 / sqrt(fan-in), norm
    scales near 1, layer scales of order 1."""
    rng = np.random.RandomState(seed)
    sd, in_c = {}, 3
    for i, (nd, d) in enumerate(zip((3, 3, 9, 3), (96, 192, 384, 768))):
        t = f"backbone.downsample_layers.{i}"
        conv, norm = (0, 1) if i == 0 else (1, 0)
        k = 4 if i == 0 else 2
        sd[f"{t}.{conv}.weight"] = _init(rng, d, in_c, k, k)
        sd[f"{t}.{conv}.bias"] = 0.1 * rng.randn(d)
        nc = d if i == 0 else in_c
        sd[f"{t}.{norm}.weight"] = 1 + 0.1 * rng.randn(nc)
        sd[f"{t}.{norm}.bias"] = 0.1 * rng.randn(nc)
        for j in range(nd):
            b = f"backbone.stages.{i}.{j}"
            sd[f"{b}.depthwise_conv.weight"] = _init(rng, d, 1, 7, 7)
            sd[f"{b}.depthwise_conv.bias"] = 0.1 * rng.randn(d)
            sd[f"{b}.norm.weight"] = 1 + 0.1 * rng.randn(d)
            sd[f"{b}.norm.bias"] = 0.1 * rng.randn(d)
            sd[f"{b}.pointwise_conv1.weight"] = _init(rng, 4 * d, d)
            sd[f"{b}.pointwise_conv1.bias"] = 0.1 * rng.randn(4 * d)
            sd[f"{b}.pointwise_conv2.weight"] = _init(rng, d, 4 * d)
            sd[f"{b}.pointwise_conv2.bias"] = 0.1 * rng.randn(d)
            sd[f"{b}.gamma"] = 0.5 + rng.rand(d)
        sd[f"backbone.norm{i}.weight"] = 1 + 0.1 * rng.randn(d)
        sd[f"backbone.norm{i}.bias"] = 0.1 * rng.randn(d)
        in_c = d
    sd["head.fc.weight"] = _init(rng, 1000, 768)
    sd["head.fc.bias"] = np.zeros(1000)
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}


def official_swin_t(seed: int) -> dict:
    """A Microsoft Swin-T state dict (embed 96, depths 2/2/6/2, heads
    3/6/12/24, window 7, ~28 M parameters) of seeded values, with the
    per-stage output norms ``norm{s}`` of mmseg's Swin (the segmentation
    configs' out_indices 0-3), the relative-position index and
    shifted-window mask buffers, and its classifier head."""
    rng = np.random.RandomState(seed)
    sd = {"patch_embed.proj.weight": _init(rng, 96, 3, 4, 4),
          "patch_embed.proj.bias": 0.1 * rng.randn(96),
          "patch_embed.norm.weight": 1 + 0.1 * rng.randn(96),
          "patch_embed.norm.bias": 0.1 * rng.randn(96)}
    for s, (depth, heads) in enumerate(zip((2, 2, 6, 2), (3, 6, 12, 24))):
        c = 96 * 2 ** s
        for b in range(depth):
            t = f"layers.{s}.blocks.{b}"
            for n in ("norm1", "norm2"):
                sd[f"{t}.{n}.weight"] = 1 + 0.1 * rng.randn(c)
                sd[f"{t}.{n}.bias"] = 0.1 * rng.randn(c)
            for n, (o, i) in (("attn.qkv", (3 * c, c)), ("attn.proj", (c, c)),
                              ("mlp.fc1", (4 * c, c)),
                              ("mlp.fc2", (c, 4 * c))):
                sd[f"{t}.{n}.weight"] = _init(rng, o, i)
                sd[f"{t}.{n}.bias"] = 0.1 * rng.randn(o)
            sd[f"{t}.attn.relative_position_bias_table"] = \
                0.5 * rng.randn(13 * 13, heads)
            sd[f"{t}.attn.relative_position_index"] = np.zeros((49, 49),
                                                               np.int64)
            if b % 2:
                sd[f"{t}.attn_mask"] = np.zeros((64, 49, 49))
        if s < 3:
            d = f"layers.{s}.downsample"
            sd[f"{d}.reduction.weight"] = _init(rng, 2 * c, 4 * c)
            sd[f"{d}.norm.weight"] = 1 + 0.1 * rng.randn(4 * c)
            sd[f"{d}.norm.bias"] = 0.1 * rng.randn(4 * c)
        sd[f"norm{s}.weight"] = 1 + 0.1 * rng.randn(c)
        sd[f"norm{s}.bias"] = 0.1 * rng.randn(c)
    sd["head.weight"] = _init(rng, 1000, 768)
    sd["head.bias"] = np.zeros(1000)
    return {k: torch.as_tensor(v) if v.dtype == np.int64
            else torch.as_tensor(v, dtype=torch.float32)
            for k, v in sd.items()}


def convert_into(kind: str, sd: dict, config: str, tmp: str, seed: int,
                 dev, keep=()) -> tuple:
    """``sd`` saved as an mmcls-style ``.pth``, converted by ``cli.convert
    model KIND`` and laid into the backbone of ``config``'s model (seeded):
    (the model, its reading).  The backbone's features on the card
    against the CPU's in float64 on a seeded 224x224 input."""
    import copy
    import io

    from peanut_tpu_torch.cli import convert
    from peanut_tpu_torch.core.config_file import load_config
    from peanut_tpu_torch.models.builder import build_segmentor
    from peanut_tpu_torch.models.mmseg_import import load_mmseg_state
    from peanut_tpu_torch.models.zoo_import import converted_backbone_state

    src, out = (os.path.join(tmp, f"{kind}.pth"),
                os.path.join(tmp, f"{kind}_converted.pt"))
    torch.save({"state_dict": sd, "meta": {"seed": seed}}, src)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        convert.main(["model", kind, src, out])
    convert_s = time.perf_counter() - t0
    _, leftovers = convert.convert_model(kind, src)
    tree = convert.load_converted(out)
    model = build_segmentor(load_config(config)["model"], seed=seed)
    load_mmseg_state(model.backbone,
                     converted_backbone_state(tree, model.backbone, keep))
    x = torch.as_tensor(np.random.RandomState(seed).rand(1, 3, 224, 224))
    cpu = copy.deepcopy(model.backbone).double()
    with torch.no_grad():
        want = cpu(x)
        got = [g.cpu() for g in cpu.to(dev)(x.to(dev))]
    top = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    lines = printed.getvalue().splitlines()
    return model, {
        "config": config, "source_keys": len(sd),
        "arrays": int(lines[0].split(": ")[1].split()[0]),
        "printed": lines[0], "leftovers": leftovers, "kept": list(keep),
        "convert_s": convert_s,
        "backbone_card_vs_cpu_float64": {
            "err_of_largest": err / top, "largest_abs": top,
            "features": [list(g.shape) for g in got],
            "finite": all(bool(torch.isfinite(g).all()) for g in got)}}


def median_ms(fn, reps: int = 10) -> float:
    """The median of ``reps`` CUDA-event timings of ``fn()``, each after
    the one before has finished, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def export_reading(config: str, shape, tmp: str, dev,
                   checkpoint=None) -> dict:
    """``cli.export`` of ``config`` at ``shape`` on the card: seconds, the
    artifact's MB, the reloaded program against the eager model on
    ``RandomState(0).rand(*shape)`` (largest deviation; within the
    export's rtol = atol = 1e-5), and both forwards' median ms."""
    from peanut_tpu_torch import apis
    from peanut_tpu_torch.cli import export

    out = os.path.join(tmp, os.path.basename(config)[:-3] + ".pt2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export.export_segmentor(config, out, shape, checkpoint=checkpoint,
                            device=dev)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = torch.export.load(out).module()
    load_s = time.perf_counter() - t0
    model = apis.init_segmentor(config, checkpoint=checkpoint,
                                input_size=shape[1], device=dev).model
    x = torch.as_tensor(np.random.RandomState(0).rand(*shape)
                        .astype(np.float32), device=dev)
    with torch.no_grad():
        got, want = program(x), model.inference(x)
        eager_ms = median_ms(lambda: model.inference(x))
        exported_ms = median_ms(lambda: program(x))
    dev_ = (got - want).abs()
    return {"config": config, "shape": list(shape), "dtype": "float32",
            "tf32": False, "export_s": export_s, "load_s": load_s,
            "artifact_mb": os.path.getsize(out) / 2 ** 20,
            "max_abs_dev": float(dev_.max()),
            "largest_abs_logit": float(want.abs().max()),
            "within_1e-5": bool(torch.allclose(got, want, rtol=EXPORT_TOL,
                                               atol=EXPORT_TOL)),
            "bit_equal": bool(torch.equal(got, want)),
            "out_shape": list(got.shape),
            "finite": bool(torch.isfinite(got).all()),
            "eager_ms": eager_ms, "exported_ms": exported_ms}


def write_image_dataset(root: str, seed: int, n: int = 8, hw=(512, 512),
                        classes: int = 150) -> None:
    """``n`` seeded images (jpg) and label maps (png) of ``hw`` in
    CustomDataset's layout (img_dir/, ann_dir/)."""
    import cv2
    rng = np.random.RandomState(seed)
    for sub in ("img_dir", "ann_dir"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        gt = rng.randint(0, classes, hw).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "img_dir", f"s{i}.jpg"), img)
        cv2.imwrite(os.path.join(root, "ann_dir", f"s{i}.png"), gt)


def confusion_reading(config: str, checkpoint: str, root: str, dev) -> dict:
    """``cli.tools confusion_matrix`` on the card and on the CPU over the
    dataset at ``root``: both overall accuracies, the pixels whose
    predictions differ, and whether each is a near-tie (the CPU's two
    largest logits within 1e-4)."""
    import io

    from peanut_tpu_torch import apis
    from peanut_tpu_torch.cli import tools
    from peanut_tpu_torch.prediction.image_dataset import CustomDataset

    out, cms, secs = {}, {}, {}
    for where in ("card", "cpu"):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cms[where] = tools.main(
                ["confusion_matrix", config, checkpoint, root],
                device=dev if where == "card" else "cpu")
        secs[where] = time.perf_counter() - t0
        out[f"overall_acc_{where}"] = json.loads(
            printed.getvalue().splitlines()[-1])["overall_acc"]
    bundles = {w: apis.init_segmentor(config, checkpoint=checkpoint,
                                      device=dev if w == "card" else "cpu")
               for w in ("card", "cpu")}
    ds = CustomDataset(data_root=root)
    differ = ties = 0
    for i in range(len(ds)):
        img = ds[i]["img"]
        logits = apis.inference_segmentor(bundles["cpu"], img, logits=True)
        cpu = np.argmax(torch.sigmoid(torch.as_tensor(logits)).numpy(), 0)
        card = np.argmax(apis.inference_segmentor(bundles["card"], img), 0)
        top2 = np.sort(logits, axis=0)[-2:]
        d = card != cpu
        differ += int(d.sum())
        ties += int((d & (top2[1] - top2[0] <= TIE_TOL)).sum())
    return {**out, "images": len(ds), "pixels": int(cms["cpu"].sum()),
            "cm_equal": bool((cms["card"] == cms["cpu"]).all()),
            "pixels_differing": differ, "differing_near_ties": ties,
            "all_differences_near_ties": ties == differ,
            "tools_s_card": secs["card"], "tools_s_cpu": secs["cpu"]}


def zoo_tools_phase(args, dev, smi_line: str) -> dict:
    """Phase 14: the zoo's tools and converters (module docstring);
    returns its reading."""
    import io
    import tempfile

    from peanut_tpu_torch.cli import tools

    t_phase = time.perf_counter()
    reading = {"phase": "zoo_tools", "nvidia_smi": smi_line}
    with tempfile.TemporaryDirectory() as tmp:
        model, reading["convert_convnext"] = convert_into(
            "convnext", mmcls_convnext_t(args.seed), ZOO_TRAIN, tmp,
            args.seed, dev)
        ckpt = os.path.join(tmp, "upernet_convnext_t.pth")
        torch.save(model.state_dict(), ckpt)
        del model
        _, reading["convert_swin"] = convert_into(
            "swin", official_swin_t(args.seed + 1), ZOO_TOOLS_SWIN, tmp,
            args.seed + 1, dev, keep=SWIN_KEEP)
        reading["export_upernet_convnext"] = export_reading(
            ZOO_TRAIN, (1, 512, 512, 3), tmp, dev, checkpoint=ckpt)
        reading["export_peanut_pspnet"] = export_reading(
            ZOO_TOOLS_PSPNET, (1, 720, 720, 14), tmp, dev)
        data = os.path.join(tmp, "images")
        write_image_dataset(data, args.seed)
        reading["confusion_matrix"] = confusion_reading(ZOO_TRAIN, ckpt,
                                                        data, dev)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tools.main(["collect_env"])
    env = dict(ln.split(": ", 1) for ln in printed.getvalue().splitlines())
    emit({"phase": "zoo_tools_env", **env})
    reading["phase_s"] = time.perf_counter() - t_phase
    emit(reading)
    bad = []
    for k in ("convert_convnext", "convert_swin"):
        r = reading[k]
        c = r["backbone_card_vs_cpu_float64"]
        if r["leftovers"] or c["err_of_largest"] > CONVERT_TOL \
                or not c["finite"]:
            bad.append(k)
    for k in ("export_upernet_convnext", "export_peanut_pspnet"):
        r = reading[k]
        if not (r["within_1e-5"] and r["finite"]):
            bad.append(k)
    cm = reading["confusion_matrix"]
    if not cm["all_differences_near_ties"]:
        bad.append("confusion_matrix")
    if "cuda" not in env.get("device", "") or "jax" in sys.modules:
        bad.append("collect_env")
    if bad:
        fail(f"zoo_tools: {bad}")
    return reading


def only_phase(args, dev) -> int:
    """``--only``: one phase alone, to compare trees (the parent's, a
    variant's) in one call: "b3" B3's kernel lines in both types, "wide"
    the lines over 1024 cells, "paths" phase 3's B1, B2 and B4 lines at
    the paths' shapes, "train" the train phase, "zoo" the zoo phase,
    "zoo_train" the zoo's training phase, "zoo_tools" its tools and
    converters.  Prints no result line."""
    from peanut_tpu_torch.kernels import _build
    for stem in {"b3": ("roi_window",), "b1": ("fmm_fused",),
                 "wide": ("fmm_fused", "fmm_sweep", "fmm_sweep2",
                          "fmm_long"),
                 "paths": ("fmm_fused", "fmm_sweep", "fmm_sweep2"),
                 "train": (), "zoo": (), "zoo_train": (),
                 "zoo_tools": ()}[args.only]:
        _build.library(stem)
    if args.only == "paths":
        path_kernels(np.random.RandomState(args.seed), dev, {})
    elif args.only == "train":
        training_phase(args, dev, nvidia_smi_line())
    elif args.only == "zoo":
        zoo_phase(args, dev, nvidia_smi_line())
    elif args.only == "zoo_train":
        zoo_train_phase(args, dev, nvidia_smi_line())
    elif args.only == "zoo_tools":
        zoo_tools_phase(args, dev, nvidia_smi_line())
    elif args.only == "b3":
        mask_rcnn_phases(args, dev)
    elif args.only == "b1":
        b1_cases(np.random.RandomState(args.seed), dev, {})
    else:
        wide_lines(args, dev)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--only", choices=("b3", "b1", "wide", "paths",
                                       "train", "zoo", "zoo_train",
                                       "zoo_tools"),
                    help="run this phase alone (after the device line)")
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
    from peanut_tpu_torch.kernels.fmm import eikonal_distance
    from peanut_tpu_torch.kernels.fmm_fused import fused_eikonal
    from peanut_tpu_torch.kernels.fmm_sweep import block_sweep2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = nvidia_smi_line()
    emit({"phase": "device", "kind": name, "count": count,
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if args.only:
        return only_phase(args, dev)

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    try:
        for stem in ("fmm_fused", "fmm_sweep", "fmm_sweep2", "fmm_long",
                     "roi_window", "nms_greedy"):
            _build.library(stem)
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    from peanut_tpu_torch.kernels import fmm_fused, fmm_sweep, roi_window
    smem = {  # dynamic shared memory per block at the main path's shapes
        "roi_window_bf16_p7_26x274": roi_window._lib().roi_window_smem_bytes(
            1, 7, 26, 274, roi_window.ring_rows()),
        "roi_window_f32_p14_26x274": roi_window._lib().roi_window_smem_bytes(
            0, 14, 26, 274, 0)}
    # the sweeps' launch plans at the paths' shapes (block 16): cluster
    # size, segment, shared memory (the kernel's own count) and the
    # clusters the card holds at once at each size
    sweep_plans = {}
    for order, name_ in ((1, "block_sweep"), (2, "block_sweep2")):
        for b, n in ((1, 242), (1, 482), (1, 960), (16, 482)):
            plan = fmm_sweep.launch_plan(
                order, torch.empty(b, n, n, device=dev), 16)
            smem_c = (fmm_sweep._lib1().block_sweep_smem_bytes(n, plan.seg)
                      if order == 1 else
                      fmm_sweep._lib2().block_sweep2_smem_bytes(plan.seg, 16))
            if smem_c != plan.smem_bytes:
                fail(f"{name_} plan at {b}x{n}: {plan.smem_bytes} bytes of "
                     f"shared memory, the kernel counts {smem_c}")
            sweep_plans[f"{name_}_{b}x{n}"] = {
                "cluster": plan.cluster, "seg": plan.seg,
                "split": "rows" if order == 1 else "columns",
                "smem_bytes": plan.smem_bytes,
                "max_active_clusters": fmm_sweep.resident_clusters(
                    order, n, 16, dev)}
    # B1's plans: its blocks split the rows as B4's do, with ghost rows and
    # the column scans' staging in their shared memory
    for p in B1_CASES.values():
        (b, n), block, chunk = p["shape"], p["block"], p["scan_chunk"]
        plan = fmm_sweep.launch_plan(1, torch.empty(b, n, n, device=dev),
                                     block, fused_chunk=chunk)
        smem_c = fmm_fused._lib().fused_eikonal_smem_bytes(
            n, n, block, plan.seg, plan.ghosts)
        if smem_c != plan.smem_bytes:
            fail(f"fused_eikonal plan at {b}x{n}: {plan.smem_bytes} bytes "
                 f"of shared memory, the kernel counts {smem_c}")
        sweep_plans[f"fused_eikonal_{b}x{n}"] = {
            "cluster": plan.cluster, "seg": plan.seg, "split": "rows",
            "block": block, "ghosts": plan.ghosts,
            "smem_bytes": plan.smem_bytes,
            "max_active_clusters": fmm_sweep.resident_clusters(
                1, n, block, dev, (n, chunk))}
    # B1 at the exact profile's full map (map_size_cm=5200: 1042^2): one
    # grid and the 16-env batch
    for b in (1, 16):
        plan = fmm_sweep.launch_plan(1, torch.empty(b, 1042, 1042,
                                                    device=dev), 16,
                                     fused_chunk=4)
        sweep_plans[f"fused_eikonal_{b}x1042"] = {
            "cluster": plan.cluster, "seg": plan.seg, "split": "rows",
            "block": 16, "smem_bytes": plan.smem_bytes}
    # B3's bf16 y-contraction must run on the tensor cores: HMMA in the
    # library's SASS
    sass = subprocess.run(
        [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "cuobjdump"), "-sass",
         str(_build.build_dir() / "libroi_window.so")],
        capture_output=True, text=True, timeout=120).stdout
    hmma = {}
    func = None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
        elif "HMMA" in line and func:
            hmma[func] = hmma.get(func, 0) + 1
    if not any("nv_bfloat16" in f for f in hmma):
        fail(f"no HMMA in roi_window's bf16 kernels: {hmma}")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "roi_window_hmma_by_function": hmma,
          "nvcc_seconds": round(_build.build_seconds, 2),
          "dir": str(_build.build_dir()), "dynamic_smem_bytes": smem,
          "sweep_plans": sweep_plans, "ptxas": _build.ptxas_report()})
    # one cluster barrier at each size the plans use: the floor under a
    # sweep's chain of dependent passes
    barrier_us = {c: fmm_sweep.cluster_barrier_us(c) for c in
                  sorted({p["cluster"] for p in sweep_plans.values()})
                  if c > 1}
    emit({"phase": "cluster_barrier", "us_by_cluster": barrier_us})

    # ---- 3. kernels vs plain versions ----------------------------------
    rng = np.random.RandomState(args.seed)
    results = path_kernels(rng, dev, barrier_us)

    wide = wide_lines(args, dev)

    # where a fused_eikonal launch spends its time, at the blanket's shape
    p = B1_CASES["blanket_16x482"]
    trav_np, src_np = plans(rng, *p["shape"])
    emit({"phase": "kernel_breakdown", "kernel": "fused_eikonal",
          "case": "blanket_16x482", **fused_breakdown(
              torch.as_tensor(trav_np, device=dev),
              torch.as_tensor(src_np, device=dev),
              {k: v for k, v in p.items() if k != "shape"})})

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

    # ---- 5-7. Mask R-CNN: kernel B3, detect, the seg slice --------------
    b3, nms, seg_launches, maskrcnn = mask_rcnn_phases(args, dev)

    # ---- 7b. the 16-env serving tick with prediction ---------------------
    serve_launches = serving_phases(args, dev, maskrcnn)
    del maskrcnn
    launches_seg = {"fused_eikonal": seg_launches["fused_eikonal"],
                    "block_sweep2": seg_launches["block_sweep2"]}

    # ---- 8-10. the single-env agent: B4 on its main path ----------------
    explore, nav, nav_checks = single_env_phases(args, dev)
    single = {"single_explore": explore, "single_nav": nav}

    # ---- 11. training: PSPNet-R50-v1c at full width ---------------------
    training_phase(args, dev, smi_line)

    # ---- 12. the model zoo's serving path (no kernel of csrc/) ----------
    zoo_phase(args, dev, smi_line)

    # ---- 13. the model zoo's training half (no kernel of csrc/) ---------
    zoo_train_phase(args, dev, smi_line)

    # ---- 14. the zoo's tools and converters (no kernel of csrc/) ---------
    zoo_tools_phase(args, dev, smi_line)

    kernels = []
    for name_, src_file, replaces, keys, count_key in (
            ("fused_eikonal", "peanut_tpu_torch/kernels/csrc/fmm_fused.cu",
             "peanut_tpu/kernels/fmm_fused.py:256",
             # the serving tick's planning blanket first: the main case
             ("B1_blanket_16x482_b8",) + tuple(
                 f"B1_{k}" for k in B1_CASES if k != "blanket_16x482_b8"),
             "fused_eikonal"),
            ("block_sweep2", "peanut_tpu_torch/kernels/csrc/fmm_sweep2.cu",
             "peanut_tpu/kernels/fmm_pallas.py:298",
             ("B2_down_16x482_b8", "B2_down_16x482", "B2_up_16x482",
              "B2_down_1x960", "B2_down_1x482", "B2_down_1x242",
              "B2_down_8x960"),
             "block_sweep2")):
        main_case = results[keys[0]]
        by_path = {"slice": launches[count_key],
                   "slice_seg": launches_seg[count_key],
                   **{k: v[count_key] for k, v in serve_launches.items()}}
        by_path.update({k: v[count_key] for k, v in single.items()})
        kernels.append({
            "name": name_, "route": "cuda", "source": src_file,
            "replaces": replaces,
            "launches": serve_launches["serve_16"][count_key],
            "launches_by_path": by_path,
            "max_abs_err": max(results[k]["max_abs_err"] for k in keys),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "cases": {k: {kk: results[k][kk] for kk in
                          ("ms", "plain_ms", "bound_ms", "max_abs_err",
                           "bit_equal") + SWEEP_FIELDS}
                      for k in keys}})
    keys = ("B4_down_1x482", "B4_up_1x482", "B4_down_1x960",
            "B4_composed_16x482", "B4_down_1x242")
    main_case = results[keys[0]]
    kernels.append({
        "name": "block_sweep", "route": "cuda",
        "source": "peanut_tpu_torch/kernels/csrc/fmm_sweep.cu",
        "replaces": "peanut_tpu/kernels/fmm_pallas.py:159",
        "launches": nav["block_sweep"],
        "launches_note": "2-D solves only: single_nav's count; the batched "
                         "ticks launch none",
        "launches_by_path": {
            **{k: v["block_sweep"] for k, v in serve_launches.items()},
            **{k: v["block_sweep"] for k, v in single.items()}},
        "max_abs_err": max(results[k]["max_abs_err"] for k in keys),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "cases": {k: {kk: results[k][kk] for kk in
                      ("ms", "plain_ms", "bound_ms", "max_abs_err",
                       "bit_equal") + SWEEP_FIELDS} for k in keys}})
    main_case = b3["square_p7_n8000"]
    kernels.append({
        "name": "roi_window_pool", "route": "cuda",
        "source": "peanut_tpu_torch/kernels/csrc/roi_window.cu",
        "replaces": "peanut_tpu/kernels/roi_window.py:183",
        "launches": serve_launches["serve_16"]["roi_window_pool"],
        "launches_by_path": {"slice_seg": seg_launches["roi_window_pool"],
                             **{k: v["roi_window_pool"]
                                for k, v in serve_launches.items()},
                             **{k: v["roi_window_pool"]
                                for k, v in single.items()}},
        "max_abs_err": max(c["max_abs_err"] for c in
                           [*b3.values(),
                            *nav_checks["roi_window_pool"].values()]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library": "window gather + two torch.bmm",
        "cases": {**b3, **nav_checks["roi_window_pool"]}})
    main_case = nms["rpn_40x1000"]
    kernels.append({
        "name": "nms_keep", "route": "cuda",
        "source": "peanut_tpu_torch/kernels/csrc/nms_greedy.cu",
        "replaces": "peanut_tpu/models/boxes.py:117",
        "replaces_note": "the lax.while_loop of nms_fixed; no pallas_call",
        "launches": serve_launches["serve_16"]["nms_keep"],
        "launches_by_path": {"slice_seg": seg_launches["nms_keep"],
                             **{k: v["nms_keep"]
                                for k, v in serve_launches.items()},
                             **{k: v["nms_keep"] for k, v in single.items()}},
        "max_abs_err": max(c["max_abs_err"] for c in
                           [*nms.values(), *nav_checks["nms_keep"].values()]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None, "chain_floor_ms": main_case["chain_floor_ms"],
        "pack_ms": main_case["pack_ms"],
        "cases": {**nms, **nav_checks["nms_keep"]}})
    # the long-line instantiations: on no path's shapes, so no launches on
    # the main path; their wide_lines launches beside
    for name_, keys in LONG_CASES.items():
        main_case = wide[keys[0]]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": "peanut_tpu_torch/kernels/csrc/fmm_long.cu",
            "replaces": {"fused_eikonal_long":
                         "peanut_tpu/kernels/fmm_fused.py:256",
                         "block_sweep_long":
                         "peanut_tpu/kernels/fmm_pallas.py:159",
                         "block_sweep2_long":
                         "peanut_tpu/kernels/fmm_pallas.py:298"}[name_],
            "launches": serve_launches["serve_16"][name_],
            "launches_note": "lines past the shared-memory kernels only; "
                             "wide_lines's count beside",
            "launches_wide_lines": wide["long_launches"][name_],
            "max_abs_err": max(wide[k]["max_abs_err"] for k in keys),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "cases": {k: {kk: wide[k][kk] for kk in
                          ("ms", "plain_ms", "bound_ms", "max_abs_err",
                           "bit_equal", "cluster")} for k in keys}})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
