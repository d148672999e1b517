"""Where the PyTorch port's Mask R-CNN detect spends host time, and where
its chunks are best launched.

    python3 scripts/torch_detect_launch.py [--seed N] [--ticks N] [--reps N]

Runs on one CUDA card (R101-FPN, random weights from ``--seed``, bf16).
Prints one JSON line per measurement:
  * ``enqueue``: host milliseconds to enqueue each stage of a detect of 8
    frames at 800x1088, with nothing else running (the device work is
    asynchronous: these are Python + launch costs, not device times);
  * ``slice_seg``: 16 FakeNavEnvs under NavConfig(use_gt_seg=0,
    only_explore=1, switch_step=999, serve_bf16=True), steps/s and the
    StageTimer stages, with the detect chunks launched as the runtime does,
    from the env-step threads once ``seg_batch_chunk`` frames are staged
    (``early``), and with every chunk launched in ``_pack_obs`` after the
    env steps (``after_env``), alternating ``--reps`` times each;
and last the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import seg_frames  # noqa: E402
from peanut_tpu_torch.config import NavConfig  # noqa: E402
from peanut_tpu_torch.envs import FakeNavEnv  # noqa: E402
from peanut_tpu_torch.envs.batch_runner import BatchRunner  # noqa: E402
from peanut_tpu_torch.models import MaskRCNN  # noqa: E402
from peanut_tpu_torch.perception import MaskRCNNSegmenter  # noqa: E402


def host_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def enqueue_split(seg, rgb, cats, reps=3):
    """Median host ms per stage of one detect (synchronised between
    detects, never inside one)."""
    m = seg.model
    goal = torch.as_tensor(cats, device=rgb.device)
    rows = []
    for _ in range(reps):
        torch.cuda.synchronize()
        img, t_pre = host_ms(lambda: seg.preprocess(rgb))
        h, w = img.shape[1], img.shape[2]
        pyr, t_feat = host_ms(lambda: m.features(img))
        props, t_rpn = host_ms(lambda: m.proposals(pyr, h, w))
        ctx, t_ctx = host_ms(lambda: m.roi_context(pyr))
        (bx, sc, cl), t_box = host_ms(lambda: m.box_inference(
            pyr, *props, h, w, roi_ctx=ctx))
        ms, t_mask = host_ms(lambda: m.mask_inference(pyr, bx, cl,
                                                      roi_ctx=ctx))
        _, t_paste = host_ms(lambda: seg.paste(bx.float(), sc.float(), cl,
                                               ms.float(), goal))
        rows.append({"preprocess": t_pre, "backbone_fpn": t_feat,
                     "rpn_proposals": t_rpn + t_ctx,
                     "box_head_roialign_nms": t_box,
                     "mask_head_roialign": t_mask, "paste": t_paste})
    torch.cuda.synchronize()
    out = {k: sorted(r[k] for r in rows)[reps // 2] for k in rows[0]}
    out["total"] = sum(out.values())
    return out


def slice_seg(cfg, seg, seed, ticks, after_env):
    runner = BatchRunner(
        cfg, [lambda s=s: FakeNavEnv(cfg, size_m=14.0, seed=seed + s,
                                     emit_gt_seg=False)
              for s in range(16)], segmenter=seg, device="cuda")
    if after_env:
        # no chunk is launched while staging: _pack_obs detects them all
        runner.runtime._seg_chunk = 0
    runner.reset_all()
    for _ in range(3):
        runner.tick()
    runner.warmup_rare_paths()
    runner.reset_timers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        runner.tick()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stages = {k: round(v / ticks * 1e3, 3)
              for k, v in runner.stage_totals().items()}
    runner.close()
    return {"env_steps_per_sec": 16 * ticks / dt,
            "stage_ms_per_tick": stages}


@torch.no_grad()
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NavConfig(use_gt_seg=0, only_explore=1, switch_step=999,
                    serve_bf16=True)
    seg = MaskRCNNSegmenter(cfg, model=MaskRCNN(num_classes=9, depth=101,
                                                seed=args.seed),
                            device="cuda")
    rgb, cats = seg_frames(cfg, args.seed, 8)
    for _ in range(3):
        seg.batch_device(rgb, cats)
    print(json.dumps({"enqueue": "detect of 8 at 800x1088, host ms",
                      **enqueue_split(seg, rgb, cats)}), flush=True)
    slice_seg(cfg, seg, args.seed, args.ticks, False)          # warm-up
    for rep in range(args.reps):
        for after_env in (False, True):
            print(json.dumps({
                "slice_seg": "after_env" if after_env else "early",
                "rep": rep, **slice_seg(cfg, seg, args.seed, args.ticks,
                                        after_env)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
