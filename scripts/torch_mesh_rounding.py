"""Where a sharded tick could round differently from the unsharded one, on
the card: PSPNet's rows at another batch, and the detect's chunks.

    python3 scripts/torch_mesh_rounding.py [--ticks 8]

Prints one JSON line a check, then the card's name and power limit:

* ``pspnet_batch``: ``PredictionModel.infer`` (PSPNet-R50-v1c from seed 0)
  on 16 random 14 x 720 x 720 maps in bfloat16 and float32 (TF32 off), in
  calls of 1, 2, 4 and 8 maps against one call of 16: bit-equal or the
  largest difference;
* ``detect_runs``: ``chip_smoke.py``'s serve_16 BatchRunner (Mask R-CNN
  and PSPNet from seed 0) run twice unsharded and once sharded over
  ``[cuda:0] * 4``: tick by tick, whether the semantic stacks fed to the
  tick, the actions, the goals and the whole DeviceState agree with the
  first run, and the first field that differs;
* ``gt_runs``: the same with GT semantics (no detect), sharded against
  unsharded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pspnet_batch(dev) -> dict:
    import torch

    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                peanut_prediction_config)
    from peanut_tpu_torch.prediction import PredictionModel

    pspnet = build_segmentor(peanut_prediction_config(), seed=0)
    x = torch.rand(16, 14, 720, 720, device=dev,
                   generator=torch.Generator(dev).manual_seed(0))
    out = {}
    for bf16 in (True, False):
        pm = PredictionModel(NavConfig(serve_bf16=bf16), model=pspnet,
                             device=dev)
        ref = pm.infer(x)
        res = {}
        for b in (1, 2, 4, 8):
            got = torch.cat([pm.infer(x[i:i + b]) for i in range(0, 16, b)])
            res[b] = {"bit_equal": bool(torch.equal(got, ref)),
                      "max_abs_diff": float((got - ref).abs().max())}
        out["bfloat16" if bf16 else "float32"] = res
    return out


def rollout(cfg, mesh, maskrcnn, pspnet, dev, ticks, gt):
    """Each tick's semantic stacks (as the tick gets them), actions,
    goals and DeviceState, on the CPU."""
    import torch

    import chip_smoke
    from peanut_tpu_torch.envs import FakeNavEnv
    from peanut_tpu_torch.envs.batch_runner import BatchRunner
    from peanut_tpu_torch.perception import MaskRCNNSegmenter
    from peanut_tpu_torch.prediction import PredictionModel

    kw = {} if gt else dict(segmenter=MaskRCNNSegmenter(cfg, model=maskrcnn,
                                                        device=dev))
    runner = BatchRunner(
        cfg, [lambda s=s: FakeNavEnv(cfg, size_m=14.0, seed=s,
                                     emit_gt_seg=gt) for s in range(16)],
        prediction_model=PredictionModel(cfg, model=pspnet, device=dev),
        device=None if mesh else dev, mesh=mesh, **kw)
    rt = runner.runtime
    log = chip_smoke.record_actions(rt)
    sems = []
    tick = rt._tick

    def recording(state, sem, *a):
        sems.append(sem.cpu().clone())
        return tick(state, sem, *a)
    rt._tick = recording
    states = []
    runner.reset_all()
    for _ in range(ticks):
        runner.tick()
        rt.wait_pending_goal()
        states.append([x.cpu() for x in rt.state])
    runner.close()
    k = len(rt.shards)
    return {"sems": [torch.cat(sems[i:i + k])
                     for i in range(0, len(sems), k)],
            "log": log, "states": states}


def compare(a, b) -> dict:
    import torch

    from peanut_tpu_torch.agent.batched_runtime import DeviceState

    first = None
    for t, (x, y) in enumerate(zip(a["states"], b["states"])):
        bad = [f for f, p, q in zip(DeviceState._fields, x, y)
               if not torch.equal(p, q)]
        if bad:
            first = {"tick": t, "fields": bad}
            break
    return {"sem_equal": [bool(torch.equal(x, y))
                          for x, y in zip(a["sems"], b["sems"])],
            "actions_equal": [x[0] == y[0]
                              for x, y in zip(a["log"], b["log"])],
            "goals_equal": [x[1] == y[1]
                            for x, y in zip(a["log"], b["log"])],
            "first_state_difference": first}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.core.mesh import make_mesh
    from peanut_tpu_torch.kernels import _build
    from peanut_tpu_torch.models import MaskRCNN
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                peanut_prediction_config)

    if not torch.cuda.is_available():
        raise SystemExit("this script measures the card; none is visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for stem in ("fmm_fused", "fmm_sweep", "fmm_sweep2", "fmm_long",
                 "roi_window", "nms_greedy"):
        _build.library(stem)
    print(json.dumps({"check": "pspnet_batch", **pspnet_batch(dev)}),
          flush=True)
    maskrcnn = MaskRCNN(num_classes=9, depth=101, seed=0)
    pspnet = build_segmentor(peanut_prediction_config(), seed=0)
    mesh = make_mesh({"data": 4}, devices=["cuda:0"] * 4)
    prof = chip_smoke.PROFILES["serve_16"]
    cfg = NavConfig(use_gt_seg=0, serve_bf16=True, **prof)
    runs = [rollout(cfg, m, maskrcnn, pspnet, dev, args.ticks, False)
            for m in (None, None, mesh)]
    print(json.dumps({"check": "detect_runs", "ticks": args.ticks,
                      "unsharded_again": compare(runs[0], runs[1]),
                      "sharded": compare(runs[0], runs[2])}), flush=True)
    cfg = NavConfig(use_gt_seg=1, serve_bf16=True, **prof)
    runs = [rollout(cfg, m, maskrcnn, pspnet, dev, args.ticks, True)
            for m in (None, mesh)]
    print(json.dumps({"check": "gt_runs", "ticks": args.ticks,
                      "sharded": compare(runs[0], runs[1])}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
