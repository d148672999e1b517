"""Times PEANUT's PSPNet-R50-v1c on the card, to compare two trees in one
call: ``PredictionModel.infer`` on K x 14 x 720 x 720 maps (K = 8, the
batched runtime's ``predict_chunk``) in bfloat16 (the serving profile) and
float32, and the trainer's step (batch 8, crop 960, the backbone
recomputed in backward), random weights and inputs from seed 0.

    python3 scripts/torch_pspnet_timing.py [--tree DIR] [--reps 20]

``--tree`` imports ``peanut_tpu_torch`` from another checkout's root (a
parent commit unpacked beside this one) instead of this one's.  Times are
CUDA-event medians after warm-up; PyTorch's TF32 defaults are kept.
Prints one JSON line: the tree, the card's name and power limit, and per
reading the median and all times in ms, and the peak memory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, reps: int, warmup: int) -> dict:
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return {"ms_median": float(np.median(ms)), "ms": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train_reps", type=int, default=6)
    ns = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(ns.tree))

    import torch

    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                 peanut_prediction_config)
    from peanut_tpu_torch.prediction import PredictionModel
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   make_train_step)

    if not torch.cuda.is_available():
        raise SystemExit("torch_pspnet_timing: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"tree": os.path.relpath(os.path.abspath(ns.tree), REPO),
           "module": sys.modules["peanut_tpu_torch"].__file__,
           "nvidia_smi": smi.strip().splitlines()[0]}
    g = torch.Generator(device=dev).manual_seed(0)

    maps = torch.rand(8, 14, 720, 720, device=dev, generator=g)
    for name, bf16 in (("infer_bf16", True), ("infer_float32", False)):
        pm = PredictionModel(NavConfig(serve_bf16=bf16),
                             model=build_segmentor(
                                 peanut_prediction_config(), seed=0),
                             device=dev)
        out[name] = timed(lambda: pm.infer(maps), ns.reps, warmup=3)
        del pm
        torch.cuda.empty_cache()

    tcfg = TrainConfig(seed=0)
    state = create_train_state(build_segmentor(
        peanut_prediction_config(remat=True), seed=0), tcfg, device=dev)
    step = make_train_step(tcfg)
    batch = {"img": torch.rand(8, 14, 960, 960, device=dev, generator=g),
             "gt": 255 * torch.rand(8, 6, 960, 960, device=dev,
                                    generator=g)}
    out["train_step_b8_crop960"] = timed(lambda: step(state, batch),
                                         ns.train_reps, warmup=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
