"""Inference throughput of a zoo config (port of
``peanut_tpu.cli.benchmark``; the reference's prediction/tools/
benchmark.py): steady-state maps per second at one input size, random
weights, after warm-up iterations.

  python -m peanut_tpu_torch.cli.benchmark [CONFIG] [--size 720]
      [--batch 4] [--warmup 5] [--iters 20] [--dtype bfloat16|float32]
      [--device cuda]

Without CONFIG, the PEANUT prediction model; weights and inputs from
seed 0.  bfloat16 casts the model's
floating-point parameters and buffers and the inputs, as the JAX package
casts every float32 variable.  On the card the timed loop sits between
two ``torch.cuda.synchronize()`` calls, so the host clock spans the
device work.  Prints one JSON line: maps_per_sec, ms_per_batch, batch,
size, dtype, device (the card's name).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default=None,
                    help="model config file (default: PEANUT prediction)")
    ap.add_argument("--size", type=int, default=720)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ns = ap.parse_args(argv)

    from .. import resolve_device, upload
    from ..core.config_file import load_config
    from ..models.builder import build_segmentor, peanut_prediction_config

    device = resolve_device(ns.device)
    model_cfg = (load_config(ns.config)["model"] if ns.config
                 else peanut_prediction_config())
    in_ch = model_cfg["backbone"].get("in_channels", 3)
    dtype = torch.bfloat16 if ns.dtype == "bfloat16" else torch.float32
    model = build_segmentor(model_cfg, seed=0).to(device, dtype)
    rng = np.random.RandomState(0)
    xs = [upload(rng.rand(ns.batch, ns.size, ns.size, in_ch)
                 .astype(np.float32), device).to(dtype) for _ in range(2)]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        for i in range(ns.warmup):
            model.inference(xs[i % 2])
        sync()
        t0 = time.perf_counter()
        for i in range(ns.iters):
            model.inference(xs[i % 2])
        sync()
        dt = time.perf_counter() - t0
    out = {
        "maps_per_sec": ns.batch * ns.iters / dt,
        "ms_per_batch": 1e3 * dt / ns.iters,
        "batch": ns.batch, "size": ns.size, "dtype": ns.dtype,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
