"""Where the peak memory of PSPNet's row-sharded forward goes, on a card.

    python3 scripts/torch_spatial_memory.py [--size 960] [--shards 2]

PEANUT's PSPNet-R50-v1c at full width (random weights, seed 0) on one
(1, 14, size, size) map, float32 with TF32 off, in eval mode: the
unsharded forward and ``models.sharded.forward_rows`` over
``[cuda:0] * shards``.  Every ``F.conv2d`` call is wrapped to record how
far the card's allocated memory rose above what was allocated when the
call began (its output, and any workspace cuDNN took from PyTorch's
allocator), with the shapes and whether its input was contiguous.  Prints
one JSON line a run: the forward's peak above the weights and input, and
the convolutions that rose the most.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=960)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from peanut_tpu_torch.core import spatial
    from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                                peanut_prediction_config)
    from peanut_tpu_torch.models.sharded import forward_rows

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = build_segmentor(peanut_prediction_config(), seed=0).to(dev)
    x = torch.rand(1, 14, args.size, args.size,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    calls = []
    conv2d = F.conv2d

    def recorded(inp, weight, *rest, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = conv2d(inp, weight, *rest, **kw)
        torch.cuda.synchronize()
        calls.append({"rise_mib": (torch.cuda.max_memory_allocated()
                                   - before) / 2 ** 20,
                      "out_mib": out.numel() * out.element_size() / 2 ** 20,
                      "input": list(inp.shape),
                      "weight": list(weight.shape),
                      "contiguous": inp.is_contiguous(),
                      "args": [str(a) for a in rest]})
        return out

    runs = {"unsharded": lambda: model(x, train=False),
            f"sharded_{args.shards}": lambda: forward_rows(
                model, spatial.shard(x, [dev] * args.shards), train=False)}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "size": args.size}), flush=True)
    for name, fn in runs.items():
        with torch.no_grad():
            fn()                                   # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            calls.clear()
            F.conv2d = recorded
            try:
                fn()
            finally:
                F.conv2d = conv2d
        top = sorted(calls, key=lambda c: -c["rise_mib"])[:args.top]
        print(json.dumps({"run": name, "peak_mib": peak,
                          "convolutions": len(calls),
                          "largest_rise": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
