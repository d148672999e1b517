"""Analysis tool CLIs (port of ``peanut_tpu.cli.tools``; the reference's
prediction/tools/print_config.py, analyze_logs.py, confusion_matrix.py,
browse_dataset.py and mmseg/utils/collect_env.py).

Usage:
  python -m peanut_tpu_torch.cli.tools print_config CONFIG
  python -m peanut_tpu_torch.cli.tools analyze_logs LOG.jsonl [--keys ...]
  python -m peanut_tpu_torch.cli.tools confusion_matrix CONFIG CKPT
      DATA_ROOT [--img_dir ...] [--out cm.npy] [--device cuda]
  python -m peanut_tpu_torch.cli.tools browse_dataset DATA_ROOT
  python -m peanut_tpu_torch.cli.tools collect_env

``confusion_matrix`` runs the model through ``apis`` on the card unless
``--device`` (or ``main``'s ``device``) says otherwise; an empty CKPT
means random weights.  The others run on the host; ``collect_env``
reports the card, the CUDA toolkit and where the kernels build.
"""

from __future__ import annotations

import argparse
import json
import pprint

import numpy as np


def print_config(args):
    from ..core.config_file import load_config
    cfg = load_config(args.config)
    pprint.pprint(cfg, width=88, sort_dicts=False)


def analyze_logs(args):
    """Summarize a JSONL train log: per-key min/max/last + a coarse curve
    (tools/analyze_logs.py plots; headless here -- numbers, not pixels)."""
    from ..utils.loggers import read_train_log
    records = read_train_log(args.log)
    if not records:
        print("empty log")
        return
    keys = args.keys or sorted(
        k for k in records[-1] if isinstance(records[-1][k], (int, float))
        and k != "iter")
    iters = [r.get("iter", i) for i, r in enumerate(records)]
    print(f"{len(records)} records, iter {iters[0]}..{iters[-1]}")
    for k in keys:
        vals = [(it, r[k]) for it, r in zip(iters, records) if k in r]
        if not vals:
            continue
        vs = [v for _, v in vals]
        print(f"  {k}: first={vs[0]:.6g} min={min(vs):.6g} "
              f"max={max(vs):.6g} last={vs[-1]:.6g}")
        if args.curve:
            n = min(10, len(vals))
            pts = [vals[int(i * (len(vals) - 1) / max(n - 1, 1))]
                   for i in range(n)]
            print("    " + "  ".join(f"@{it}:{v:.4g}" for it, v in pts))


def confusion_matrix(args):
    """Accumulate a num_classes x num_classes confusion matrix of argmax
    predictions over a dataset (tools/confusion_matrix.py)."""
    from ..apis import inference_segmentor, init_segmentor
    from ..prediction import image_dataset  # noqa: F401  (registers)
    from ..registry import DATASETS

    bundle = init_segmentor(args.config, checkpoint=args.checkpoint or None,
                            device=args.device)
    ds = DATASETS.get(args.dataset_type)(data_root=args.data_root,
                                         img_dir=args.img_dir,
                                         ann_dir=args.ann_dir)
    k = ds.num_classes or bundle.model.num_classes
    cm = np.zeros((k, k), np.int64)
    n = len(ds) if args.max_samples <= 0 else min(len(ds), args.max_samples)
    for i in range(n):
        sample = ds[i]
        probs = inference_segmentor(bundle, sample["img"])   # (C, H, W)
        pred = np.argmax(probs, axis=0)
        gt = sample["gt"]
        valid = (gt != ds.ignore_index) & (gt >= 0) & (gt < k)
        idx = gt[valid] * k + np.clip(pred[valid], 0, k - 1)
        cm += np.bincount(idx.ravel(), minlength=k * k).reshape(k, k)
    if args.out:
        np.save(args.out, cm)
        print(f"saved: {args.out}")
    with np.errstate(invalid="ignore", divide="ignore"):
        acc = np.diag(cm) / cm.sum(axis=1)
    print("per-class accuracy:",
          " ".join(f"{a:.3f}" for a in np.nan_to_num(acc)))
    print(json.dumps({"total_pixels": int(cm.sum()),
                      "overall_acc": float(np.diag(cm).sum()
                                           / max(cm.sum(), 1))}))
    return cm


def browse_dataset(args):
    """Iterate a dataset and report per-sample stats; optionally dump
    composite previews (tools/browse_dataset.py, headless-first)."""
    from ..prediction import image_dataset  # noqa: F401  (registers)
    from ..registry import DATASETS

    ds = DATASETS.get(args.dataset_type)(
        data_root=args.data_root, img_dir=args.img_dir, ann_dir=args.ann_dir)
    n = len(ds) if args.max_samples <= 0 else min(len(ds), args.max_samples)
    print(f"{args.dataset_type}: {len(ds)} samples (showing {n})")
    for i in range(n):
        s = ds[i]
        img, gt = np.asarray(s["img"]), np.asarray(s["gt"])
        classes, counts = np.unique(gt[gt != ds.ignore_index],
                                    return_counts=True)
        print(f"  [{i}] img {img.shape} {img.dtype} "
              f"range [{img.min():.3g}, {img.max():.3g}] | gt {gt.shape} "
              f"classes {dict(zip(classes.tolist(), counts.tolist()))}")
        if args.out_dir:
            import os

            import cv2

            os.makedirs(args.out_dir, exist_ok=True)
            vis = img if img.dtype == np.uint8 else np.clip(
                (img - img.min()) / max(np.ptp(img), 1e-6) * 255, 0,
                255).astype(np.uint8)
            if vis.ndim == 3 and vis.shape[-1] > 3:
                vis = vis[..., :3]
            gt_vis = (gt.astype(np.float32) * (255.0 / max(gt.max(), 1)))
            gt_vis = np.stack([gt_vis] * 3, -1).astype(np.uint8)
            cv2.imwrite(os.path.join(args.out_dir, f"sample_{i}.png"),
                        np.concatenate([vis[..., ::-1], gt_vis], axis=1))


def _nvcc_release() -> str:
    """``nvcc --version``'s release line, or "absent"."""
    import subprocess

    from ..kernels import _build
    try:
        out = subprocess.run([_build._nvcc(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "absent"
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else "absent"


def collect_env(args):
    """The environment report (mmseg/utils/collect_env.py parity): Python,
    the platform, torch and its CUDA, the device (the card unless
    ``--device`` names another), nvcc's release, the kernels' build
    directory, numpy and this package, one ``key: value`` a line."""
    import platform
    import sys

    import torch

    import peanut_tpu_torch
    from ..kernels import _build

    info = {"python": sys.version.split()[0],
            "platform": platform.platform(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda or "absent"}
    try:
        dev = peanut_tpu_torch.resolve_device(args.device)
        info["device"] = (f"{dev} ({torch.cuda.get_device_name(dev)})"
                          if dev.type == "cuda" else str(dev))
    except RuntimeError as e:            # no card and no device named
        info["device"] = f"unavailable ({e})"
    info["nvcc"] = _nvcc_release()
    info["kernel_build_dir"] = str(_build.build_dir())
    info["numpy"] = np.__version__
    info["peanut_tpu_torch"] = peanut_tpu_torch.__version__
    for k, v in info.items():
        print(f"{k}: {v}")


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ce = sub.add_parser("collect_env")
    ce.add_argument("--device", default=None)
    ce.set_defaults(fn=collect_env)

    pc = sub.add_parser("print_config")
    pc.add_argument("config")
    pc.set_defaults(fn=print_config)

    al = sub.add_parser("analyze_logs")
    al.add_argument("log")
    al.add_argument("--keys", nargs="*", default=None)
    al.add_argument("--curve", action="store_true")
    al.set_defaults(fn=analyze_logs)

    cmx = sub.add_parser("confusion_matrix")
    cmx.add_argument("config")
    cmx.add_argument("checkpoint")
    cmx.add_argument("data_root")
    cmx.add_argument("--dataset_type", default="CustomDataset")
    cmx.add_argument("--img_dir", default="img_dir")
    cmx.add_argument("--ann_dir", default="ann_dir")
    cmx.add_argument("--max_samples", type=int, default=0)
    cmx.add_argument("--out", default=None)
    cmx.add_argument("--device", default=None,
                     help="torch device (default: the card)")
    cmx.set_defaults(fn=confusion_matrix)

    bd = sub.add_parser("browse_dataset")
    bd.add_argument("data_root")
    bd.add_argument("--dataset_type", default="CustomDataset")
    bd.add_argument("--img_dir", default="img_dir")
    bd.add_argument("--ann_dir", default="ann_dir")
    bd.add_argument("--max_samples", type=int, default=8)
    bd.add_argument("--out_dir", default=None)
    bd.set_defaults(fn=browse_dataset)

    args = p.parse_args(argv)
    if device is not None:
        args.device = device
    return args.fn(args)


if __name__ == "__main__":
    main()
