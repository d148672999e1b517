"""Dataset and model-weight converters (port of ``peanut_tpu.cli.convert``;
the reference's prediction/tools/convert_datasets/ and
prediction/tools/model_converters/):

  python -m peanut_tpu_torch.cli.convert model vit|mit|swin|vitjax|convnext|
      beit|stdc1|stdc2|twins SRC OUT.pt
  python -m peanut_tpu_torch.cli.convert dataset cityscapes DATA_ROOT
  python -m peanut_tpu_torch.cli.convert dataset voc_aug DEVKIT SBD OUT
  python -m peanut_tpu_torch.cli.convert dataset binarize IN_DIR OUT_DIR
  python -m peanut_tpu_torch.cli.convert dataset remap IN_DIR OUT_DIR
      --table t.json
  python -m peanut_tpu_torch.cli.convert dataset chase_db1|drive|hrf|stare|
      pascal_context|isaid|potsdam|vaihingen|loveda|coco_stuff10k|
      coco_stuff164k ...   (the walkers of cli/convert_datasets.py)

A model converter reads a torch ``.pth`` (or the augreg ``.npz``) and
writes the JAX package's flax tree of it as a ``torch.save`` file of
nested dicts of tensors (where the JAX package writes an orbax
directory); ``load_converted`` reads it back as numpy, and
``models.zoo_import.converted_backbone_state`` lays it into a port
backbone.  The dataset converters rewrite annotation images into the
label spaces the datasets expect; they run on the host and need cv2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict

import numpy as np

# Cityscapes labelId -> trainId (the 19-class mapping from the reference's
# cityscapes.py converter / cityscapesscripts labels table)
CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def _remap_png(src: str, dst: str, lut: np.ndarray):
    import cv2

    img = cv2.imread(src, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"unreadable: {src}")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    cv2.imwrite(dst, lut[img])


def _build_lut(table: dict, default: int = 255) -> np.ndarray:
    lut = np.full(256, default, np.uint8)
    for k, v in table.items():
        lut[int(k)] = int(v)
    return lut


def dataset_cityscapes(args):
    """gtFine labelIds -> labelTrainIds (convert_datasets/cityscapes.py)."""
    lut = _build_lut(CITYSCAPES_ID_TO_TRAIN)
    pat = os.path.join(args.data_root, "gtFine", "**", "*_labelIds.png")
    files = sorted(glob.glob(pat, recursive=True))
    for i, f in enumerate(files):
        _remap_png(f, f.replace("_labelIds", "_labelTrainIds"), lut)
        if i % 200 == 0:
            print(f"{i}/{len(files)}")
    print(f"converted {len(files)} annotation maps")


def dataset_voc_aug(args):
    """SBD .mat annotations -> pngs merged with VOC2012
    (convert_datasets/voc_aug.py)."""
    from scipy.io import loadmat
    import cv2

    mats = sorted(glob.glob(os.path.join(args.sbd, "dataset", "cls",
                                         "*.mat")))
    out = os.path.join(args.out, "SegmentationClassAug")
    os.makedirs(out, exist_ok=True)
    for i, m in enumerate(mats):
        seg = loadmat(m)["GTcls"][0]["Segmentation"][0].astype(np.uint8)
        name = os.path.splitext(os.path.basename(m))[0]
        cv2.imwrite(os.path.join(out, name + ".png"), seg)
        if i % 500 == 0:
            print(f"{i}/{len(mats)}")
    print(f"converted {len(mats)} SBD annotations -> {out}")


def dataset_binarize(args):
    """Retina-vessel datasets (CHASE_DB1 / DRIVE / HRF / STARE converters):
    threshold annotation images to {0 background, 1 vessel} pngs."""
    import cv2

    files = sorted(
        f for ext in ("png", "jpg", "tif", "gif", "ppm", "bmp")
        for f in glob.glob(os.path.join(args.in_dir, "**", f"*.{ext}"),
                           recursive=True))
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for f in files:
        img = cv2.imread(f, cv2.IMREAD_GRAYSCALE)
        if img is None:
            try:  # a gif cv2 cannot decode: PIL, where it is installed
                from PIL import Image

                img = np.array(Image.open(f).convert("L"))
            except Exception:
                print(f"skipped unreadable {f}")
                continue
        name = os.path.splitext(os.path.basename(f))[0]
        out = (img >= args.threshold).astype(np.uint8)
        cv2.imwrite(os.path.join(args.out_dir, name + ".png"), out)
        n += 1
    print(f"binarized {n} annotation maps -> {args.out_dir}")


def dataset_remap(args):
    """Generic label remap over a directory tree (covers the coco_stuff /
    potsdam / vaihingen / loveda style converters: each is a fixed id
    table applied to every annotation png)."""
    with open(args.table) as f:
        lut = _build_lut(json.load(f), default=args.default)
    files = sorted(glob.glob(os.path.join(args.in_dir, "**", "*.png"),
                             recursive=True))
    for i, f in enumerate(files):
        rel = os.path.relpath(f, args.in_dir)
        _remap_png(f, os.path.join(args.out_dir, rel), lut)
        if i % 200 == 0:
            print(f"{i}/{len(files)}")
    print(f"remapped {len(files)} maps")


def convert_model(kind: str, src: str):
    """``(variables, leftovers)`` of the checkpoint at ``src`` through the
    converter of ``kind`` (``models/zoo_import.py``)."""
    from ..models import zoo_import
    from ..models.checkpoint import load_torch_state_dict

    if kind == "vitjax":
        return zoo_import.convert_augreg_vit(dict(np.load(src)))
    sd = load_torch_state_dict(src, kind, "src")
    if kind in ("stdc1", "stdc2"):
        return zoo_import.convert_official_stdc(
            sd, "STDCNet1" if kind == "stdc1" else "STDCNet2")
    fn = {"vit": zoo_import.convert_timm_vit,
          "mit": zoo_import.convert_official_mit,
          "swin": zoo_import.convert_official_swin,
          "convnext": zoo_import.convert_mmcls_convnext,
          "beit": zoo_import.convert_official_beit,
          "twins": zoo_import.convert_official_twins}[kind]
    return fn(sd)


def _tensors(tree):
    import torch

    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def load_converted(path: str) -> Dict[str, Any]:
    """A file written by ``model`` as its flax tree of numpy arrays."""
    import torch

    def numpy(tree):
        return {k: numpy(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}

    return numpy(torch.load(path, map_location="cpu", weights_only=True))


def _count(tree) -> int:
    return sum(_count(v) if isinstance(v, dict) else 1
               for v in tree.values())


def model_convert(args):
    import torch

    variables, leftovers = convert_model(args.kind, args.src)
    torch.save(_tensors(variables), args.out)
    print(f"converted {args.kind}: {_count(variables)} arrays -> {args.out}")
    if leftovers:
        print(f"unmapped source keys ({len(leftovers)}):")
        for k in leftovers[:20]:
            print("  ", k)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("model")
    m.add_argument("kind", choices=["vit", "mit", "swin", "vitjax",
                                    "convnext", "beit", "stdc1", "stdc2",
                                    "twins"])
    m.add_argument("src")
    m.add_argument("out")
    m.set_defaults(fn=model_convert)

    d = sub.add_parser("dataset")
    dsub = d.add_subparsers(dest="dataset", required=True)

    cs = dsub.add_parser("cityscapes")
    cs.add_argument("data_root")
    cs.set_defaults(fn=dataset_cityscapes)

    va = dsub.add_parser("voc_aug")
    va.add_argument("devkit")
    va.add_argument("sbd")
    va.add_argument("out")
    va.set_defaults(fn=dataset_voc_aug)

    bz = dsub.add_parser("binarize")
    bz.add_argument("in_dir")
    bz.add_argument("out_dir")
    bz.add_argument("--threshold", type=int, default=128)
    bz.set_defaults(fn=dataset_binarize)

    rm = dsub.add_parser("remap")
    rm.add_argument("in_dir")
    rm.add_argument("out_dir")
    rm.add_argument("--table", required=True,
                    help="JSON {src_id: dst_id} table")
    rm.add_argument("--default", type=int, default=255)
    rm.set_defaults(fn=dataset_remap)

    # the per-dataset layout walkers (convert_datasets/ twins)
    from .convert_datasets import register_subcommands
    register_subcommands(dsub)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
