"""Per-dataset layout walkers (port of ``peanut_tpu.cli.convert_datasets``;
the reference's prediction/tools/convert_datasets/).

Each function reproduces one upstream converter's behaviour -- archive
layout, split membership, label encoding, output naming -- on cv2 and
numpy (no mmcv).  They are registered on ``python -m
peanut_tpu_torch.cli.convert dataset <name> ...`` by cli/convert.py; the
generic ``binarize`` / ``remap`` subcommands there remain for ad-hoc
label spaces.  Where the JAX package writes a png through PIL, this copy
writes it through cv2: the files decode to the same arrays (label maps
as single-channel pngs).  PIL is imported only for a file cv2 cannot
read as asked (a gif, a palette png's indices).

Covered here: chase_db1, drive, hrf, stare (retina vessel sets),
pascal_context, isaid, potsdam, vaihingen, loveda, coco_stuff10k,
coco_stuff164k.
"""

from __future__ import annotations

import glob
import gzip
import math
import os
import os.path as osp
import shutil
import tarfile
import tempfile
import zipfile

import numpy as np


def _imread(path, gray=False):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else
                     cv2.IMREAD_COLOR)
    if img is None:
        # a gif / ppm annotation cv2 cannot decode (DRIVE et al.): PIL
        from PIL import Image

        img = np.array(Image.open(path).convert("L" if gray else "RGB"))
        if not gray:
            img = img[:, :, ::-1]  # PIL RGB -> cv2 BGR convention
    return img


def _read_rgb(path):
    """An image as RGB (PIL's ``convert("RGB")``)."""
    return np.ascontiguousarray(_imread(path)[:, :, ::-1])


def _read_label(path):
    """A label png's values (``np.array(Image.open(path))``): cv2 reads a
    single-channel png as it is; a palette png (cv2 expands it to colours)
    or a file cv2 cannot read goes through PIL for its indices."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None or img.ndim != 2:
        from PIL import Image

        img = np.array(Image.open(path))
    return img


def _imwrite(img, path):
    import cv2

    os.makedirs(osp.dirname(path), exist_ok=True)
    if not cv2.imwrite(path, np.ascontiguousarray(img)):
        raise IOError(f"failed to write {path}")


def _split_dirs(out_dir, subdirs=("images", "annotations"),
                splits=("training", "validation")):
    for sub in subdirs:
        for sp in splits:
            os.makedirs(osp.join(out_dir, sub, sp), exist_ok=True)


def _vessel_ann(img):
    """Retina-vessel annotation binarization: // 128 (nonstandard
    annotation images contain values other than {0, 255})."""
    if img.ndim == 3:
        img = img[:, :, 0]
    return img // 128


# ----------------------------------------------------------------------
# CHASE_DB1: one zip of 28*3 files; first 60 (sorted) = training.
# ----------------------------------------------------------------------
def dataset_chase_db1(args):
    out_dir = args.out_dir
    _split_dirs(out_dir)
    with tempfile.TemporaryDirectory() as tmp:
        zipfile.ZipFile(args.zip_path).extractall(tmp)
        files = sorted(os.listdir(tmp))
        if len(files) != 28 * 3:
            raise ValueError(f"expected {28 * 3} files, got {len(files)}")
        for i, name in enumerate(files):
            split = "training" if i < 60 else "validation"
            stem = osp.splitext(name)[0]
            img = _imread(osp.join(tmp, name))
            if name.endswith(".jpg"):
                _imwrite(img, osp.join(out_dir, "images", split,
                                       stem + ".png"))
            else:
                _imwrite(_vessel_ann(img),
                         osp.join(out_dir, "annotations", split,
                                  stem + ".png"))
    print("Done!")


# ----------------------------------------------------------------------
# DRIVE: training.zip + test.zip; images/ + 1st_manual/ (+ 2nd_manual).
# ----------------------------------------------------------------------
def dataset_drive(args):
    out_dir = args.out_dir
    _split_dirs(out_dir)

    def walk(zip_path, inner, split):
        with tempfile.TemporaryDirectory() as tmp:
            zipfile.ZipFile(zip_path).extractall(tmp)
            img_dir = osp.join(tmp, inner, "images")
            for name in sorted(os.listdir(img_dir)):
                stem = osp.splitext(name)[0]
                stem = stem.replace("_training", "").replace("_test", "")
                _imwrite(_imread(osp.join(img_dir, name)),
                         osp.join(out_dir, "images", split, stem + ".png"))
            for manual in ("1st_manual", "2nd_manual"):
                man_dir = osp.join(tmp, inner, manual)
                if not osp.isdir(man_dir):
                    continue
                for name in sorted(os.listdir(man_dir)):
                    stem = osp.splitext(name)[0]
                    ann = _imread(osp.join(man_dir, name), gray=True)
                    _imwrite(_vessel_ann(ann),
                             osp.join(out_dir, "annotations", split,
                                      stem + ".png"))

    walk(args.training_zip, "training", "training")
    walk(args.testing_zip, "test", "validation")
    print("Done!")


# ----------------------------------------------------------------------
# HRF: three image zips + three annotation zips of 15 files each;
# first 5 (sorted) of each = training.
# ----------------------------------------------------------------------
def dataset_hrf(args):
    out_dir = args.out_dir
    _split_dirs(out_dir)

    def walk(zip_path, sub, to_label):
        with tempfile.TemporaryDirectory() as tmp:
            zipfile.ZipFile(zip_path).extractall(tmp)
            files = sorted(os.listdir(tmp))
            if len(files) != 15:
                raise ValueError(f"{zip_path}: expected 15 files, got "
                                 f"{len(files)}")
            for i, name in enumerate(files):
                split = "training" if i < 5 else "validation"
                stem = osp.splitext(name)[0]
                img = _imread(osp.join(tmp, name))
                if to_label:
                    img = _vessel_ann(img)
                _imwrite(img, osp.join(out_dir, sub, split, stem + ".png"))

    for z in (args.healthy, args.glaucoma, args.diabetic):
        walk(z, "images", False)
    for z in (args.healthy_manualsegm, args.glaucoma_manualsegm,
              args.diabetic_manualsegm):
        walk(z, "annotations", True)
    print("Done!")


# ----------------------------------------------------------------------
# STARE: stare-images.tar + labels-ah.tar + labels-vk.tar of gzipped
# ppms, 20 files each; first 10 (sorted) = training.
# ----------------------------------------------------------------------
def dataset_stare(args):
    out_dir = args.out_dir
    _split_dirs(out_dir)

    def walk(tar_path, sub, to_label):
        with tempfile.TemporaryDirectory() as tmp:
            gz_dir = osp.join(tmp, "gz")
            file_dir = osp.join(tmp, "files")
            os.makedirs(gz_dir)
            os.makedirs(file_dir)
            with tarfile.open(tar_path) as f:
                f.extractall(gz_dir)
            for name in os.listdir(gz_dir):
                with gzip.open(osp.join(gz_dir, name), "rb") as src, \
                        open(osp.join(file_dir, osp.splitext(name)[0]),
                             "wb") as dst:
                    shutil.copyfileobj(src, dst)
            files = sorted(os.listdir(file_dir))
            if len(files) != 20:
                raise ValueError(f"{tar_path}: expected 20 files, got "
                                 f"{len(files)}")
            for i, name in enumerate(files):
                split = "training" if i < 10 else "validation"
                stem = osp.splitext(name)[0]
                img = _imread(osp.join(file_dir, name))
                if to_label:
                    img = _vessel_ann(img)
                _imwrite(img, osp.join(out_dir, sub, split, stem + ".png"))

    walk(args.images_tar, "images", False)
    walk(args.labels_ah, "annotations", True)
    walk(args.labels_vk, "annotations", True)
    print("Done!")


# ----------------------------------------------------------------------
# PASCAL-Context: 459-class detail masks -> 60-class pngs + split lists.
# ----------------------------------------------------------------------
PASCAL_CONTEXT_MAPPING = np.sort(np.array([
    0, 2, 259, 260, 415, 324, 9, 258, 144, 18, 19, 22, 23, 397, 25, 284,
    158, 159, 416, 33, 162, 420, 454, 295, 296, 427, 44, 45, 46, 308, 59,
    440, 445, 31, 232, 65, 354, 424, 68, 326, 72, 458, 34, 207, 80, 355,
    85, 347, 220, 349, 360, 98, 187, 104, 105, 366, 189, 368, 113, 115]))


def dataset_pascal_context(args):
    try:
        from detail import Detail
    except ImportError as e:
        raise SystemExit(
            "pascal_context conversion needs the 'detail' API "
            "(https://github.com/zhanghang1989/detail-api) to decode "
            "trainval_merged.json — same dependency as the upstream "
            "converter") from e

    devkit, json_path = args.devkit_path, args.json_path
    out_dir = args.out_dir or osp.join(devkit, "VOC2010",
                                       "SegmentationClassContext")
    os.makedirs(out_dir, exist_ok=True)
    img_dir = osp.join(devkit, "VOC2010", "JPEGImages")
    list_dir = osp.join(devkit, "VOC2010", "ImageSets",
                        "SegmentationContext")
    os.makedirs(list_dir, exist_ok=True)
    key = np.arange(len(PASCAL_CONTEXT_MAPPING)).astype(np.uint8)

    for phase in ("train", "val"):
        detail = Detail(json_path, img_dir, phase)
        names = []
        for img_id in detail.getImgs():
            mask = detail.getMask(img_id)
            assert np.isin(np.unique(mask), PASCAL_CONTEXT_MAPPING).all()
            idx = np.digitize(mask.ravel(), PASCAL_CONTEXT_MAPPING,
                              right=True)
            out = key[idx].reshape(mask.shape)
            fname = img_id["file_name"].replace("jpg", "png")
            _imwrite(out, osp.join(out_dir, fname))
            names.append(osp.splitext(osp.basename(fname))[0])
        with open(osp.join(list_dir, f"{phase}.txt"), "w") as f:
            f.writelines(n + "\n" for n in sorted(names))
    print("Done!")


# ----------------------------------------------------------------------
# iSAID: color-palette instance masks -> labels, slide-cropped patches.
# ----------------------------------------------------------------------
ISAID_PALETTE = [
    (0, 0, 0), (0, 0, 63), (0, 63, 63), (0, 63, 0), (0, 63, 127),
    (0, 63, 191), (0, 63, 255), (0, 127, 63), (0, 127, 127), (0, 0, 127),
    (0, 0, 191), (0, 0, 255), (0, 191, 127), (0, 127, 191), (0, 127, 255),
    (0, 100, 155)]


def _isaid_color_to_label(rgb):
    out = np.zeros(rgb.shape[:2], np.uint8)
    for i, c in enumerate(ISAID_PALETTE):
        out[np.all(rgb == np.asarray(c), axis=2)] = i
    return out


def _pad_to(img, h, w, pad_val):
    ph, pw = max(h - img.shape[0], 0), max(w - img.shape[1], 0)
    if not ph and not pw:
        return img
    spec = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, spec, constant_values=pad_val)


def _slide_windows(img_h, img_w, patch_h, patch_w, overlap):
    for x in range(0, img_w, patch_w - overlap):
        for y in range(0, img_h, patch_h - overlap):
            x0, x1 = x, x + patch_w
            if x1 > img_w:
                x0, x1 = x - (x1 - img_w), img_w
            y0, y1 = y, y + patch_h
            if y1 > img_h:
                y0, y1 = y - (y1 - img_h), img_h
            yield y0, y1, x0, x1


def dataset_isaid(args):
    out_dir = args.out_dir
    ph, pw, ov = args.patch_height, args.patch_width, args.overlap_area
    for sub in ("img_dir", "ann_dir"):
        for sp in ("train", "val", "test"):
            os.makedirs(osp.join(out_dir, sub, sp), exist_ok=True)

    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("train", "val", "test"):
            for z in glob.glob(osp.join(args.dataset_path, mode, "images",
                                        "*.zip")):
                zipfile.ZipFile(z).extractall(osp.join(tmp, mode, "img"))
            for src in glob.glob(osp.join(tmp, mode, "img", "images",
                                          "*.png")):
                if mode == "test":
                    shutil.move(src, osp.join(out_dir, "img_dir", mode))
                    continue
                img = _read_rgb(src)
                img = _pad_to(img, ph, pw, 0)
                stem = osp.basename(src).split(".")[0]
                h, w = img.shape[:2]
                for y0, y1, x0, x1 in _slide_windows(h, w, ph, pw, ov):
                    name = f"{stem}_{y0}_{y1}_{x0}_{x1}.png"
                    _imwrite(img[y0:y1, x0:x1, ::-1],
                             osp.join(out_dir, "img_dir", mode, name))
            if mode == "test":
                continue
            for z in glob.glob(osp.join(args.dataset_path, mode,
                                        "Semantic_masks", "*.zip")):
                zipfile.ZipFile(z).extractall(osp.join(tmp, mode, "lab"))
            for src in glob.glob(osp.join(tmp, mode, "lab", "images",
                                          "*.png")):
                rgb = _read_rgb(src)
                lab = _isaid_color_to_label(rgb)
                lab = _pad_to(lab, ph, pw, 255)
                # upstream keeps only the tile id (split('_')[0]) and
                # re-appends the _instance_color_RGB suffix
                stem = osp.basename(src).split(".")[0].split("_")[0]
                h, w = lab.shape
                for y0, y1, x0, x1 in _slide_windows(h, w, ph, pw, ov):
                    name = (f"{stem}_{y0}_{y1}_{x0}_{x1}"
                            "_instance_color_RGB.png")
                    _imwrite(lab[y0:y1, x0:x1],
                             osp.join(out_dir, "ann_dir", mode, name))
    print("Done!")


# ----------------------------------------------------------------------
# ISPRS Potsdam / Vaihingen: zip of huge tifs, clipped to strided
# patches; BGR color legend -> 6 labels via the [2,3,4] dot trick.
# ----------------------------------------------------------------------
ISPRS_COLOR_MAP = np.array([
    [0, 0, 0], [255, 255, 255], [255, 0, 0], [255, 255, 0], [0, 255, 0],
    [0, 255, 255], [0, 0, 255]])

POTSDAM_SPLITS = {
    "train": ["2_10", "2_11", "2_12", "3_10", "3_11", "3_12", "4_10",
              "4_11", "4_12", "5_10", "5_11", "5_12", "6_10", "6_11",
              "6_12", "6_7", "6_8", "6_9", "7_10", "7_11", "7_12", "7_7",
              "7_8", "7_9"],
    "val": ["5_15", "6_15", "6_13", "3_13", "4_14", "6_14", "5_14", "2_13",
            "4_15", "2_14", "5_13", "4_13", "3_14", "7_13"],
}

VAIHINGEN_SPLITS = {
    "train": ["area1", "area11", "area13", "area15", "area17", "area21",
              "area23", "area26", "area28", "area3", "area30", "area32",
              "area34", "area37", "area5", "area7"],
    "val": ["area6", "area24", "area35", "area16", "area14", "area22",
            "area10", "area4", "area2", "area20", "area8", "area31",
            "area33", "area27", "area38", "area12", "area29"],
}


def _isprs_to_label(image):
    h, w, c = image.shape
    flat = image.reshape(-1, c) @ np.array([2, 3, 4]).reshape(3, 1)
    out = np.zeros_like(flat)
    for idx, color in enumerate(ISPRS_COLOR_MAP):
        out[flat == color @ np.array([2, 3, 4]).reshape(3, 1)] = idx
    return out.reshape(h, w)


def _clip_big_image(image_path, save_dir, clip_size, stride_size, stem,
                    to_label):
    image = _imread(image_path)
    h, w = image.shape[:2]
    if to_label:
        image = _isprs_to_label(image)

    def n_steps(extent):
        k = math.ceil((extent - clip_size) / stride_size)
        return k if k * stride_size + clip_size >= extent else k + 1

    xs, ys = np.meshgrid(np.arange(n_steps(w) + 1) * clip_size,
                         np.arange(n_steps(h) + 1) * clip_size)
    xs, ys = xs.ravel(), ys.ravel()
    xs = xs + np.where(xs + clip_size > w, w - xs - clip_size, 0)
    ys = ys + np.where(ys + clip_size > h, h - ys - clip_size, 0)
    for x0, y0 in zip(xs, ys):
        x1 = min(x0 + clip_size, w)
        y1 = min(y0 + clip_size, h)
        clip = image[y0:y1, x0:x1]
        _imwrite(clip.astype(np.uint8),
                 osp.join(save_dir, f"{stem}_{x0}_{y0}_{x1}_{y1}.png"))


def _isprs_walk(args, splits, stem_of, label_key):
    out_dir = args.out_dir
    for sub in ("img_dir", "ann_dir"):
        for sp in ("train", "val"):
            os.makedirs(osp.join(out_dir, sub, sp), exist_ok=True)
    for zipp in glob.glob(osp.join(args.dataset_path, "*.zip")):
        with tempfile.TemporaryDirectory() as tmp:
            zipfile.ZipFile(zipp).extractall(tmp)
            srcs = glob.glob(osp.join(tmp, "*.tif"))
            if not srcs:
                sub = osp.join(tmp, os.listdir(tmp)[0])
                srcs = glob.glob(osp.join(sub, "*.tif"))
            # upstream deletes the unused area9 ground truth only
            srcs = [s for s in srcs
                    if not (label_key in s and stem_of(s) == "area9")]
            for src in srcs:
                stem = stem_of(src)
                split = "train" if stem in splits["train"] else "val"
                # full-path GT check, keyed per dataset like upstream:
                # potsdam GT basenames carry '_label', vaihingen GT tifs
                # carry '_noBoundary' (potsdam.py:143, vaihingen.py:140)
                to_label = label_key in src
                sub = "ann_dir" if to_label else "img_dir"
                _clip_big_image(src, osp.join(out_dir, sub, split),
                                args.clip_size, args.stride_size, stem,
                                to_label)
    print("Done!")


def dataset_potsdam(args):
    _isprs_walk(args, POTSDAM_SPLITS,
                lambda p: "_".join(osp.basename(p).split("_")[2:4]),
                label_key="label")


def dataset_vaihingen(args):
    _isprs_walk(args, VAIHINGEN_SPLITS,
                lambda p: osp.basename(p).split("_")[3].split(".")[0],
                label_key="noBoundary")


# ----------------------------------------------------------------------
# LoveDA: Train/Val/Test zips, Rural+Urban subtrees moved flat.
# ----------------------------------------------------------------------
def dataset_loveda(args):
    out_dir = args.out_dir
    for sp in ("train", "val", "test"):
        os.makedirs(osp.join(out_dir, "img_dir", sp), exist_ok=True)
    for sp in ("train", "val"):
        os.makedirs(osp.join(out_dir, "ann_dir", sp), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for dataset in ("Train", "Val", "Test"):
            zipfile.ZipFile(osp.join(args.dataset_path,
                                     dataset + ".zip")).extractall(tmp)
            mode = dataset.lower()
            for location in ("Rural", "Urban"):
                for kind in ("images_png", "masks_png"):
                    if dataset == "Test" and kind == "masks_png":
                        continue
                    dst = osp.join(out_dir, "img_dir" if kind ==
                                   "images_png" else "ann_dir", mode)
                    src_dir = osp.join(tmp, dataset, location, kind)
                    for name in os.listdir(src_dir):
                        shutil.move(osp.join(src_dir, name), dst)
    print("Done!")


# ----------------------------------------------------------------------
# COCO-Stuff: sparse class ids -> contiguous trainIds.  Both variants'
# tables are "sorted valid ids -> 0..n-1"; only the valid sets differ.
# ----------------------------------------------------------------------
COCO164K_INVALID = {11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90}
COCO10K_INVALID = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}


def _coco_lut(n_ids, invalid):
    lut = np.full(256, 255, np.uint8)
    tr = 0
    for cls in range(n_ids):
        if cls in invalid:
            continue
        lut[cls] = tr
        tr += 1
    return lut


def dataset_coco_stuff164k(args):
    lut = _coco_lut(182, COCO164K_INVALID)
    coco = args.coco_path
    out_dir = args.out_dir or coco
    for sp in ("train2017", "val2017"):
        os.makedirs(osp.join(out_dir, "annotations", sp), exist_ok=True)
    if out_dir != coco and not osp.isdir(osp.join(out_dir, "images")):
        shutil.copytree(osp.join(coco, "images"),
                        osp.join(out_dir, "images"))
    for sp in ("train2017", "val2017"):
        files = [f for f in glob.glob(osp.join(coco, "annotations", sp,
                                               "*.png"))
                 if "_labelTrainIds" not in f]
        for i, f in enumerate(files):
            mask = _read_label(f)
            stem = osp.basename(f).split(".")[0]
            _imwrite(lut[mask], osp.join(out_dir, "annotations", sp,
                                         stem + "_labelTrainIds.png"))
            if i % 500 == 0:
                print(f"{sp}: {i}/{len(files)}")
    print("Done!")


def dataset_coco_stuff10k(args):
    from scipy.io import loadmat

    lut = _coco_lut(183, COCO10K_INVALID)
    coco = args.coco_path
    out_dir = args.out_dir or coco
    for sp in ("train2014", "test2014"):
        os.makedirs(osp.join(out_dir, "images", sp), exist_ok=True)
        os.makedirs(osp.join(out_dir, "annotations", sp), exist_ok=True)
    for list_name, sp in (("train.txt", "train2014"),
                          ("test.txt", "test2014")):
        with open(osp.join(coco, "imageLists", list_name)) as f:
            names = [line.strip() for line in f if line.strip()]
        for i, stem in enumerate(names):
            shutil.copyfile(osp.join(coco, "images", stem + ".jpg"),
                            osp.join(out_dir, "images", sp, stem + ".jpg"))
            mask = loadmat(osp.join(coco, "annotations",
                                    stem + ".mat"))["S"].astype(np.uint8)
            _imwrite(lut[mask], osp.join(out_dir, "annotations", sp,
                                         stem + "_labelTrainIds.png"))
            if i % 500 == 0:
                print(f"{sp}: {i}/{len(names)}")
    print("Done!")


def register_subcommands(dsub):
    """Attach every walker to cli/convert.py's ``dataset`` subparser."""
    c = dsub.add_parser("chase_db1")
    c.add_argument("zip_path")
    c.add_argument("-o", "--out_dir", default="data/CHASE_DB1")
    c.set_defaults(fn=dataset_chase_db1)

    d = dsub.add_parser("drive")
    d.add_argument("training_zip")
    d.add_argument("testing_zip")
    d.add_argument("-o", "--out_dir", default="data/DRIVE")
    d.set_defaults(fn=dataset_drive)

    h = dsub.add_parser("hrf")
    for name in ("healthy", "healthy_manualsegm", "glaucoma",
                 "glaucoma_manualsegm", "diabetic", "diabetic_manualsegm"):
        h.add_argument(name)
    h.add_argument("-o", "--out_dir", default="data/HRF")
    h.set_defaults(fn=dataset_hrf)

    s = dsub.add_parser("stare")
    s.add_argument("images_tar")
    s.add_argument("labels_ah")
    s.add_argument("labels_vk")
    s.add_argument("-o", "--out_dir", default="data/STARE")
    s.set_defaults(fn=dataset_stare)

    pc = dsub.add_parser("pascal_context")
    pc.add_argument("devkit_path")
    pc.add_argument("json_path")
    pc.add_argument("-o", "--out_dir", default=None)
    pc.set_defaults(fn=dataset_pascal_context)

    isd = dsub.add_parser("isaid")
    isd.add_argument("dataset_path")
    isd.add_argument("-o", "--out_dir", default="data/iSAID")
    isd.add_argument("--patch_width", type=int, default=896)
    isd.add_argument("--patch_height", type=int, default=896)
    isd.add_argument("--overlap_area", type=int, default=384)
    isd.set_defaults(fn=dataset_isaid)

    for name, fn, default_out in (
            ("potsdam", dataset_potsdam, "data/potsdam"),
            ("vaihingen", dataset_vaihingen, "data/vaihingen")):
        pz = dsub.add_parser(name)
        pz.add_argument("dataset_path")
        pz.add_argument("-o", "--out_dir", default=default_out)
        pz.add_argument("--clip_size", type=int, default=512)
        pz.add_argument("--stride_size", type=int, default=256)
        pz.set_defaults(fn=fn)

    lv = dsub.add_parser("loveda")
    lv.add_argument("dataset_path")
    lv.add_argument("-o", "--out_dir", default="data/loveDA")
    lv.set_defaults(fn=dataset_loveda)

    c164 = dsub.add_parser("coco_stuff164k")
    c164.add_argument("coco_path")
    c164.add_argument("-o", "--out_dir", default=None)
    c164.set_defaults(fn=dataset_coco_stuff164k)

    c10 = dsub.add_parser("coco_stuff10k")
    c10.add_argument("coco_path")
    c10.add_argument("-o", "--out_dir", default=None)
    c10.set_defaults(fn=dataset_coco_stuff10k)
