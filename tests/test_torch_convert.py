"""The dataset converters of the port (``cli.convert dataset``, ROADMAP A13
part 6) against the JAX package's, on the CPU: the thirteen dataset
converters (cityscapes, voc_aug and the eleven walkers of
cli/convert_datasets.py) and the two generic ones (binarize, remap), each
run through both CLIs on the same synthetic archives -- those of
tests/test_convert_datasets.py and tests/test_zoo_import.py, plus seeded
Cityscapes and SBD inputs of their own.  Every file either writes must
be written by the other under the same relative path, and decode to the
same array (pngs read by PIL: the JAX package writes some through PIL,
the port through cv2, so the bytes may differ where the pixels do not).
"""

import gzip
import io
import json
import os
import sys
import tarfile
import types
import zipfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from peanut_tpu.cli.convert import main as jax_main  # noqa: E402
from peanut_tpu_torch.cli.convert import main as port_main  # noqa: E402


def _png(arr):
    ok, buf = cv2.imencode(".png", arr)
    assert ok
    return buf.tobytes()


def _zip(path, entries):
    with zipfile.ZipFile(path, "w") as z:
        for name, data in entries.items():
            z.writestr(name, data)


def _img(rng, h=8, w=8):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def _ann(val=255, h=8, w=8):
    a = np.zeros((h, w, 3), np.uint8)
    a[2:5, 2:5] = val
    return a


def _files(root):
    out = set()
    for d, _, fs in os.walk(root):
        for f in fs:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def _decode(path):
    if path.endswith((".png", ".jpg", ".gif", ".tif", ".ppm")):
        with Image.open(path) as im:
            return np.array(im)
    with open(path, "rb") as f:
        return f.read()


def run_both(tmp_path, make, argv):
    """``make(root)`` writes the inputs under ``root``; ``argv(root)`` is
    the command line.  Both packages' CLIs run on inputs of their own
    (made alike) and must add the same files with the same content.
    Returns the port's root and the files it added."""
    added = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        root = str(tmp_path / name)
        os.makedirs(root)
        make(root, np.random.RandomState(0))
        before = _files(root)
        main(argv(root))
        after = _files(root)
        added[name] = (root, after - before, before - after)
    (jroot, jnew, jgone), (proot, pnew, pgone) = added["jax"], added["port"]
    assert pnew == jnew and pgone == jgone
    assert pnew, "the converter wrote nothing"
    for rel in sorted(pnew):
        a = _decode(os.path.join(jroot, rel))
        b = _decode(os.path.join(proot, rel))
        if isinstance(a, bytes):
            assert a == b, rel
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            np.testing.assert_array_equal(b, a, err_msg=rel)
    return proot, pnew


def test_cityscapes(tmp_path):
    def make(root, rng):
        for split, city in (("train", "aachen"), ("val", "lindau")):
            d = os.path.join(root, "gtFine", split, city)
            os.makedirs(d)
            for i in range(2):
                ids = rng.randint(0, 34, (8, 12)).astype(np.uint8)
                cv2.imwrite(os.path.join(
                    d, f"{city}_00000{i}_000019_gtFine_labelIds.png"), ids)
    root, new = run_both(tmp_path, make,
                         lambda r: ["dataset", "cityscapes", r])
    assert len(new) == 4 and all("_labelTrainIds" in f for f in new)
    f = sorted(new)[0]
    ids = cv2.imread(os.path.join(root, f.replace("TrainIds", "Ids")),
                     cv2.IMREAD_UNCHANGED)
    out = cv2.imread(os.path.join(root, f), cv2.IMREAD_UNCHANGED)
    assert (out[ids == 26] == 13).all() and (out[ids == 0] == 255).all()


def test_voc_aug(tmp_path):
    from scipy.io import savemat

    def make(root, rng):
        d = os.path.join(root, "sbd", "dataset", "cls")
        os.makedirs(d)
        os.makedirs(os.path.join(root, "devkit"))
        for name in ("2008_000002", "2008_000003"):
            seg = rng.randint(0, 21, (6, 7)).astype(np.uint8)
            savemat(os.path.join(d, name + ".mat"), {"GTcls": {
                "Segmentation": seg, "Boundaries": np.zeros((1, 1))}})
    root, new = run_both(tmp_path, make, lambda r: [
        "dataset", "voc_aug", os.path.join(r, "devkit"),
        os.path.join(r, "sbd"), os.path.join(r, "out")])
    assert new == {f"out/SegmentationClassAug/2008_00000{i}.png"
                   for i in (2, 3)}


def test_binarize(tmp_path):
    def make(root, rng):
        d = os.path.join(root, "ann")
        os.makedirs(os.path.join(d, "sub"))
        cv2.imwrite(os.path.join(d, "v.png"),
                    (rng.rand(20, 20) * 255).astype(np.uint8))
        Image.fromarray((rng.rand(9, 9) * 255).astype(np.uint8)).save(
            os.path.join(d, "sub", "w.gif"))
    root, new = run_both(tmp_path, make, lambda r: [
        "dataset", "binarize", os.path.join(r, "ann"),
        os.path.join(r, "out")])
    assert new == {"out/v.png", "out/w.png"}


def test_remap(tmp_path):
    def make(root, rng):
        d = os.path.join(root, "in", "a")
        os.makedirs(d)
        cv2.imwrite(os.path.join(d, "m.png"),
                    (rng.rand(16, 16) * 6).astype(np.uint8))
        with open(os.path.join(root, "t.json"), "w") as f:
            json.dump({"0": 10, "1": 11, "2": 12, "3": 13}, f)
    root, new = run_both(tmp_path, make, lambda r: [
        "dataset", "remap", os.path.join(r, "in"), os.path.join(r, "out"),
        "--table", os.path.join(r, "t.json"), "--default", "7"])
    out = cv2.imread(os.path.join(root, "out", "a", "m.png"),
                     cv2.IMREAD_UNCHANGED)
    assert set(np.unique(out)) <= {7, 10, 11, 12, 13}


def test_chase_db1(tmp_path):
    def make(root, rng):
        entries = {}
        for i in range(28):
            entries[f"Image_{i:02d}.jpg"] = cv2.imencode(
                ".jpg", _img(rng))[1].tobytes()
            entries[f"Image_{i:02d}_1stHO.png"] = _png(_ann(255))
            entries[f"Image_{i:02d}_2ndHO.png"] = _png(_ann(200))
        _zip(os.path.join(root, "CHASEDB1.zip"), entries)
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "chase_db1", os.path.join(r, "CHASEDB1.zip"), "-o",
        os.path.join(r, "out")])
    assert sum(f.startswith(os.path.join("out", "images", "training"))
               for f in new) == 20


def test_drive(tmp_path):
    def gif(arr):
        b = io.BytesIO()
        Image.fromarray(arr).save(b, format="GIF")
        return b.getvalue()

    def make(root, rng):
        _zip(os.path.join(root, "training.zip"), {
            "training/images/21_training.png": _png(_img(rng)),
            "training/1st_manual/21_manual1.gif": gif(_ann(255)[:, :, 0])})
        _zip(os.path.join(root, "test.zip"), {
            "test/images/01_test.png": _png(_img(rng)),
            "test/1st_manual/01_manual1.gif": gif(_ann(129)[:, :, 0]),
            "test/2nd_manual/01_manual2.gif": gif(_ann(40)[:, :, 0])})
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "drive", os.path.join(r, "training.zip"),
        os.path.join(r, "test.zip"), "-o", os.path.join(r, "out")])
    assert os.path.join("out", "annotations", "validation",
                        "01_manual2.png") in new


def test_hrf(tmp_path):
    def make(root, rng):
        for kind in ("healthy", "glaucoma", "dr"):
            _zip(os.path.join(root, f"{kind}.zip"),
                 {f"{kind}_{i:02d}.png": _png(_img(rng)) for i in range(15)})
            _zip(os.path.join(root, f"{kind}_manualsegm.zip"),
                 {f"{kind}_{i:02d}.png": _png(_ann(255)) for i in range(15)})
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "hrf"] + [os.path.join(r, f"{k}{m}.zip") for k in
                             ("healthy", "glaucoma", "dr")
                             for m in ("", "_manualsegm")] +
        ["-o", os.path.join(r, "out")])
    assert len(new) == 90


def test_stare(tmp_path):
    def tar_of_gz(root, path, stem_fmt, make):
        with tarfile.open(path, "w") as t:
            for i in range(20):
                ppm = cv2.imencode(".ppm", make(i))[1].tobytes()
                gz = os.path.join(root, f"{stem_fmt.format(i)}.ppm.gz")
                with gzip.open(gz, "wb") as g:
                    g.write(ppm)
                t.add(gz, arcname=os.path.basename(gz))
                os.remove(gz)

    def make(root, rng):
        tar_of_gz(root, os.path.join(root, "stare-images.tar"), "im{:04d}",
                  lambda i: _img(rng))
        tar_of_gz(root, os.path.join(root, "labels-ah.tar"),
                  "im{:04d}.ah", lambda i: _ann(255))
        tar_of_gz(root, os.path.join(root, "labels-vk.tar"),
                  "im{:04d}.vk", lambda i: _ann(130))
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "stare", os.path.join(r, "stare-images.tar"),
        os.path.join(r, "labels-ah.tar"), os.path.join(r, "labels-vk.tar"),
        "-o", os.path.join(r, "out")])
    assert len(new) == 60


def test_pascal_context(tmp_path, monkeypatch):
    """The Detail API (zhanghang1989/detail-api) is no dependency of
    either package: a stand-in gives each phase two masks of the 459
    classes, drawn from the 60 kept."""
    from peanut_tpu.cli.convert_datasets import PASCAL_CONTEXT_MAPPING

    class Detail:
        def __init__(self, json_path, img_dir, phase):
            self.phase = phase

        def getImgs(self):
            return [{"file_name": f"2008_{self.phase}{i}.jpg"}
                    for i in range(2)]

        def getMask(self, img):
            rng = np.random.RandomState(len(img["file_name"]) +
                                        int(img["file_name"][-5]))
            return PASCAL_CONTEXT_MAPPING[rng.randint(0, 60, (6, 9))]

    monkeypatch.setitem(sys.modules, "detail",
                        types.SimpleNamespace(Detail=Detail))

    def make(root, rng):
        os.makedirs(os.path.join(root, "devkit", "VOC2010", "JPEGImages"))
        with open(os.path.join(root, "trainval_merged.json"), "w") as f:
            f.write("{}")
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "pascal_context", os.path.join(r, "devkit"),
        os.path.join(r, "trainval_merged.json"), "-o",
        os.path.join(r, "out")])
    assert os.path.join("devkit", "VOC2010", "ImageSets",
                        "SegmentationContext", "val.txt") in new
    assert sum(f.startswith("out") for f in new) == 4


def _isaid_inputs(root, rng, second_class):
    img = (rng.rand(20, 20, 3) * 255).astype(np.uint8)
    mask = np.zeros((20, 20, 3), np.uint8)
    mask[5:10, 5:10] = [0, 0, 63]              # class 1
    if second_class:
        mask[12:18, 2:6] = [0, 127, 255]       # class 14
    for mode in ("train", "val", "test"):
        d = os.path.join(root, "data", mode)
        os.makedirs(os.path.join(d, "images"))
        _zip(os.path.join(d, "images", "part1.zip"),
             {"images/P0000.png": _png(img[:, :, ::-1])})
        if mode != "test":
            os.makedirs(os.path.join(d, "Semantic_masks"))
            _zip(os.path.join(d, "Semantic_masks", "masks.zip"),
                 {"images/P0000_instance_color_RGB.png":
                  _png(mask[:, :, ::-1])})
    return mask


def _isaid_argv(r):
    return ["dataset", "isaid", os.path.join(r, "data"), "-o",
            os.path.join(r, "out"), "--patch_width", "16", "--patch_height",
            "16", "--overlap_area", "8"]


def test_isaid(tmp_path):
    """tests/test_convert_datasets.py's mask: one class besides the
    background."""
    root, new = run_both(
        tmp_path, lambda r, rng: _isaid_inputs(r, rng, False), _isaid_argv)
    assert len([f for f in new if "ann_dir/train" in f]) == 4
    assert len([f for f in new if "img_dir/test" in f]) == 1


def test_isaid_label_tiles_keep_every_class(tmp_path):
    """Each label tile holds the JAX package's own colour decoding
    (``_isaid_color_to_label``) of its window, class 14 too.  The JAX
    walker saves its tiles as palette pngs without a palette, which
    Pillow 12 writes with every non-zero index as 1: its files are
    compared in ``test_isaid``, where the mask has one class."""
    from peanut_tpu.cli.convert_datasets import _isaid_color_to_label
    root = str(tmp_path)
    mask = _isaid_inputs(root, np.random.RandomState(0), True)
    port_main(_isaid_argv(root))
    want = _isaid_color_to_label(mask)
    tiles = sorted(os.listdir(os.path.join(root, "out", "ann_dir", "val")))
    assert len(tiles) == 4
    seen = set()
    for name in tiles:
        y0, y1, x0, x1 = map(int, name.split("_")[1:5])
        got = cv2.imread(os.path.join(root, "out", "ann_dir", "val", name),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want[y0:y1, x0:x1])
        seen |= set(np.unique(got))
    assert seen == {0, 1, 14}


def test_potsdam_and_vaihingen(tmp_path):
    color = np.zeros((32, 32, 3), np.uint8)
    color[:16] = [255, 255, 255]
    color[16:] = [0, 0, 255]
    cases = {
        "potsdam": (["top_potsdam_2_10_RGB.tif", "top_potsdam_5_15_RGB.tif"],
                    lambda t: t.replace("_RGB", "_label")),
        "vaihingen": (["top_mosaic_09cm_area1.tif",
                       "top_mosaic_09cm_area6.tif"],
                      lambda t: t.replace(".tif", "_noBoundary.tif")),
    }
    for name, (tiles, label_name) in cases.items():
        def make(root, rng):
            _zip(os.path.join(root, "images.zip"),
                 {t: _png(_img(rng, 32, 32)) for t in tiles})
            labels = {label_name(t): _png(color) for t in tiles}
            if name == "vaihingen":
                labels[label_name("top_mosaic_09cm_area9.tif")] = \
                    _png(color)
            _zip(os.path.join(root, "labels.zip"), labels)
        _, new = run_both(tmp_path / name, make, lambda r: [
            "dataset", name, r, "-o", os.path.join(r, "out"),
            "--clip_size", "16", "--stride_size", "8"])
        assert len(new) == 16


def test_loveda(tmp_path):
    def make(root, rng):
        for dataset in ("Train", "Val", "Test"):
            entries = {}
            for loc in ("Rural", "Urban"):
                entries[f"{dataset}/{loc}/images_png/{loc}_1.png"] = \
                    _png(_img(rng))
                if dataset != "Test":
                    entries[f"{dataset}/{loc}/masks_png/{loc}_1.png"] = \
                        _png(_ann(3)[:, :, 0])
            _zip(os.path.join(root, f"{dataset}.zip"), entries)
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "loveda", r, "-o", os.path.join(r, "out")])
    assert len(new) == 10


def test_coco_stuff164k(tmp_path):
    def make(root, rng):
        for sp in ("train2017", "val2017"):
            d = os.path.join(root, "annotations", sp)
            os.makedirs(d)
            mask = rng.randint(0, 183, (8, 8)).astype(np.uint8)
            mask[0] = 12
            mask[1] = 11
            Image.fromarray(mask).save(os.path.join(d, "000001.png"))
        # a palette png: cv2 would expand it to colours, the port reads
        # its indices
        pal = Image.fromarray(rng.randint(0, 183, (5, 6)).astype(np.uint8),
                              mode="L").convert("P")
        pal.save(os.path.join(root, "annotations", "val2017", "000002.png"))
    root, new = run_both(tmp_path, make,
                         lambda r: ["dataset", "coco_stuff164k", r])
    assert len(new) == 3
    out = cv2.imread(os.path.join(root, "annotations", "train2017",
                                  "000001_labelTrainIds.png"),
                     cv2.IMREAD_UNCHANGED)
    assert out[0, 0] == 11 and out[1, 0] == 255


def test_coco_stuff10k(tmp_path):
    from scipy.io import savemat

    def make(root, rng):
        for sub in ("imageLists", "images", "annotations"):
            os.makedirs(os.path.join(root, sub))
        for lst, stems in (("train.txt", ["COCO_train2014_000000000077"]),
                           ("test.txt", ["COCO_train2014_000000000078",
                                         "COCO_train2014_000000000079"])):
            with open(os.path.join(root, "imageLists", lst), "w") as f:
                f.write("\n".join(stems) + "\n")
            for stem in stems:
                cv2.imwrite(os.path.join(root, "images", stem + ".jpg"),
                            _img(rng))
                savemat(os.path.join(root, "annotations", stem + ".mat"),
                        {"S": rng.randint(0, 183, (8, 8)).astype(np.uint16)})
    _, new = run_both(tmp_path, make, lambda r: [
        "dataset", "coco_stuff10k", r, "-o", os.path.join(r, "out")])
    assert len(new) == 6


def test_every_dataset_converter_is_registered():
    """The port's ``dataset`` subcommands are the JAX package's."""
    import argparse

    from peanut_tpu.cli import convert_datasets as jcd
    from peanut_tpu_torch.cli import convert_datasets as cd

    def names(mod):
        p = argparse.ArgumentParser()
        sub = p.add_subparsers()
        mod.register_subcommands(sub)
        return set(sub.choices)

    assert names(cd) == names(jcd) == {
        "chase_db1", "drive", "hrf", "stare", "pascal_context", "isaid",
        "potsdam", "vaihingen", "loveda", "coco_stuff10k", "coco_stuff164k"}
