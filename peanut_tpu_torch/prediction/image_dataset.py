"""Image and annotation-folder segmentation datasets (port of
``peanut_tpu.prediction.image_dataset``).

The reference's CustomDataset (prediction/mmseg/datasets/custom.py:19) is
the base of its bundled dataset classes: samples are (image, label map)
file pairs found by suffix under ``img_dir`` / ``ann_dir``; ``pre_eval``
computes each sample's intersection and union histograms and
``evaluate`` reduces them to mIoU / mDice / mFscore
(``prediction/metrics.py``).  ``ImageSegDataset`` keeps that contract,
and its seventeen registered subclasses bind the standard vocabularies
and file-name conventions (cityscapes.py, ade.py, voc.py, ...).

Host code: images load with cv2, imported inside the calls (the card's
machine may have none), into HWC numpy samples for a loader.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .class_names import get_classes
from .metrics import intersect_and_union, pre_eval_to_metrics


class ImageSegDataset:
    """CustomDataset-equivalent over parallel image/annotation folders."""

    CLASSES: Optional[Sequence[str]] = None
    PALETTE = None

    def __init__(self, data_root: str, img_dir: str = "img_dir",
                 ann_dir: str = "ann_dir", img_suffix: str = ".jpg",
                 seg_map_suffix: str = ".png", split: Optional[str] = None,
                 pipeline=None, reduce_zero_label: bool = False,
                 ignore_index: int = 255, classes=None, **unused):
        self.img_dir = os.path.join(data_root, img_dir)
        self.ann_dir = os.path.join(data_root, ann_dir) if ann_dir else None
        self.img_suffix = img_suffix
        self.seg_map_suffix = seg_map_suffix
        self.pipeline = pipeline
        self.reduce_zero_label = reduce_zero_label
        self.ignore_index = ignore_index
        if classes is not None:
            self.CLASSES = list(classes)
        if split:
            with open(os.path.join(data_root, split)) as f:
                stems = [ln.strip() for ln in f if ln.strip()]
        else:
            stems = sorted(
                fn[:-len(img_suffix)]
                for fn in os.listdir(self.img_dir)
                if fn.endswith(img_suffix))
        if not stems:
            raise FileNotFoundError(f"no {img_suffix} files in "
                                    f"{self.img_dir}")
        self.stems: List[str] = stems

    def __len__(self):
        return len(self.stems)

    @property
    def num_classes(self):
        return len(self.CLASSES) if self.CLASSES else 0

    def _imread(self, path, gray=False):
        import cv2
        flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if not gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

    def _seg_stem(self, stem: str) -> str:
        """Image-stem -> annotation-stem hook (identity for most datasets;
        iSAID inserts '_instance_color_RGB', isaid.py:67)."""
        return stem

    def get_gt_seg_map(self, idx: int) -> np.ndarray:
        gt = self._imread(os.path.join(
            self.ann_dir,
            self._seg_stem(self.stems[idx]) + self.seg_map_suffix),
            gray=True)
        gt = gt.astype(np.int64)
        if self.reduce_zero_label:  # custom.py semantics: 0 -> ignore
            gt[gt == 0] = self.ignore_index + 1
            gt = gt - 1
            gt[gt == self.ignore_index] = self.ignore_index
        return gt

    def __getitem__(self, idx: int):
        img = self._imread(os.path.join(
            self.img_dir, self.stems[idx] + self.img_suffix))
        sample = {"img": img.astype(np.float32),
                  "gt": self.get_gt_seg_map(idx) if self.ann_dir else None}
        if self.pipeline is not None:
            sample = self.pipeline(sample)
        return sample

    # -- evaluation protocol (custom.py pre_eval:277 / evaluate:388) --------

    def pre_eval(self, preds, indices):
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        return [intersect_and_union(
            np.asarray(p), self.get_gt_seg_map(i), self.num_classes,
            ignore_index=self.ignore_index)
            for p, i in zip(preds, indices)]

    def evaluate(self, results, metric="mIoU", **kw):
        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        return pre_eval_to_metrics(results, metrics=metrics)


# trainId -> official labelId (cityscapesscripts labels table) for
# submission-format result files (reference cityscapes.py format_results)
_CITYSCAPES_TRAINID_TO_LABELID = np.array(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32,
     33], np.uint8)


@DATASETS.register()
class CityscapesDataset(ImageSegDataset):
    CLASSES = tuple(get_classes("cityscapes"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", "_leftImg8bit.png")
        kw.setdefault("seg_map_suffix", "_gtFine_labelTrainIds.png")
        super().__init__(**kw)

    def format_results(self, results, imgfile_prefix, to_label_id=True,
                       indices=None):
        """Write predictions as labelId pngs for the official evaluator
        (reference cityscapes.py results2img)."""
        import cv2
        if indices is None:
            indices = list(range(len(results)))
        os.makedirs(imgfile_prefix, exist_ok=True)
        out = []
        for res, idx in zip(results, indices):
            res = np.asarray(res, np.uint8)
            if to_label_id:
                res = _CITYSCAPES_TRAINID_TO_LABELID[res]
            path = os.path.join(imgfile_prefix,
                                os.path.basename(self.stems[idx]) + ".png")
            cv2.imwrite(path, res)
            out.append(path)
        return out


@DATASETS.register()
class ADE20KDataset(ImageSegDataset):
    CLASSES = tuple(get_classes("ade20k"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".jpg")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", True)
        super().__init__(**kw)


@DATASETS.register()
class PascalVOCDataset(ImageSegDataset):
    CLASSES = tuple(get_classes("voc"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".jpg")
        kw.setdefault("seg_map_suffix", ".png")
        super().__init__(**kw)


@DATASETS.register(name="CustomDataset")
class CustomDataset(ImageSegDataset):
    """Registered under the reference's base name for config parity.
    (Concat/Repeat wrappers + OHEM sampler live in wrappers.py.)"""


# ---------------------------------------------------------------------------
# The rest of the reference's bundled dataset zoo (mmseg/datasets/*.py):
# each binds a vocabulary + the file-suffix convention onto the base class.
# ---------------------------------------------------------------------------

@DATASETS.register()
class ChaseDB1Dataset(ImageSegDataset):
    """chase_db1.py: 2-class retina vessels, '_1stHO.png' annotations."""
    CLASSES = tuple(get_classes("vessel"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", "_1stHO.png")
        kw.setdefault("reduce_zero_label", False)
        super().__init__(**kw)


@DATASETS.register()
class DRIVEDataset(ImageSegDataset):
    """drive.py: 2-class retina vessels, '_manual1.png' annotations."""
    CLASSES = tuple(get_classes("vessel"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", "_manual1.png")
        kw.setdefault("reduce_zero_label", False)
        super().__init__(**kw)


@DATASETS.register()
class HRFDataset(ImageSegDataset):
    """hrf.py: 2-class retina vessels, same-name '.png' annotations."""
    CLASSES = tuple(get_classes("vessel"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", False)
        super().__init__(**kw)


@DATASETS.register()
class STAREDataset(ImageSegDataset):
    """stare.py: 2-class retina vessels, '.ah.png' annotations."""
    CLASSES = tuple(get_classes("vessel"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", ".ah.png")
        kw.setdefault("reduce_zero_label", False)
        super().__init__(**kw)


@DATASETS.register()
class PascalContextDataset(ImageSegDataset):
    """pascal_context.py: 60 classes incl. background; split file driven."""
    CLASSES = tuple(get_classes("pascal_context"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".jpg")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", False)
        super().__init__(**kw)


@DATASETS.register()
class PascalContextDataset59(ImageSegDataset):
    """pascal_context.py:66: 59 classes, background folded into ignore."""
    CLASSES = tuple(get_classes("pascal_context59"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".jpg")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", True)
        super().__init__(**kw)


@DATASETS.register()
class COCOStuffDataset(ImageSegDataset):
    """coco_stuff.py: 171 classes; '_labelTrainIds.png' annotations
    (reduce_zero_label True for the 10k layout, False for 164k — set per
    config, as in the reference)."""
    CLASSES = tuple(get_classes("cocostuff"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".jpg")
        kw.setdefault("seg_map_suffix", "_labelTrainIds.png")
        super().__init__(**kw)


@DATASETS.register()
class LoveDADataset(ImageSegDataset):
    """loveda.py: 7 classes, reduce_zero_label, png/png."""
    CLASSES = tuple(get_classes("loveda"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", True)
        super().__init__(**kw)

    def format_results(self, results, imgfile_prefix, indices=None):
        """Write raw 0..6 prediction pngs for the official LoveDA server
        (reference loveda.py results2img)."""
        import cv2
        if indices is None:
            indices = list(range(len(results)))
        os.makedirs(imgfile_prefix, exist_ok=True)
        out = []
        for res, idx in zip(results, indices):
            path = os.path.join(imgfile_prefix,
                                os.path.basename(self.stems[idx]) + ".png")
            cv2.imwrite(path, np.asarray(res, np.uint8))
            out.append(path)
        return out


@DATASETS.register()
class PotsdamDataset(ImageSegDataset):
    """potsdam.py: ISPRS 6 classes, reduce_zero_label."""
    CLASSES = tuple(get_classes("potsdam"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", True)
        super().__init__(**kw)


@DATASETS.register()
class ISPRSDataset(ImageSegDataset):
    """isprs.py (Vaihingen): ISPRS 6 classes, reduce_zero_label."""
    CLASSES = tuple(get_classes("vaihingen"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("reduce_zero_label", True)
        super().__init__(**kw)


@DATASETS.register()
class iSAIDDataset(ImageSegDataset):
    """isaid.py: 16 classes; annotations named
    '<stem>_instance_color_RGB.png' next to '<stem>.png' images."""
    CLASSES = tuple(get_classes("isaid"))

    def __init__(self, **kw):
        kw.setdefault("img_suffix", ".png")
        kw.setdefault("seg_map_suffix", ".png")
        kw.setdefault("ignore_index", 255)
        super().__init__(**kw)

    def _seg_stem(self, stem):
        return stem + "_instance_color_RGB"


@DATASETS.register()
class DarkZurichDataset(CityscapesDataset):
    """dark_zurich.py: cityscapes vocabulary over '_rgb_anon.png' images."""

    def __init__(self, **kw):
        kw.setdefault("img_suffix", "_rgb_anon.png")
        kw.setdefault("seg_map_suffix", "_gt_labelTrainIds.png")
        super().__init__(**kw)


@DATASETS.register()
class NightDrivingDataset(CityscapesDataset):
    """night_driving.py: cityscapes vocabulary, gtCoarse annotations."""

    def __init__(self, **kw):
        kw.setdefault("img_suffix", "_leftImg8bit.png")
        kw.setdefault("seg_map_suffix", "_gtCoarse_labelTrainIds.png")
        super().__init__(**kw)
