"""Semantic-map dataset, augmentations and batching for prediction
training (port of ``peanut_tpu.prediction.dataset``).

Each saved episode .npz holds a (20, 14, H, W) uint8 sequence of map
snapshots; the first 10 timesteps become partial-map inputs and the target
is the final map's 6 goal-category channels masked to the regions
unexplored at the input timestep (the reference's SemMapDataset and
LoadMapFromFile).  Samples are HWC numpy; the train step uploads them and
transposes to NCHW once (``prediction.train``).

The augmentation recipe (pred_model_cfg.py:47-56): Pad to 1.25x with zeros
-> RandomCrop to the map size -> RandomFlip 0.5 -> RandomRotate +-180 deg
(bilinear for the input, nearest for the target).  ``FusedAugment`` runs
it in one native pass (``native.augment_sample``), the trainer's route: the
card's machine has no cv2.  The python chain (``cv2.warpAffine``) is its
plain twin.  Both draw from the ``np.random.RandomState`` they are given in
the JAX package's order, so a seeded run's samples are the JAX package's
byte for byte.  ``GlobalShardedLoader`` (multi-process batches) is ROADMAP
A14.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import numpy as np

NUM_TARGET_CATEGORIES = 6
GOAL_CHANNELS = slice(4, 4 + NUM_TARGET_CATEGORIES)
NUM_INPUT_TIMESTEPS = 10


def _read_maps(path: str) -> np.ndarray:
    maps = np.load(path)
    return maps["maps"] if path.endswith("z") else maps


def load_map_sample(path: str, t_idx: int, maps=None,
                    use_native: bool = True) -> Dict[str, np.ndarray]:
    """LoadMapFromFile: {"img": (H, W, 14) float32 in [0, 1], "gt": (H, W,
    6) float32 in [0, 255]} of timestep ``t_idx``; ``use_native`` through
    the native kernel, else numpy (the same bytes)."""
    if maps is None:
        maps = _read_maps(path)
    if use_native:
        from . import native
        img, gt = native.extract_timestep(maps, t_idx)
        return {"img": img, "gt": gt}
    img = maps[t_idx].transpose(1, 2, 0).astype(np.float32) / 255.0
    explored = img[:, :, 1] > 0
    gt = (maps[-1, GOAL_CHANNELS] * (1 - explored)).transpose(1, 2, 0)
    return {"img": img, "gt": gt.astype(np.float32)}


class SemMapDataset:
    """(file, t_idx) pairs, 10 samples an episode file, with a small LRU
    cache of decompressed episodes (grouped access decodes a file once)."""

    def __init__(self, data_root: str, img_dir: str = "train",
                 pipeline=None, decode_cache: int = 4,
                 use_native: bool = True):
        self.dir = os.path.join(data_root, img_dir)
        self.pipeline = pipeline
        self.use_native = use_native
        files = sorted(f for f in os.listdir(self.dir)
                       if f.endswith(".npz") or f.endswith(".npy"))
        self.samples: List[Tuple[str, int]] = [
            (os.path.join(self.dir, f), t)
            for f in files for t in range(NUM_INPUT_TIMESTEPS)]
        if not self.samples:
            raise FileNotFoundError(f"no map files under {self.dir}")
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_size = decode_cache
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.samples)

    def _load_maps(self, path: str) -> np.ndarray:
        with self._cache_lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
        maps = _read_maps(path)
        with self._cache_lock:
            self._cache[path] = maps
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return maps

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        path, t_idx = self.samples[i]
        sample = load_map_sample(path, t_idx, maps=self._load_maps(path),
                                 use_native=self.use_native)
        if self.pipeline is not None:
            sample = self.pipeline(sample)
        return sample


# ----------------------------------------------------------------------
# Augmentations
# ----------------------------------------------------------------------

class Pad:
    """Zero-pad bottom/right to a fixed size (mmcv Pad)."""

    def __init__(self, size: Tuple[int, int], pad_val: float = 0.0):
        self.size = size
        self.pad_val = pad_val

    def __call__(self, s):
        for key in ("img", "gt"):
            x = s[key]
            ph = max(0, self.size[0] - x.shape[0])
            pw = max(0, self.size[1] - x.shape[1])
            s[key] = np.pad(x, ((0, ph), (0, pw), (0, 0)),
                            constant_values=self.pad_val)
        return s


class RandomCrop:
    def __init__(self, crop_size: Tuple[int, int], rng=None):
        self.crop = crop_size
        self.rng = rng or np.random

    def __call__(self, s):
        h, w = s["img"].shape[:2]
        ch, cw = self.crop
        y = self.rng.randint(0, max(h - ch, 0) + 1)
        x = self.rng.randint(0, max(w - cw, 0) + 1)
        for key in ("img", "gt"):
            s[key] = s[key][y:y + ch, x:x + cw]
        return s


class RandomFlip:
    def __init__(self, prob: float = 0.5, rng=None):
        self.prob = prob
        self.rng = rng or np.random

    def __call__(self, s):
        if self.rng.rand() < self.prob:
            for key in ("img", "gt"):
                s[key] = s[key][:, ::-1].copy()
        return s


class RandomRotate:
    """Rotate by a uniform angle in [-degree, degree] about the centre
    (cv2.warpAffine: bilinear for img, nearest for the target)."""

    def __init__(self, prob: float = 1.0, degree: float = 180.0,
                 pad_val: float = 0.0, rng=None):
        self.prob = prob
        self.degree = degree
        self.pad_val = pad_val
        self.rng = rng or np.random

    def __call__(self, s):
        import cv2

        if self.rng.rand() >= self.prob:
            return s
        angle = self.rng.uniform(-self.degree, self.degree)
        h, w = s["img"].shape[:2]
        m = cv2.getRotationMatrix2D(((w - 1) * 0.5, (h - 1) * 0.5), angle,
                                    1.0)
        s["img"] = cv2.warpAffine(s["img"], m, (w, h),
                                  flags=cv2.INTER_LINEAR,
                                  borderValue=self.pad_val).reshape(h, w, -1)
        s["gt"] = cv2.warpAffine(s["gt"], m, (w, h),
                                 flags=cv2.INTER_NEAREST,
                                 borderValue=self.pad_val).reshape(h, w, -1)
        return s


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, s):
        for t in self.transforms:
            s = t(s)
        return s


class FusedAugment:
    """Pad -> RandomCrop -> RandomFlip -> RandomRotate in one native pass,
    drawing its random numbers in the python chain's order."""

    def __init__(self, map_size: int, rng=None):
        self.map_size = map_size
        self.pad = int(map_size * 1.25)
        self.rng = rng or np.random

    def __call__(self, s):
        from . import native

        h, w = s["img"].shape[:2]
        ph, pw = max(self.pad, h), max(self.pad, w)
        crop_y = self.rng.randint(0, max(ph - self.map_size, 0) + 1)
        crop_x = self.rng.randint(0, max(pw - self.map_size, 0) + 1)
        flip = self.rng.rand() < 0.5
        do_rot = self.rng.rand() < 1.0       # prob 1.0 in the recipe
        angle = self.rng.uniform(-180.0, 180.0) if do_rot else 0.0
        s["img"], s["gt"] = native.augment_sample(
            s["img"], s["gt"], self.map_size, crop_y, crop_x, flip, angle)
        return s


def training_pipeline(map_size: int = 960, rng=None,
                      use_native: bool = True) -> Compose:
    """The reference training recipe: the native fused pass, or with
    ``use_native=False`` the python chain (needs cv2)."""
    if use_native:
        return Compose([FusedAugment(map_size, rng=rng)])
    return Compose([
        Pad((int(map_size * 1.25), int(map_size * 1.25))),
        RandomCrop((map_size, map_size), rng=rng),
        RandomFlip(0.5, rng=rng),
        RandomRotate(1.0, 180.0, rng=rng),
    ])


# ----------------------------------------------------------------------
# Batching with background prefetch
# ----------------------------------------------------------------------

class PrefetchLoader:
    """Shuffling, epoch-looping batch iterator with worker threads.

    A producer thread deals batches of indices from each epoch's
    permutation (``np.random.RandomState(seed)``); ``num_workers`` threads
    load and stack them into a bounded queue.  With ``num_shards`` > 1,
    every shard draws the same permutation, pads it by wraparound to a
    multiple of the shard count and takes ``order[shard_id::num_shards]``
    (DistributedSampler), so shards see disjoint streams whose union per
    epoch is the dataset.  ``batch_size`` is the shard's.  With one worker
    the batches come in the permutation's order.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 4, queue_depth: int = 4,
                 num_shards: int = 1, shard_id: int = 0):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if batch_size < 1 or num_workers < 1:
            raise ValueError(f"batch_size and num_workers >= 1, got "
                             f"{batch_size}, {num_workers}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self.num_shards = num_shards
        self.shard_id = shard_id

    def _epoch_order(self, rng) -> np.ndarray:
        order = rng.permutation(len(self.dataset))
        if self.num_shards > 1:
            total = -(-len(order) // self.num_shards) * self.num_shards
            if total > len(order):
                order = np.concatenate([order, order[:total - len(order)]])
            order = order[self.shard_id::self.num_shards]
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        out_q: "queue.Queue" = queue.Queue(self.queue_depth)
        idx_q: "queue.Queue" = queue.Queue(self.queue_depth)
        stop = threading.Event()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            while not stop.is_set():
                order = self._epoch_order(rng)
                for start in range(0, len(order) - self.batch_size + 1,
                                   self.batch_size):
                    if not put(idx_q, order[start:start + self.batch_size]):
                        return

        def worker():
            while not stop.is_set():
                try:
                    idxs = idx_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    samples = [self.dataset[int(i)] for i in idxs]
                    batch = {k: np.stack([s[k] for s in samples])
                             for k in samples[0]}
                except Exception as e:      # reported to the consumer
                    batch = e
                if not put(out_q, batch):
                    return

        threads = [threading.Thread(target=producer, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                batch = out_q.get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
