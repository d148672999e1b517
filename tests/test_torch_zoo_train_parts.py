"""The zoo's training library in the port against the JAX package, on the
CPU: the vocabularies, the focal and Lovász losses, OHEM, the dataset
wrappers, the extra transforms and test-time augmentation, the image
datasets and the layer-decay optimizer.

Tolerances:
* ``class_names``: equal for every alias;
* ``FocalLoss`` / ``LovaszLoss``: values in float32 within 1e-6
  relative; values and gradients in float64 (``jax.enable_x64``) within
  1e-6 of the largest |value|, on logits with many ties (so the Lovász
  sort meets tied errors);
* ``ohem_pixel_weights`` and STDC's detail target: bit-equal;
* ``ConcatDataset`` / ``RepeatDataset`` / ``MultiImageMixDataset``: the
  same samples at every index, byte-equal;
* the eleven transforms and ``MultiScaleFlipAug``: byte-equal under the
  same ``np.random.RandomState`` seed, several draws each (cv2 on both
  sides);
* ``aug_inference``: float64 on both sides, a seeded FCN (SHRINK widths)
  at three scales with flips, within 1e-10 of the largest |logit|;
* ``ImageSegDataset`` on a synthetic png folder: samples byte-equal,
  ``pre_eval`` and ``evaluate`` equal, the named datasets' label maps
  (``reduce_zero_label``) equal, Cityscapes' ``format_results`` files
  byte-equal;
* the layer-decay optimizer: the learning-rate scale and the no-decay
  choice of every parameter equal to the JAX package's through the name
  map (``flax_to_torch_state``), for UPerNet-ViT (layer-wise) and
  UPerNet-ConvNeXt (stage-wise), the narrow configs of
  ``test_torch_zoo_train.py``; two AdamW steps against optax's, in
  float64, within 1e-6 of each tensor's largest update.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu.models import losses_extra as jlosses_extra
from peanut_tpu.prediction import class_names as jclass_names
from peanut_tpu.prediction import image_dataset as jimage_dataset
from peanut_tpu.prediction import optimizers as joptimizers
from peanut_tpu.prediction import transforms_extra as jtransforms
from peanut_tpu.prediction import wrappers as jwrappers
from peanut_tpu.registry import DATASETS as JDATASETS
from peanut_tpu_torch.models import losses_extra
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state
from peanut_tpu_torch.prediction import (class_names, image_dataset,
                                         optimizers, transforms_extra,
                                         wrappers)
from peanut_tpu_torch.registry import DATASETS
from torch_zoo_support import (TRAIN_CHANNELS, carry, family_config,
                               jax_and_port, random_variables, randomize,
                               rel_err, train_case_configs)
from torch_zoo_support import narrow_convnext  # noqa: F401  (fixture)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


def test_class_names_equal_for_every_dataset():
    for alias in jclass_names._ALIASES:
        assert class_names.get_classes(alias) == (
            jclass_names.get_classes(alias)), alias
    assert set(class_names._ALIASES) == set(jclass_names._ALIASES)
    with pytest.raises(KeyError):
        class_names.get_classes("nope")


# ---- losses and OHEM ----------------------------------------------------

def _tied_logits(seed, shape=(2, 8, 8, 4)):
    """NHWC logits on a grid of 0.5 (many ties), labels with ignored
    pixels."""
    rng = np.random.RandomState(seed)
    pred = np.round(rng.randn(*shape) * 2) / 2
    target = rng.randint(0, shape[-1], shape[:-1])
    target[0, 0, :3] = 255
    return pred, target


@pytest.mark.parametrize("name,kw", [
    ("FocalLoss", {}), ("FocalLoss", dict(gamma=1.5, alpha=0.4,
                                          reduction="sum")),
    ("LovaszLoss", {}), ("LovaszLoss", dict(loss_weight=0.5))])
def test_extra_losses_values_and_gradients(name, kw):
    pred, target = _tied_logits(0)
    jl = getattr(jlosses_extra, name)(**kw)
    tl = getattr(losses_extra, name)(**kw)
    want = float(jl(jnp.asarray(pred, jnp.float32), jnp.asarray(target)))
    got = float(tl(torch.as_tensor(pred.transpose(0, 3, 1, 2),
                                   dtype=torch.float32),
                   torch.as_tensor(target)))
    assert got == pytest.approx(want, rel=1e-6)
    with jax.enable_x64(True):
        jv, jg = jax.value_and_grad(lambda p: jl(p, jnp.asarray(target)))(
            jnp.asarray(pred))
        jv, jg = float(jv), np.asarray(jg)
    x = torch.tensor(pred.transpose(0, 3, 1, 2), requires_grad=True)
    v = tl(x, torch.as_tensor(target))
    v.backward()
    assert float(v.detach()) == pytest.approx(jv, rel=1e-6)
    assert rel_err(x.grad.numpy().transpose(0, 2, 3, 1), jg) <= 1e-6


@pytest.mark.parametrize("min_kept,thresh", [(40, 0.7), (10_000, 0.7),
                                             (90, 0.05)])
def test_ohem_pixel_weights_bit_equal(min_kept, thresh):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 12, 16, 5).astype(np.float32) * 3
    target = rng.randint(0, 5, (2, 12, 16))
    target[1, :2] = 255
    want = np.asarray(jwrappers.ohem_pixel_weights(
        jnp.asarray(logits), jnp.asarray(target), thresh, min_kept))
    got = wrappers.ohem_pixel_weights(
        torch.as_tensor(logits.transpose(0, 3, 1, 2)),
        torch.as_tensor(target), thresh, min_kept).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_stdc_detail_target_equal():
    """STDC's Laplacian boundary target of a label map (the detail head's
    training target), bit-equal."""
    from peanut_tpu.models.heads_zoo import STDCHead as JSTDCHead
    from peanut_tpu_torch.models.heads_zoo import STDCHead
    gt = np.random.RandomState(2).randint(0, 4, (2, 12, 16))
    gt[0, :4] = 1
    for thr in (0.1, 3.0):
        want = np.asarray(JSTDCHead.detail_target(jnp.asarray(gt), thr))
        got = STDCHead.detail_target(torch.as_tensor(gt), thr).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---- wrappers and transforms --------------------------------------------

def _sample(seed, h=30, w=50, c=3):
    rng = np.random.RandomState(seed)
    return {"img": (rng.rand(h, w, c) * 255).astype(np.float32),
            "gt": rng.randint(0, 4, (h, w)).astype(np.uint8)}


class ListDataset:
    def __init__(self, n, seed):
        self.samples = [_sample(seed + i, 20 + 2 * i, 24 + 3 * i)
                        for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_dataset_wrappers_match_jax():
    a, b = ListDataset(3, 0), ListDataset(2, 10)
    pairs = [(jwrappers.ConcatDataset([a, b]), wrappers.ConcatDataset([a, b])),
             (jwrappers.RepeatDataset(b, 3), wrappers.RepeatDataset(b, 3))]
    for jd, td in pairs:
        assert len(td) == len(jd)
        for i in range(len(jd)):
            _assert_same(td[i], jd[i])

    def mix(wrap, trans, skip=None):
        mosaic = trans.RandomMosaic(prob=1.0, img_scale=(16, 20),
                                    rng=np.random.RandomState(4))
        return wrap.MultiImageMixDataset(a, [mosaic], skip_types=skip)

    for skip in (None, ["RandomMosaic"]):
        jd = mix(jwrappers, jtransforms, skip)
        td = mix(wrappers, transforms_extra, skip)
        for i in (0, 2, 1, 0):
            got, want = td[i], jd[i]
            assert "mix_results" not in got
            _assert_same(got, want)
    for name in ("ConcatDataset", "RepeatDataset", "MultiImageMixDataset"):
        assert DATASETS.get(name) is getattr(wrappers, name)


# (class name, kwargs, takes rng)
TRANSFORMS = [
    ("Resize", dict(img_scale=(20, 30), keep_ratio=True), False),
    ("Resize", dict(img_scale=(24, 40), keep_ratio=False), False),
    ("Resize", dict(img_scale=(24, 40), ratio_range=(0.5, 2.0)), True),
    ("Normalize", dict(mean=(123.7, 116.3, 103.5), std=(58.4, 57.1, 57.4),
                       to_rgb=True), False),
    ("PhotoMetricDistortion", {}, True),
    ("ResizeToMultiple", dict(size_divisor=16), False),
    ("Rerange", dict(min_value=-1, max_value=2), False),
    ("CLAHE", dict(clip_limit=20.0, tile_grid_size=(4, 4)), False),
    ("RGB2Gray", dict(out_channels=2), False),
    ("AdjustGamma", dict(gamma=1.7), False),
    ("SegRescale", dict(scale_factor=0.5), False),
    ("RandomCutOut", dict(prob=0.7, n_holes=(1, 3),
                          cutout_shape=[(4, 4), (8, 6)], seg_fill_in=255),
     True),
    ("RandomCutOut", dict(prob=1.0, n_holes=2, cutout_ratio=[(0.2, 0.3)],
                          fill_in=(1, 2, 3)), True),
    ("RandomMosaic", dict(prob=0.8, img_scale=(16, 20)), True),
    ("MultiScaleFlipAug", dict(img_ratios=(0.5, 1.0, 1.5), flip=True),
     False),
]


@pytest.mark.parametrize("name,kw,seeded", TRANSFORMS,
                         ids=[f"{t[0]}{i}" for i, t in enumerate(TRANSFORMS)])
def test_transforms_byte_equal_to_jax(name, kw, seeded):
    pytest.importorskip("cv2")
    made = []
    for pkg in (jtransforms, transforms_extra):
        extra = dict(rng=np.random.RandomState(7)) if seeded else {}
        made.append(getattr(pkg, name)(**kw, **extra))
    jt, tt = made
    for seed in range(4):
        sample = _sample(seed)
        if name == "RandomMosaic":
            sample["mix_results"] = [_sample(10 + j, 18 + j, 26)
                                     for j in range(3)]
        want = jt(copy.deepcopy(sample))
        got = tt(copy.deepcopy(sample))
        _assert_same(got, want)


def test_aug_inference_matches_jax():
    jm, v, pm, x = jax_and_port(family_config("fcn"), (32, 48))
    scales = (0.75, 1.0, 1.25)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda v, x: jtransforms.aug_inference(
            jm, v, x, scales=scales, flip=True))(v, x))
    got = transforms_extra.aug_inference(pm, x, scales=scales, flip=True)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert rel_err(got.numpy(), want) <= 1e-10
    # one scale, no flip: the model's own inference
    one = transforms_extra.aug_inference(pm, x, scales=(1.0,), flip=False)
    with torch.no_grad():
        assert torch.equal(one, pm.inference(torch.as_tensor(x)))


# ---- image datasets ------------------------------------------------------

@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(2)
    for d in ("img_dir", "ann_dir"):
        os.makedirs(root / d)
    for i in range(3):
        cv2.imwrite(str(root / "img_dir" / f"s{i}_leftImg8bit.png"),
                    (rng.rand(12, 16, 3) * 255).astype(np.uint8))
        cv2.imwrite(str(root / "ann_dir" / f"s{i}_gtFine_labelTrainIds.png"),
                    rng.randint(0, 5, (12, 16)).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("name,kw", [
    ("CustomDataset", dict(img_suffix="_leftImg8bit.png",
                           seg_map_suffix="_gtFine_labelTrainIds.png",
                           classes=list("abcde"))),
    ("CityscapesDataset", {}),
    ("ADE20KDataset", dict(img_suffix="_leftImg8bit.png",
                           seg_map_suffix="_gtFine_labelTrainIds.png"))])
def test_image_datasets_match_jax(png_root, tmp_path, name, kw):
    jd = JDATASETS.get(name)(data_root=png_root, **kw)
    td = DATASETS.get(name)(data_root=png_root, **kw)
    assert type(td).__module__ == image_dataset.__name__
    assert len(td) == len(jd) == 3 and td.CLASSES == jd.CLASSES
    for i in range(3):
        _assert_same(td[i], jd[i])
        np.testing.assert_array_equal(td.get_gt_seg_map(i),
                                      jd.get_gt_seg_map(i))
    rng = np.random.RandomState(3)
    preds = [rng.randint(0, 5, (12, 16)) for _ in range(3)]
    want = jd.pre_eval(preds, [0, 1, 2])
    got = td.pre_eval(preds, [0, 1, 2])
    _assert_same(got, want)
    metrics = ["mIoU", "mDice", "mFscore"]
    _assert_same(dict(td.evaluate(got, metric=metrics)),
                 dict(jd.evaluate(want, metric=metrics)))
    if name == "CityscapesDataset":
        preds8 = [p.astype(np.uint8) for p in preds]
        files = [d.format_results(preds8, str(tmp_path / tag))
                 for d, tag in ((jd, "j"), (td, "t"))]
        for a, b in zip(*files):
            assert os.path.basename(a) == os.path.basename(b)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()


def test_named_datasets_registered_as_in_jax():
    named = [k for k in JDATASETS.keys()
             if isinstance(JDATASETS.get(k), type)
             and issubclass(JDATASETS.get(k), jimage_dataset.ImageSegDataset)]
    assert len(named) == 17
    for k in named:
        cls = DATASETS.get(k)
        assert issubclass(cls, image_dataset.ImageSegDataset), k
        assert cls.CLASSES == JDATASETS.get(k).CLASSES, k
    assert "SemMapDataset" in DATASETS


# ---- the layer-decay optimizer ---------------------------------------------

def _jax_tree_to_port(tree, variables, model):
    """A per-leaf python value of the JAX params tree as {port name:
    value}, through ``flax_to_torch_state``'s name map (each leaf a full
    float64 array of its value, read back at one element)."""
    full = jax.tree_util.tree_map(
        lambda val, leaf: np.full(np.shape(leaf), float(val)),
        tree, variables["params"])
    sd = flax_to_torch_state({"params": full,
                              "batch_stats": variables["batch_stats"]},
                             model)
    return {n: float(sd[n].reshape(-1)[0])
            for n, _ in model.named_parameters()}


def _narrow(family):
    """The JAX model, its seeded float64 variables and the port's model
    of a narrow ``TRAIN_CASES`` config (14 input channels)."""
    jcfg, pcfg = train_case_configs(family)
    jm = jbuild(jcfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 32, 32, TRAIN_CHANNELS)), train=False, with_aux=True))
    v = randomize(v, np.random.RandomState(5), np.float64)
    return jm, v, carry(v, build_segmentor(pcfg))


@pytest.mark.usefixtures("narrow_convnext")
@pytest.mark.parametrize("family,decay_type,num_layers", [
    ("upernet_vit", "layer_wise", 4), ("upernet_convnext", "stage_wise", 6)])
def test_layer_decay_scales_and_groups_match_jax(family, decay_type,
                                                 num_layers):
    _, v, model = _narrow(family)
    rate = 0.65
    want = _jax_tree_to_port(joptimizers.layer_decay_scales(
        v["params"], rate, num_layers, decay_type), v, model)
    got = optimizers.layer_decay_scales(model, rate, num_layers, decay_type)
    assert got == want
    assert len(set(got.values())) >= 4
    mask = jax.tree_util.tree_map_with_path(
        lambda path, leaf: not joptimizers._is_no_decay(
            joptimizers._path_names(path), leaf), v["params"])
    want_decay = _jax_tree_to_port(mask, v, model)
    opt = optimizers.make_layer_decay_optimizer(
        model, 1e-3, decay_rate=rate, num_layers=num_layers,
        decay_type=decay_type)
    seen = {}
    for group in opt.param_groups:
        for p in group["params"]:
            seen[id(p)] = (group["lr_scale"], group["weight_decay"] > 0)
    for name, p in model.named_parameters():
        assert seen[id(p)] == (want[name], bool(want_decay[name])), name
    assert 0 < sum(want_decay.values()) < len(want_decay)


@pytest.mark.usefixtures("narrow_convnext")
@pytest.mark.parametrize("family,decay_type", [
    ("upernet_vit", "layer_wise"), ("upernet_convnext", "stage_wise")])
def test_layer_decay_adamw_steps_match_optax(family, decay_type):
    _, v, model = _narrow(family)

    def sched(step):
        return 1e-3 * (1.0 - step / 10)

    rng = np.random.RandomState(6)
    grads = [jax.tree_util.tree_map(lambda p: rng.randn(*np.shape(p)),
                                    v["params"]) for _ in range(2)]
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        tx = joptimizers.make_layer_decay_optimizer(
            params, sched, decay_rate=0.7, num_layers=6,
            decay_type=decay_type)
        st = tx.init(params)
        update = jax.jit(tx.update)
        updates = []
        for g in grads:
            u, st = update(jax.tree_util.tree_map(jnp.asarray, g), st,
                           params)
            params = optax.apply_updates(params, u)
            updates.append(jax.tree_util.tree_map(np.asarray, u))
    opt = optimizers.make_layer_decay_optimizer(
        model, sched, decay_rate=0.7, num_layers=6, decay_type=decay_type)
    for g, u in zip(grads, updates):
        g_port = flax_to_torch_state({"params": g,
                                      "batch_stats": v["batch_stats"]}, model)
        u_port = flax_to_torch_state({"params": u,
                                      "batch_stats": v["batch_stats"]}, model)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.as_tensor(g_port[n])
        opt.step()
        for n, p in model.named_parameters():
            w = u_port[n]
            np.testing.assert_allclose(
                (p.detach() - before[n]).numpy(), w, rtol=1e-6,
                atol=1e-6 * np.abs(w).max(), err_msg=n)
    assert opt.count() == 2
