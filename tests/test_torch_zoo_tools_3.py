"""The timm adapter and the analysis tools of the port (ROADMAP A13 part
6) against the JAX package's, on the CPU: ``TIMMBackbone`` for four timm
names in float64 (within 1e-9 of the largest output) and its two
NotImplementedErrors; ``cli.tools`` print_config, analyze_logs and
browse_dataset print the JAX package's text (and write its previews);
confusion_matrix on tests/test_image_dataset.py's fixture with the same
weights as a ``.pth`` gives JAX's matrix but at pixels whose two largest
logits lie within 1e-5 of each other; collect_env imports no JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from peanut_tpu.cli import tools as jtools
from peanut_tpu.registry import BACKBONES as JBACKBONES
import peanut_tpu.models.backbones_zoo  # noqa: F401  (registers)
import peanut_tpu.prediction  # noqa: F401  (registers the datasets)
from peanut_tpu_torch.cli import tools
from peanut_tpu_torch.models import timm_adapter
from peanut_tpu_torch.registry import BACKBONES

from test_image_dataset import pseudo_dataset  # noqa: F401
from torch_zoo_support import (REPO, carried_module, jax64,  # noqa: F401
                               one_thread, random_variables, randomize,
                               rel_err)

TIMM_CASES = {
    "resnet18": dict(base_channels=8, stem_channels=8),
    # 32 groups of base width 4 have no channel at base 8: 4 groups of 32
    "resnext50_32x4d": dict(base_channels=8, stem_channels=8, groups=4,
                            base_width=32),
    "mobilenetv2_100": dict(widen_factor=0.25),
    "mobilenetv3_small_100": {},
}


@pytest.mark.parametrize("name", sorted(TIMM_CASES))
def test_timm_backbone_matches_jax(name):
    extra = TIMM_CASES[name]
    jm = JBACKBONES.get("TIMMBackbone")(model_name=name, extra=extra)
    tm = BACKBONES.get("TIMMBackbone")(model_name=name, extra=extra)
    x = np.random.RandomState(0).rand(1, 32, 32, 3)
    v = carried_module(jm, tm, x, train=False)
    want = jax64(jm, v, x, train=False)
    with torch.no_grad():
        got = tm(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == len(tm.out_channels)
    for g, w, c in zip(got, want, tm.out_channels):
        assert g.dtype == torch.float64 and g.shape[1] == c
        assert rel_err(g.permute(0, 2, 3, 1).numpy(), w) <= 1e-9


def test_timm_backbone_builds_in_a_segmentor():
    """FCN over U-Net's config with the timm adapter's ResNet-18 as its
    backbone: the flax name ``model`` holds the inner ResNet, whose
    parameters keep mmseg's names."""
    from peanut_tpu_torch.core.config_file import load_config
    from peanut_tpu_torch.models.builder import build_segmentor
    cfg = load_config(os.path.join(REPO, "configs", "unet",
                                   "fcn_unet.py"))["model"]
    cfg["backbone"] = dict(type="TIMMBackbone", model_name="resnet18")
    cfg["decode_head"].update(in_channels=512, in_index=3)
    model = build_segmentor(cfg, seed=0)
    assert "backbone.model.layer4.1.conv2.weight" in model.state_dict()
    with torch.no_grad():
        out = model.inference(torch.rand(1, 64, 64, 3))
    assert out.shape == (1, 64, 64, 2) and bool(torch.isfinite(out).all())


def _raised(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


def test_timm_backbone_raises_as_the_jax_adapter_does():
    x = jax.numpy.zeros((1, 32, 32, 3))

    def jinit(**kw):
        return lambda: JBACKBONES.get("TIMMBackbone")(**kw).init(
            jax.random.PRNGKey(0), x)

    def tinit(**kw):
        return lambda: BACKBONES.get("TIMMBackbone")(**kw)

    known = f"available: {sorted(timm_adapter._NATIVE_EQUIV)}"
    want = _raised(jinit(model_name="efficientnet_b0"))
    got = _raised(tinit(model_name="efficientnet_b0"))
    assert got.split(". (")[0] == want.split(". (")[0]
    assert known in got and "'efficientnet_b0'" in got
    for name in ("mobilenetv2_100", "mobilenetv3_large_100"):
        assert _raised(tinit(model_name=name, in_channels=14)) == \
            _raised(jinit(model_name=name, in_channels=14))


def _both(argv, capsys, **port_kw):
    jtools.main(argv)
    want = capsys.readouterr().out
    tools.main(argv, **port_kw)
    got = capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("config", [
    "unet/fcn_unet.py", "convnext/upernet_convnext_512x512_160k_ade20k.py",
    "pspnet/peanut_prediction.py",
    "swin/upernet_swin-t_512x512_160k_ade20k.py"])
def test_print_config_prints_the_jax_text(config, capsys):
    got, want = _both(["print_config", os.path.join(REPO, "configs", config)],
                      capsys)
    assert got == want and "EncoderDecoder" in got


@pytest.mark.parametrize("extra", [["--curve"], ["--keys", "loss"], []])
def test_analyze_logs_prints_the_jax_text(extra, tmp_path, capsys):
    log = tmp_path / "log.jsonl"
    with open(log, "w") as f:
        for i in range(13):
            f.write(json.dumps({"iter": i, "loss": 1.0 / (i + 1),
                                "lr": 5e-4 * (1 - i / 13),
                                "mode": "train"}) + "\n")
    got, want = _both(["analyze_logs", str(log)] + extra, capsys)
    assert got == want and "loss: first=1" in got


def test_browse_dataset_prints_as_jax_and_draws(pseudo_dataset, tmp_path,
                                                capsys):
    """The text equals JAX's.  The previews: the image scaled to 0-255
    beside the labels scaled to 0-255 (the JAX walker's drawing, which
    calls ``ndarray.ptp``, gone in numpy 2, on a float image)."""
    import cv2
    from peanut_tpu_torch.prediction.image_dataset import CustomDataset
    got, want = _both(["browse_dataset", pseudo_dataset, "--max_samples",
                       "2"], capsys)
    assert got == want and "(showing 2)" in got
    out = tmp_path / "port"
    tools.main(["browse_dataset", pseudo_dataset, "--max_samples", "2",
                "--out_dir", str(out)])
    assert capsys.readouterr().out == got
    assert sorted(os.listdir(out)) == ["sample_0.png", "sample_1.png"]
    ds = CustomDataset(data_root=pseudo_dataset)
    for i in range(2):
        img, gt = ds[i]["img"], ds[i]["gt"]
        vis = np.clip((img - img.min()) / max(np.ptp(img), 1e-6) * 255, 0,
                      255).astype(np.uint8)
        lab = (gt.astype(np.float32) * (255.0 / max(gt.max(), 1)))
        lab = np.stack([lab] * 3, -1).astype(np.uint8)
        np.testing.assert_array_equal(
            cv2.imread(str(out / f"sample_{i}.png")),
            np.concatenate([vis[..., ::-1], lab], axis=1))


# PEANUT's PSPNet narrowed, on 3 channels and 4 classes: the JAX
# package's ``.pth`` loader reads it (ResNetV1c and PSPHead)
CM_CONFIG = """model = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNetV1c", depth=50, base_channels=8,
                  stem_channels=8, in_channels=3, strides=(1, 2, 1, 1),
                  dilations=(1, 1, 2, 4), contract_dilation=True),
    decode_head=dict(type="PSPHead", in_channels=256, in_index=3,
                     channels=16, pool_scales=(1, 2, 3, 6),
                     num_classes=4, dropout_ratio=0.1, align_corners=False),
    test_cfg=dict(mode="whole"),
)
"""


def test_confusion_matrix_equals_jax_but_at_near_ties(pseudo_dataset,
                                                     tmp_path, capsys):
    from peanut_tpu import apis as japis
    from peanut_tpu.core.checkpoint import export_encoder_decoder_to_torch
    from peanut_tpu.core.config_file import load_config as jload
    from peanut_tpu.models import build_segmentor as jbuild
    from peanut_tpu.registry import DATASETS as JDATASETS
    from peanut_tpu_torch import apis

    cfg_path = str(tmp_path / "cm_fcn.py")
    with open(cfg_path, "w") as f:
        f.write(CM_CONFIG)
    jm = jbuild(jload(cfg_path)["model"])
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 16, 16, 3)),
        train=False))
    v = randomize(v, np.random.RandomState(1), np.float32)
    pth = str(tmp_path / "w.pth")
    export_encoder_decoder_to_torch(v, pth)

    argv = ["confusion_matrix", cfg_path, pth, pseudo_dataset, "--out"]
    jtools.main(argv + [str(tmp_path / "jax.npy")])
    want_text = capsys.readouterr().out
    cm = tools.main(argv + [str(tmp_path / "port.npy")], device="cpu")
    got_text = capsys.readouterr().out
    want = np.load(tmp_path / "jax.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), cm)

    # the two packages' argmax maps, sample by sample: they may differ
    # only where JAX's two largest logits are within 1e-5
    jb = japis.init_segmentor(cfg_path, checkpoint=pth)
    tb = apis.init_segmentor(cfg_path, checkpoint=pth, device="cpu")
    ds = JDATASETS.get("CustomDataset")(data_root=pseudo_dataset)
    mine, ties = np.zeros_like(want), 0
    for i in range(len(ds)):
        s = ds[i]
        jl = japis.inference_segmentor(jb, s["img"], logits=True)
        tl = apis.inference_segmentor(tb, s["img"], logits=True)
        assert rel_err(tl, jl) <= 1e-4
        jp = np.argmax(jax.nn.sigmoid(jl), 0)
        tp = np.argmax(apis.inference_segmentor(tb, s["img"]), 0)
        top2 = np.sort(jl, axis=0)[-2:]
        near = (top2[1] - top2[0]) <= 1e-5
        assert ((jp != tp) <= near).all()
        ties += int(near.sum())
        gt = s["gt"]
        valid = (gt != ds.ignore_index) & (gt < 4)
        np.add.at(mine, (gt[valid], tp[valid]), 1)
    np.testing.assert_array_equal(cm, mine)
    if not (cm != want).any():
        assert got_text.splitlines()[-1] == want_text.splitlines()[-1]
    assert abs(cm - want).sum() <= 2 * ties
    assert cm.sum() == want.sum() == 3 * 16 * 16


def test_collect_env_imports_no_jax(tmp_path):
    code = ("import sys\n"
            "from peanut_tpu_torch.cli import tools\n"
            "tools.main(['collect_env'], device='cpu')\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'peanut_tpu' or "
            "m.startswith('peanut_tpu.')]\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    keys = [ln.split(":")[0] for ln in proc.stdout.splitlines()[:-1]]
    assert keys == ["python", "platform", "torch", "cuda", "device", "nvcc",
                    "kernel_build_dir", "numpy", "peanut_tpu_torch"]
    assert "device: cpu" in proc.stdout
