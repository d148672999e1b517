"""The port's model zoo configs against the JAX package's, on the CPU.

* The registry's fake-component pattern (register, build, KeyError on a
  duplicate or missing name).
* ``core.config_file.load_config`` gives the JAX loader's dict for every
  file under ``configs/*/*.py``, and the same merge and ``_delete_``
  semantics.
* Every config of the twenty ResNetV1c EncoderDecoder families, the ten
  transformer families, the two cascade ones and the twelve light-CNN
  ones (all 302) builds on ``device="meta"``, and a meta forward at
  64x128 gives logits of the config's classes (the channel arithmetic of
  every module checked without memory).  The timm adapter
  (``TIMMBackbone``, ROADMAP A13 part 6, which no shipped config uses)
  builds; a timm name it does not map raises NotImplementedError listing
  the names it knows.
"""

import glob
import os

import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest)

from peanut_tpu.core.config_file import load_config as jload
from peanut_tpu_torch.core.config_file import load_config, merge_dict
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.registry import Registry

from torch_zoo_support import PORTED
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_FILES = sorted(glob.glob(os.path.join(REPO, "configs/*/*.py")))
MODELS = [p for p in ALL_FILES if os.sep + "_base_" + os.sep not in p]


def _family(path):
    return os.path.basename(os.path.dirname(path))


def _id(path):
    return os.path.relpath(path, os.path.join(REPO, "configs"))


def test_registry_fake_component_pattern():
    reg = Registry("test")

    @reg.register()
    class FakeBackbone:
        def __init__(self, width=1):
            self.width = width

    @reg.register(name="Other")
    class FakeNeck:
        pass

    reg.register("Third")(FakeNeck)
    assert reg.build({"type": "FakeBackbone", "width": 7}).width == 7
    assert isinstance(reg.build({"type": "Other"}), FakeNeck)
    assert {"FakeBackbone", "Other", "Third"} == set(reg.keys())
    assert "Other" in reg and "Missing" not in reg
    with pytest.raises(KeyError):
        reg.build({"type": "Missing"})
    with pytest.raises(KeyError):
        reg.register(name="Other")(FakeBackbone)
    with pytest.raises(TypeError):
        reg.build({"width": 1})


def test_merge_and_delete_semantics(tmp_path):
    assert merge_dict({"a": {"x": 1, "y": 2}, "b": 3},
                      {"a": {"y": 5}, "c": 7}) == \
        {"a": {"x": 1, "y": 5}, "b": 3, "c": 7}
    assert merge_dict({"m": {"h": {"type": "PSPHead", "channels": 512}}},
                      {"m": {"h": {"_delete_": True, "type": "FCNHead"}}}) \
        == {"m": {"h": {"type": "FCNHead"}}}
    (tmp_path / "base.py").write_text("x = 1\nd = dict(a=1, b=2)\n")
    (tmp_path / "child.py").write_text(
        "_base_ = 'base.py'\nd = dict(b=3)\ny = 2\n")
    path = str(tmp_path / "child.py")
    assert load_config(path) == jload(path) == \
        {"x": 1, "d": {"a": 1, "b": 3}, "y": 2}


@pytest.mark.parametrize("path", ALL_FILES, ids=_id)
def test_load_config_equals_the_jax_loader(path):
    assert load_config(path) == jload(path)


def test_the_sweep_covers_every_config():
    built = [p for p in MODELS if _family(p) in PORTED]
    assert len(MODELS) == 302 and len(built) == 302
    assert {_family(p) for p in built} == set(PORTED)


def test_an_unported_type_names_a13():
    """TIMMBackbone (the JAX package's timm_adapter) was ROADMAP A13 part
    6, the one type of the zoo the port lacked: it now builds inside
    FCN over U-Net, and a timm name without an equivalent in the zoo
    raises NotImplementedError listing the names it maps."""
    cfg = load_config(os.path.join(REPO, "configs", "unet",
                                   "fcn_unet.py"))["model"]
    cfg["backbone"] = dict(type="TIMMBackbone", model_name="resnet18")
    cfg["decode_head"].update(in_channels=512, in_index=3)
    model = build_segmentor(cfg, device="meta")
    assert list(model.backbone.out_channels) == [64, 128, 256, 512]
    with torch.no_grad():
        out = model.inference(torch.empty(1, 64, 128, 3, device="meta"))
    assert tuple(out.shape) == (1, 64, 128, 2)
    cfg["backbone"]["model_name"] = "efficientnet_b0"
    with pytest.raises(NotImplementedError,
                       match=r"available: \['mobilenetv2_100', "):
        build_segmentor(cfg, device="meta")


@pytest.mark.parametrize("path", MODELS, ids=_id)
def test_config_builds_or_names_a13(path):
    model_cfg = load_config(path)["model"]
    model = build_segmentor(model_cfg, device="meta")
    in_ch = model_cfg["backbone"].get("in_channels", 3)
    with torch.no_grad():
        out = model.inference(torch.empty(1, 64, 128, in_ch, device="meta"))
    head = model_cfg["decode_head"]
    head = head[-1] if isinstance(head, list) else head
    assert tuple(out.shape) == (1, 64, 128, head["num_classes"])
