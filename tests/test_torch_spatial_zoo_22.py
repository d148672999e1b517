"""The plain-ViT families' traps over the spatial axis, on the CPU:

* spatially sharded whole-map prediction of the configs written over the
  SETR config's ViT (``torch_spatial_zoo_support.WRITTEN``: SETR's naive
  head, UPerHead over MultiLevelNeck and over Feature2Pyramid, SETR's MLA
  head over MultiLevelNeck) against the JAX package's GSPMD one over the
  8 virtual CPU devices, float32, at 256 x 128 and 128^2, within 1e-4
  (tests/test_torch_spatial_zoo_21.py's bars);
* MLANeck and SETRMLAHead, which take taps of equal size (no backbone of
  the zoo makes them; MultiLevelNeck does, where the grid is even), at
  module level: row-sharded taps of 13 rows over
  ``["cpu"] * k`` for k = 1 ... 8 against the module's unsharded forward
  in float64 (within 1e-12 of the largest |value|), and the gathered
  result against the flax module on the same taps (within 1e-9, as
  tests/test_torch_zoo_transformers.py holds them unsharded);
* a fresh MAE or BEiT whose first forward is sharded binds its
  input-shaped parameter by the whole map (MAE's positional embedding by
  the grid's h * w patches, BEiT's relative-position table by its
  height), to the values an unsharded first forward binds;
* BEiT on a 64 x 128 input over 2 shards (a 4 x 8 grid: each shard
  holds 16 = 4^2 tokens): its bias joins no block, since the whole grid
  is not square, so the sharded forward equals the unsharded one and
  does not move when the table does.
"""

import copy

import numpy as np
import pytest
import torch

import jax  # noqa: F401

import peanut_tpu.models  # noqa: F401  (registers the JAX zoo)
from peanut_tpu.registry import HEADS as JHEADS, NECKS as JNECKS
from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.models import sharded
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.models.layers import InputShaped, needs_binding
from peanut_tpu_torch.models.sharded import forward_rows
from peanut_tpu_torch.registry import HEADS, NECKS

from torch_spatial_zoo_support import (SHARDS, TOL, check_against_jax, cpus,
                                       image, port_model, zoo_config)
from torch_zoo_support import carried_module, jax64, rel_err
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["setr_mla", "setr_up", "vit_f2p",
                                    "vit_mln"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family, sizes=((256, 128), (128, 128)))


# NHWC taps of equal size, 13 rows (uneven over 2 ... 8 shards)
TAPS = [np.random.RandomState(20 + i).randn(2, 13, 10, 12) for i in range(4)]


@pytest.mark.parametrize("kind,registry,kw", [
    ("MLANeck", (JNECKS, NECKS), dict(in_channels=(12,) * 4,
                                      out_channels=8)),
    ("SETRMLAHead", (JHEADS, HEADS), dict(
        in_channels=(12, 12, 12, 12), channels=8, mla_channels=4,
        up_scale=2, num_classes=5)),
    ("SETRMLAHead", (JHEADS, HEADS), dict(
        in_channels=(12, 12), channels=8, mla_channels=4, up_scale=2,
        in_index=(1, 3), align_corners=True, num_classes=5)),
], ids=["mla_neck", "setr_mla_head", "setr_mla_head_two_taps"])
def test_equal_size_taps_over_the_shards(kind, registry, kw):
    jreg, reg = registry
    jkw = {k: v for k, v in kw.items() if k != "in_channels"}
    jmod, tmod = jreg.get(kind)(**jkw), reg.build(dict(kw, type=kind))
    taps = tuple(TAPS)
    v = carried_module(jmod, tmod, taps, train=False)
    maps = [torch.as_tensor(t).permute(0, 3, 1, 2) for t in taps]
    with torch.no_grad():
        want = tmod(maps)
    want = list(want) if isinstance(want, tuple) else [want]
    jax_want = jax64(jmod, v, taps, train=False)
    jax_want = list(jax_want) if isinstance(jax_want, tuple) else [jax_want]
    ctx = sharded._Context(torch.device("cpu"), None)
    for k in SHARDS:
        with torch.no_grad():
            got = sharded.run(tmod, [spatial.shard(t, cpus(k)) for t in maps],
                              ctx)
        got = [spatial.gather(g) for g in
               (got if isinstance(got, tuple) else [got])]
        assert len(got) == len(want) == len(jax_want)
        for g, w, j in zip(got, want, jax_want):
            assert rel_err(g.numpy(), w.numpy()) <= TOL, k
            assert rel_err(g.permute(0, 2, 3, 1).numpy(), j) <= 1e-9, k


# family: the input-shaped parameter and its shape on a 64 x 128 input
# (a 4 x 8 patch grid) at the config's widths (96, three heads)
BOUND = {"mae": ("pos_embed", (1, 32, 96)),
         "beit": ("rel_pos_bias", ((2 * 4 - 1) ** 2, 3))}


@pytest.mark.parametrize("family", sorted(BOUND))
def test_a_sharded_first_forward_binds_by_the_whole_map(family):
    name, shape = BOUND[family]
    x = image((64, 128))
    models = [build_segmentor(zoo_config(family), seed=0).double()
              for _ in range(2)]
    assert all(needs_binding(m) for m in models)
    with torch.no_grad():
        got = spatial.gather(forward_rows(
            models[0], spatial.shard(x, cpus(2)), train=False))
        want = models[1](x, train=False)
    assert rel_err(got.numpy(), want.numpy()) <= TOL
    bound = [[m._parameters[name] for m in model.modules()
              if isinstance(m, InputShaped)] for model in models]
    assert len(bound[0]) == len(bound[1]) > 0
    for a, b in zip(*bound):
        assert tuple(a.shape) == tuple(b.shape) == shape
        assert torch.equal(a, b)
        assert a.device == torch.device("cpu") and a.dtype == torch.float64


def test_beit_bias_does_not_join_on_a_grid_that_is_not_square():
    _, _, model = port_model("beit", (64, 128))
    model = copy.deepcopy(model)
    x = image((64, 128))
    with torch.no_grad():
        want = model(x, train=False)
        got = spatial.gather(forward_rows(model, spatial.shard(x, cpus(2)),
                                          train=False))
        assert rel_err(got.numpy(), want.numpy()) <= TOL
        tables = [m.rel_pos_bias for m in model.modules()
                  if isinstance(m, InputShaped)]
        assert all(float(t.abs().max()) > 0 for t in tables)
        for t in tables:
            t.mul_(3.0)
        moved = spatial.gather(forward_rows(model, spatial.shard(
            x, cpus(2)), train=False))
    assert torch.equal(moved, got)
