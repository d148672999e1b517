"""``cli.export`` of the port (ROADMAP A13 part 6) on the CPU: the
``torch.export`` program of a zoo segmentor's ``inference``, saved and
reloaded, is bit-equal to the eager port and within 1e-4 of the largest
logit of the JAX package's ``inference`` with the same weights (moved by
``flax_to_torch_state`` into a ``.pth``), for FCN over U-Net and a narrow
PEANUT PSPNet on 14 channels (tests/test_torch_zoo_tools_2.py holds each
kind of inference code against the eager port).  The export needs
eval-mode batch norm to trace (``BatchNorm._terms`` computes its terms
in the graph instead of keying a cache on ``data_ptr()``); the eager
path keeps its cache."""

import os

import numpy as np
import pytest
import torch

import jax

from peanut_tpu_torch import apis
from peanut_tpu_torch.cli import export
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state

from test_models import small_pspnet_config
from torch_zoo_support import (REPO, one_thread,  # noqa: F401
                               random_variables, randomize, rel_err)

UNET = os.path.join(REPO, "configs", "unet", "fcn_unet.py")


def _jax_weights_as_pth(cfg, shape, path, seed=0):
    """Seeded float32 variables of the JAX model of ``cfg`` (the model
    dict), written for the port as a ``.pth`` of its names; returns the
    JAX model and the variables."""
    from peanut_tpu.models import build_segmentor as jbuild
    jm = jbuild(cfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros(shape),
        train=False, with_aux=True), seed=seed + 1)
    v = randomize(v, np.random.RandomState(seed + 2), np.float32)
    sd = flax_to_torch_state(v, build_segmentor(cfg))
    torch.save({k: torch.as_tensor(a) for k, a in sd.items()}, path)
    return jm, v


@pytest.mark.parametrize("which", ["fcn_unet", "peanut_pspnet"])
def test_export_equals_eager_and_jax(which, tmp_path):
    from peanut_tpu.core.config_file import load_config as jload
    if which == "fcn_unet":
        config, shape = UNET, (1, 64, 64, 3)
        cfg = jload(UNET)["model"]
    else:
        cfg = small_pspnet_config(8)
        config, shape = cfg, (1, 64, 64, 14)
    pth = str(tmp_path / "w.pth")
    jm, v = _jax_weights_as_pth(cfg, shape, pth)
    out = str(tmp_path / "m.pt2")
    assert export.export_segmentor(config, out, shape, checkpoint=pth,
                                   verify=True, device="cpu") == out
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)
    program = torch.export.load(out).module()
    bundle = apis.init_segmentor(config, checkpoint=pth, device="cpu")
    with torch.no_grad():
        got = program(torch.as_tensor(x))
        eager = bundle.model.inference(torch.as_tensor(x))
    assert torch.equal(got, eager)
    want = np.asarray(jm.apply(v, x, method=jm.inference))
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) <= 1e-4


def test_export_cli(tmp_path, capsys):
    out = str(tmp_path / "unet.pt2")
    export.main([UNET, out, "--shape", "1", "32", "32", "3", "--verify"],
                device="cpu")
    assert capsys.readouterr().out.strip() == f"exported: {out}"
    assert os.path.getsize(out) > 1000


def test_batch_norm_keeps_its_eager_cache_and_traces():
    """Eager: the cached terms, computed once, bit for bit as before.
    Traced: the terms in the graph, no ``data_ptr()`` read."""
    from peanut_tpu_torch.models.layers import BN_EPS, BatchNorm
    bn = BatchNorm(4).double()
    rng = np.random.RandomState(5)
    with torch.no_grad():
        bn.running_mean.copy_(torch.as_tensor(rng.randn(4)))
        bn.running_var.copy_(torch.as_tensor(rng.rand(4) + 0.5))
        bn.weight.copy_(torch.as_tensor(rng.randn(4)))
        bn.bias.copy_(torch.as_tensor(rng.randn(4)))
    x = torch.as_tensor(rng.randn(2, 4, 3, 5))
    with torch.no_grad():
        y = bn(x)
        cached = bn.__dict__["_cached_terms"]
        assert bn(x).equal(y) and bn.__dict__["_cached_terms"] is cached
        mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        assert y.equal((x - bn.running_mean[:, None, None])
                       * mul[:, None, None] + bn.bias[:, None, None])
        program = torch.export.export(bn, (x,)).module()
        assert program(x).equal(y)
        assert "_cached_terms" not in program.__dict__
