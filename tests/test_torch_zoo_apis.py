"""The port's zoo entry points against the JAX package's, on the CPU.

* ``apis.init_segmentor`` + ``inference_segmentor`` on a shrunk UPerNet
  config dict (``SHRINK`` widths) with the JAX variables carried in (as an
  mmseg-layout ``.pth``, and as a training checkpoint directory): the
  probabilities of an HWC image and the logits of the same image as CHW
  within 1e-4 of the largest |value| of the JAX APIs' (float32 on both
  sides); an mmseg-named head in a ``.pth`` raises KeyError.
* ``cli.serve.make_handler`` on port 0 in a thread answers ``/ping``,
  ``/predictions/x`` (the argmax) and ``/probs`` (the ``.npy``) with what
  ``inference_segmentor`` returns; a bad request answers 500.
* ``cli.benchmark`` at ``--size 64 --batch 1`` prints its JSON keys.
* Without a card and without ``device``, the entry points raise,
  ``train_segmentor`` among them.
* PSAHead's masks take their shape from the first feature map, as flax's
  kernel from init, and another size raises; ``init_segmentor`` binds
  them before any request.  So it binds MAE's positional embedding and
  BEiT's relative-position tables: MAE then serves its bound size (the
  JAX package's variables carried in as a ``.pth`` answer as the JAX
  APIs do) and raises ValueError at another.
* ``cli.benchmark`` runs UPerNet-Swin-T (ADE20K) at ``--size 64``, and
  FCN-HRNet-W18 (Cityscapes) there too.
* ``init_segmentor`` + ``inference_segmentor`` serve LR-ASPP over
  MobileNetV3-large (the config as written, random weights) on the CPU:
  its 19 classes' logits equal to the model's own inference, and their
  sigmoid.
"""

import contextlib
import io
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax

from peanut_tpu.apis import SegmentorBundle as JBundle
from peanut_tpu.apis import inference_segmentor as j_inference
from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu_torch import apis
from peanut_tpu_torch.cli import benchmark, serve
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state

from torch_zoo_support import (REPO, family_config, random_variables,
                               randomize, rel_err)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

UPERNET = os.path.join(REPO, "configs/upernet/"
                       "upernet_r50_512x1024_80k_cityscapes.py")
SWIN = os.path.join(REPO, "configs/swin/upernet_swin-t_512x512_160k_ade20k.py")
HRNET = os.path.join(REPO, "configs/hrnet/fcn_hr18_512x1024_80k_cityscapes.py")
LRASPP = os.path.join(REPO, "configs/mobilenet_v3/"
                      "lraspp_m-v3_512x1024_80k_cityscapes.py")


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A shrunk UPerNet: the JAX bundle with seeded float32 variables, and
    the same weights as an mmseg-layout .pth and as a training checkpoint
    directory for the port."""
    cfg = family_config("upernet")
    jm = jbuild(cfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 64, 96, 3)),
        train=False, with_aux=True))
    v = randomize(v, np.random.RandomState(5), np.float32)
    sd = flax_to_torch_state(v, build_segmentor(cfg))
    d = tmp_path_factory.mktemp("upernet")
    pth = str(d / "upernet.pth")
    torch.save({"state_dict": {k: torch.as_tensor(a) for k, a in sd.items()},
                "meta": {"iter": 7}}, pth)
    ckpt = d / "iter_7"
    ckpt.mkdir()
    torch.save({"state_dict": {k: torch.as_tensor(a) for k, a in sd.items()},
                "meta": {"iter": 7}}, str(ckpt / "model.pth"))
    img = np.random.RandomState(6).rand(40, 72, 3).astype(np.float32) * 2
    return {"cfg": {"model": cfg}, "jax": JBundle(jm, v, {"model": cfg}),
            "pth": pth, "dir": str(ckpt), "img": img}


def test_inference_matches_the_jax_apis(carried):
    img = carried["img"]
    want_p = j_inference(carried["jax"], img)                   # HWC
    want_l = j_inference(carried["jax"], img.transpose(2, 0, 1),
                         logits=True)                           # CHW
    assert want_p.shape == want_l.shape == (19, 40, 72)
    for ckpt in (carried["pth"], carried["dir"]):
        bundle = apis.init_segmentor(carried["cfg"], checkpoint=ckpt,
                                     device="cpu")
        assert not bundle.model.training
        got_p = apis.inference_segmentor(bundle, img)
        got_l = bundle(img.transpose(2, 0, 1), logits=True)
        assert got_p.dtype == got_l.dtype == np.float32
        assert rel_err(got_p, want_p) <= 1e-4
        assert rel_err(got_l, want_l) <= 1e-4
        np.testing.assert_allclose(got_p, 1 / (1 + np.exp(-got_l)),
                                   rtol=1e-6, atol=1e-7)


def test_mmseg_names_of_a_new_head_raise(carried, tmp_path):
    sd = torch.load(carried["pth"], weights_only=False)["state_dict"]
    sd = {k.replace("decode_head.lateral0.", "decode_head.lateral_convs.0.")
          : v for k, v in sd.items()}
    path = str(tmp_path / "mmseg_upernet.pth")
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError, match="lateral_convs"):
        apis.init_segmentor(carried["cfg"], checkpoint=path, device="cpu")


@contextlib.contextmanager
def _server(bundle):
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(bundle))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        t.join()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_answers_what_inference_returns(carried):
    bundle = apis.init_segmentor(carried["cfg"], checkpoint=carried["pth"],
                                 device="cpu")
    img = carried["img"]
    want = apis.inference_segmentor(bundle, img)
    buf = io.BytesIO()
    np.save(buf, img)
    with _server(bundle) as url:
        with urllib.request.urlopen(url + "/ping", timeout=60) as r:
            assert r.status == 200
            assert json.loads(r.read()) == {"status": "Healthy"}
        code, body = _post(url + "/probs", buf.getvalue())
        assert code == 200
        probs = np.load(io.BytesIO(body))
        assert probs.dtype == np.float32
        np.testing.assert_array_equal(probs, want)
        code, body = _post(url + "/predictions/x", buf.getvalue())
        assert code == 200
        out = json.loads(body)
        assert out["shape"] == [40, 72]
        np.testing.assert_array_equal(np.asarray(out["classes"]),
                                      want.argmax(0))
        code, body = _post(url + "/probs", b"not an image")
        assert code == 500 and "error" in json.loads(body)


def test_benchmark_prints_its_keys(capsys):
    out = benchmark.main([UPERNET, "--size", "64", "--batch", "1",
                          "--warmup", "1", "--iters", "2", "--dtype",
                          "float32", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"maps_per_sec", "ms_per_batch", "batch", "size",
                         "dtype", "device"}
    assert line["batch"] == 1 and line["size"] == 64
    assert line["device"] == "cpu" and line["maps_per_sec"] > 0


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, carried):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: apis.init_segmentor(carried["cfg"]),
                 lambda: serve.main([UPERNET]),
                 lambda: benchmark.main([UPERNET, "--size", "32"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        apis.train_segmentor(UPERNET, "data", "work")


def test_psa_masks_bind_to_the_first_feature_size():
    model = build_segmentor(family_config("psanet"), seed=0)
    with torch.no_grad():
        model(torch.rand(1, 3, 64, 96))
        mask = model.decode_head.collect_attn1.weight
        assert mask.shape[0] == (2 * 8 - 1) * (2 * 12 - 1)
        with pytest.raises(ValueError, match="relative positions"):
            model(torch.rand(1, 3, 64, 64))
    # the materialised masks travel in the state dict
    again = build_segmentor(family_config("psanet"))
    again.load_state_dict(model.state_dict())
    np.testing.assert_array_equal(
        again.decode_head.collect_attn1.weight.detach().numpy(),
        mask.detach().numpy())


def test_init_segmentor_binds_psa_masks_before_serving():
    """The masks are bound at the size the bundle serves (the config's
    crop, else an ``input_size`` square), so a request never changes the
    model, and a cast of the bundle reaches them."""
    model = family_config("psanet")
    for cfg, kw, (h, w) in ((dict(model=model, crop_size=(64, 96)), {},
                             (8, 12)),
                            (model, dict(input_size=80), (10, 10))):
        bundle = apis.init_segmentor(cfg, device="cpu", **kw)
        mask = bundle.model.decode_head.distribute_attn1.weight
        assert mask.shape[0] == (2 * h - 1) * (2 * w - 1)
        assert bundle.model.to(torch.float64).decode_head \
            .distribute_attn1.weight.dtype == torch.float64


def test_mae_serves_the_size_its_weights_were_bound_at(tmp_path):
    cfg = family_config("mae")
    bundle = apis.init_segmentor(cfg, input_size=64, device="cpu")
    assert bundle.model.backbone.pos_embed.shape == (1, 16, 96)
    img = np.random.RandomState(7).rand(64, 64, 3).astype(np.float32)
    probs = apis.inference_segmentor(bundle, img)
    assert probs.shape == (19, 64, 64) and np.isfinite(probs).all()
    with pytest.raises(ValueError, match="positional embedding"):
        apis.inference_segmentor(bundle, img[:, :48])
    # the JAX package's variables, shaped by a 64x64 init, as a .pth
    jm = jbuild(cfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 64, 64, 3)),
        train=False))
    v = randomize(v, np.random.RandomState(8), np.float32)
    sd = flax_to_torch_state(v, build_segmentor(cfg))
    pth = str(tmp_path / "mae.pth")
    torch.save({"state_dict": {k: torch.as_tensor(a)
                               for k, a in sd.items()}}, pth)
    bundle = apis.init_segmentor(cfg, checkpoint=pth, device="cpu")
    want = j_inference(JBundle(jm, v, {"model": cfg}), img)
    assert rel_err(apis.inference_segmentor(bundle, img), want) <= 1e-4


def test_init_segmentor_binds_beit_tables():
    bundle = apis.init_segmentor(family_config("beit"), input_size=64,
                                 device="cpu")
    # a 4x4 patch grid: (2 * 4 - 1)^2 relative positions, 3 heads
    assert bundle.model.backbone.block0.rel_pos_bias.shape == (49, 3)
    img = np.random.RandomState(9).rand(64, 64, 3).astype(np.float32)
    assert np.isfinite(apis.inference_segmentor(bundle, img)).all()


def test_benchmark_runs_swin(capsys):
    out = benchmark.main([SWIN, "--size", "64", "--batch", "1",
                          "--device", "cpu"])
    assert out["maps_per_sec"] > 0 and out["dtype"] == "bfloat16"


def test_benchmark_runs_hrnet(capsys):
    out = benchmark.main([HRNET, "--size", "64", "--batch", "1",
                          "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and out["maps_per_sec"] > 0 and out["size"] == 64


def test_lraspp_serves_on_the_cpu():
    bundle = apis.init_segmentor(LRASPP, seed=0, device="cpu")
    img = np.random.RandomState(12).rand(48, 80, 3).astype(np.float32) * 255
    probs = apis.inference_segmentor(bundle, img)
    logits = apis.inference_segmentor(bundle, img, logits=True)
    assert probs.shape == logits.shape == (19, 48, 80)
    assert np.isfinite(probs).all() and np.ptp(logits) > 0
    with torch.no_grad():
        direct = bundle.model.inference(torch.as_tensor(img[None]))[0]
    np.testing.assert_array_equal(logits, direct.permute(2, 0, 1).numpy())
    np.testing.assert_array_equal(
        probs, torch.sigmoid(torch.as_tensor(logits)).numpy())
