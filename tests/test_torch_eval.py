"""The port's evaluation (``prediction/metrics.py``, ``cli/test.py``)
against the JAX package's, on the CPU.

* metrics: equal to JAX's (the same float64 numpy arithmetic);
* ``cli/test.py`` on one random-weight PSPNet-R50-v1c checkpoint and the
  same maps: equal per-class intersection and union counts at the
  threshold, per-sample BCE within 1e-5 and the report's ``bce`` within
  1e-5 (the two frameworks' CPU convolutions sum in other orders; the
  probabilities agree to ~1e-6).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest)

from peanut_tpu.cli import test as jtest
from peanut_tpu.prediction import metrics as jmetrics
from peanut_tpu_torch.cli import test as ttest
from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                             peanut_prediction_config)
from peanut_tpu_torch.prediction import metrics

from test_torch_training import write_maps

torch.set_num_threads(1)


def _labels(seed, n=4, shape=(9, 11), classes=5):
    rng = np.random.RandomState(seed)
    preds = [rng.randint(0, classes, shape) for _ in range(n)]
    labels = [rng.randint(0, classes, shape) for _ in range(n)]
    labels[0][0, :4] = 255
    labels[1][1, :2] = 0
    return preds, labels


@pytest.mark.parametrize("kw", [{}, {"reduce_zero_label": True},
                                {"label_map": {1: 3}}])
def test_intersect_and_union_matches_jax(kw):
    preds, labels = _labels(0)
    for p, l in zip(preds, labels):
        for a, b in zip(metrics.intersect_and_union(p, l, 5, **kw),
                        jmetrics.intersect_and_union(p, l, 5, **kw)):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", [("mIoU",), ("mDice",), ("mFscore",),
                                   ("mIoU", "mDice", "mFscore")])
@pytest.mark.parametrize("nan_to_num", [None, -1])
def test_eval_metrics_and_pre_eval_match_jax(which, nan_to_num):
    preds, labels = _labels(1, classes=6)
    preds[2][:] = 0                      # a class never predicted: nan
    got = metrics.eval_metrics(preds, labels, 7, metrics=which,
                               nan_to_num=nan_to_num)
    want = jmetrics.eval_metrics(preds, labels, 7, metrics=which,
                                 nan_to_num=nan_to_num)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pre = [metrics.intersect_and_union(p, l, 7)
           for p, l in zip(preds, labels)]
    got = metrics.pre_eval_to_metrics(pre, metrics=which)
    want = jmetrics.pre_eval_to_metrics(pre, metrics=which)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError):
        metrics.total_area_to_metrics(*pre[0], metrics=("mAcc",))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_gather_strided_results_matches_jax(world):
    """Rank-strided shards back into dataset order; the all-gather is
    injected (the process group is ROADMAP A14)."""
    n = 7
    full = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
    shards = [full[r::world] for r in range(world)]

    def allgather(padded):
        k = padded.shape[0]
        out = np.zeros((world,) + padded.shape, padded.dtype)
        for r in range(world):
            out[r, :len(shards[r])] = shards[r][:k]
        return out

    for r in range(world):
        got = metrics.gather_strided_results(shards[r], n, world=world,
                                             allgather=allgather)
        want = jmetrics.gather_strided_results(shards[r], n, world=world,
                                               allgather=allgather)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full)
    if world > 1:
        with pytest.raises(NotImplementedError, match="A14"):
            metrics.gather_strided_results(shards[0], n, world=world)
    with pytest.raises(ValueError):
        metrics.gather_strided_results(full[:3], n)


def test_eval_hook_runs_on_its_interval():
    calls = []
    hook = metrics.EvalHook(lambda s: calls.append(s) or {"m": len(calls)},
                            interval=2)
    assert [hook.maybe_run(i, i) for i in range(1, 6)] == [
        None, {"m": 1}, None, {"m": 2}, None]
    assert hook.history == [{"iter": 2, "m": 1}, {"iter": 4, "m": 2}]
    assert metrics.EvalHook(lambda s: {}, 0).maybe_run(4, None) is None


@pytest.fixture(scope="module")
def val_data(tmp_path_factory):
    """Two 48^2 val episodes and a random-weight PSPNet-R50-v1c at full
    width, saved as an mmseg checkpoint and as a trainer's iter_N dir."""
    root = tmp_path_factory.mktemp("eval")
    write_maps(str(root / "val"), n_files=2, size=48, seed=4)
    model = build_segmentor(peanut_prediction_config(), seed=0)
    sd = {k: v for k, v in model.state_dict().items()}
    path = str(root / "pspnet.pth")
    torch.save({"state_dict": sd}, path)
    os.makedirs(root / "iter_3")
    torch.save({"state_dict": sd, "meta": {"iter": 3}},
               str(root / "iter_3" / "model.pth"))
    return str(root), path


def test_cli_report_matches_jax(val_data, monkeypatch, capsys):
    root, path = val_data
    seen = {}

    def record(pkg, reduce):
        def wrapped(stats, thr, argmax):
            seen[pkg] = stats
            return reduce(stats, thr, argmax)
        return wrapped

    monkeypatch.setattr(jtest, "reduce_metrics",
                        record("jax", jtest.reduce_metrics))
    monkeypatch.setattr(ttest, "reduce_metrics",
                        record("torch", ttest.reduce_metrics))
    argv = ["--data_root", root, "--img_dir", "val", "--checkpoint", path,
            "--max_samples", "4", "--argmax"]
    want = jtest.main(argv)
    got = ttest.main(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    j, t = seen["jax"], seen["torch"]
    np.testing.assert_array_equal(t["inter"], j["inter"])
    np.testing.assert_array_equal(t["union"], j["union"])
    np.testing.assert_array_equal(t["pre_eval"], j["pre_eval"])
    np.testing.assert_allclose(t["bce"], j["bce"], rtol=0, atol=1e-5)
    assert got["samples"] == want["samples"] == 4
    assert got["bce"] == pytest.approx(want["bce"], abs=1e-5)
    assert got["iou_at_thr"] == want["iou_at_thr"]
    assert got["miou_at_thr"] == want["miou_at_thr"]
    assert got["argmax_mIoU"] == want["argmax_mIoU"]
    # a trainer's iter_N directory reads the same
    again = ttest.main(["--data_root", root, "--img_dir", "val",
                        "--checkpoint", os.path.join(root, "iter_3"),
                        "--max_samples", "4", "--argmax"], device="cpu")
    assert again == got


def test_cli_refuses_what_is_not_ported(val_data):
    root, path = val_data
    with pytest.raises(NotImplementedError, match="A14"):
        ttest.main(["--data_root", root, "--img_dir", "val",
                    "--checkpoint", path, "--distributed", "1"],
                   device="cpu")
    with pytest.raises(FileNotFoundError, match="pred_model_wts"):
        ttest.main(["--data_root", root, "--img_dir", "val",
                    "--checkpoint", os.path.join(root, "none.pth")],
                   device="cpu")
