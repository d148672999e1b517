"""The port's prediction training (losses, train-mode PSPNet, the data
pipeline, the train step, checkpoints and the runner) against the JAX
package's, on the CPU.

Tolerances:
* samples (``load_map_sample``, the native fused augment and the python
  cv2 chain) and ``PrefetchLoader`` batches: byte-equal;
* losses of the elementwise formulas: 1e-6 relative (float32 rounding of
  the same operations);
* one train step of the tiny PSPNet (base width 8, 32 x 32, batch 2,
  dropout 0 both sides) from a JAX train state carried over by
  ``flax_train_state_to_torch``: loss within 1e-5 relative, gradients
  within 1e-4 of each tensor's largest |value|, batch norms' running
  statistics within 1e-5;
* the port's Adam fed the JAX gradients against optax's update: within
  1e-4 of the learning rate;
* a 3-step loss trajectory: 1e-4 relative.
  These four run in float64 on both sides (``jax.enable_x64``): in
  float32 the gradients of this random-init 50-layer net in train mode
  are rounding-bound, not algorithm-bound -- the port's own float32
  gradients differ from its float64 ones by 6.6e-4 to 5.6e-1 of the
  largest gradient (batch norms over two pooled samples cancel in
  backward, and 16 residual blocks amplify the rest), so two float32
  implementations cannot agree to 1e-4.  In float64 they agree to ~1e-8;
  the float32 path is held by the batch-norm test below and by the
  card-against-CPU gate of chip_smoke.py;
* remat against plain, both in torch: bit-equal losses, gradients and
  running statistics (the recomputation repeats the same kernels).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from peanut_tpu.core.checkpoint import convert_encoder_decoder_state
from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu.models import losses as jlosses
from peanut_tpu.prediction import dataset as jdataset
from peanut_tpu.prediction.train import TrainConfig as JTrainConfig
from peanut_tpu.prediction.train import create_train_state as jcreate
from peanut_tpu.prediction.train import poly_schedule as jpoly
from peanut_tpu_torch.cli import train_prediction_model
from peanut_tpu_torch.core.checkpoint import (find_latest_checkpoint,
                                              load_checkpoint,
                                              save_checkpoint)
from peanut_tpu_torch.models import losses
from peanut_tpu_torch.models.layers import BatchNorm
from peanut_tpu_torch.models.mmseg_import import (flax_to_mmseg_state,
                                                  flax_train_state_to_torch)
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.prediction import dataset
from peanut_tpu_torch.prediction.runner import IterRunner
from peanut_tpu_torch.prediction.train import (TrainConfig,
                                               create_train_state,
                                               loss_and_grads,
                                               make_train_step,
                                               poly_schedule, upload_batch)
from peanut_tpu_torch.utils.loggers import read_train_log

torch.set_num_threads(1)
MAPSZ = 48
BASE = 8


def write_maps(dirpath, n_files=2, size=MAPSZ, seed=0):
    """Episodes as the verify recipe writes them: explored area and
    obstacles growing over 20 timesteps, sparse goal channels."""
    rng = np.random.RandomState(seed)
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n_files):
        seq = np.zeros((20, 14, size, size), np.uint8)
        for t in range(20):
            r = 3 + t * 2
            seq[t, 1, :r, :r] = 255
            seq[t, 0, :r:4, :r] = 255
        seq[:, 4:10] = (rng.rand(1, 6, size, size) > 0.97) * 255
        np.savez_compressed(os.path.join(dirpath, f"f{i:05d}.npz"), maps=seq)


def tiny_cfg(remat=False, dropout=0.0):
    return dict(
        type="EncoderDecoder",
        backbone=dict(type="ResNetV1c", depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), contract_dilation=True,
                      base_channels=BASE, stem_channels=BASE, in_channels=14,
                      remat=remat),
        decode_head=dict(type="PSPHead", in_channels=BASE * 32, in_index=3,
                         channels=BASE * 8, pool_scales=(1, 2, 3, 6),
                         dropout_ratio=dropout, num_classes=6,
                         align_corners=False),
        auxiliary_head=dict(type="FCNHead", in_channels=BASE * 16,
                            in_index=2, channels=BASE * 4, num_convs=1,
                            concat_input=False, dropout_ratio=dropout,
                            num_classes=6, align_corners=False),
        test_cfg=dict(mode="whole"))


def _batch(seed, b=2, size=32):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(b, size, size, 14).astype(np.float32),
            "gt": ((rng.rand(b, size, size, 6) > 0.9) * 255.0).astype(
                np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---- losses -------------------------------------------------------------

def test_bce_with_logits_and_multilabel_loss_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 7) * 4).astype(np.float32)
    x[0, 0, 0, :3] = (0.0, 30.0, -30.0)
    t = rng.rand(2, 6, 5, 7).astype(np.float32)
    pw = np.float32([1, 2, 3, 0.5, 1, 4])
    want = np.asarray(jlosses.bce_with_logits(jnp.asarray(x),
                                              jnp.asarray(t)))
    got = losses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    gt255 = (t * 255).round()
    jl = jlosses.MultiLabelBCELoss(use_pos_weight=True, pos_weights=pw,
                                   loss_weight=0.4)
    tl = losses.MultiLabelBCELoss(use_pos_weight=True, pos_weights=pw,
                                  loss_weight=0.4)
    # the JAX loss is NHWC, the port's NCHW
    want = float(jl(jnp.asarray(x.transpose(0, 2, 3, 1)),
                    jnp.asarray(gt255.transpose(0, 2, 3, 1))))
    got = float(tl(torch.from_numpy(x), torch.from_numpy(gt255)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("kw", [{}, {"class_weight": [1, 2, 3, 1, 1, 2]},
                                {"use_sigmoid": True},
                                {"reduction": "sum"}])
def test_cross_entropy_matches_jax(kw):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 7).astype(np.float32)
    y = rng.randint(0, 6, (2, 5, 7))
    y[0, 0, :2] = 255
    want = float(jlosses.CrossEntropyLoss(**kw)(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(y)))
    got = float(losses.CrossEntropyLoss(**kw)(torch.from_numpy(x),
                                              torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=1e-6)


def test_dice_and_accuracy_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 5, 7).astype(np.float32)
    y = rng.randint(0, 6, (2, 5, 7))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    xj, yj = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(y)
    assert float(losses.DiceLoss()(xt, yt)) == pytest.approx(
        float(jlosses.DiceLoss()(xj, yj)), rel=1e-6)
    for kw in ({}, {"topk": (1, 3)}, {"thresh": 0.5},
               {"ignore_index": 2}):
        want = jlosses.accuracy(xj, yj, **kw)
        got = losses.accuracy(xt, yt, **kw)
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-6)


# ---- train-mode batch norm ----------------------------------------------

def test_batchnorm_train_mode_matches_flax():
    """Batch statistics, the biased fast variance and the 0.9 momentum of
    flax's nn.BatchNorm; eval mode keeps the frozen formula."""
    from peanut_tpu.models.layers import BatchNorm as JBN

    rng = np.random.RandomState(3)
    x = (rng.randn(2, 4, 4, 5) * 3 + 1).astype(np.float32)     # NHWC
    scale = (0.5 + rng.rand(5)).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    mean0 = rng.randn(5).astype(np.float32)
    var0 = (0.5 + rng.rand(5)).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    want, mut = JBN().apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    bn = BatchNorm(5)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    assert not bn.training          # built for serving
    got = bn.train()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=1e-5)
    stats = _np(mut["batch_stats"]["bn"])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-6, atol=1e-6)


# ---- data ---------------------------------------------------------------

@pytest.fixture(scope="module")
def maps_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    write_maps(str(d / "train"))
    return str(d)


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native library compiled by this test, with its
    loader's own flags, into a private path (published by ``os.replace``)
    and the loader pointed there: its ``native/libmap_pipeline.so``, which
    every process that imports it may be compiling in place at the same
    time, is never loaded half-written.  The loader must find the
    library: a fallback to the cv2 chain fails here, not as bytes
    apart."""
    import subprocess

    from peanut_tpu.prediction import native as jnative
    lib = str(tmp_path / "libmap_pipeline.so")
    part = lib + ".part"
    subprocess.run(["cc", "-O3", "-fopenmp", "-shared", "-fPIC", "-lstdc++",
                    jnative._SRC, "-o", part], check=True,
                   capture_output=True)
    os.replace(part, lib)
    monkeypatch.setattr(jnative, "_LIB", lib)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


@pytest.mark.parametrize("native", [True, False])
def test_load_map_sample_byte_equal_to_jax(maps_dir, native, request):
    if native:
        request.getfixturevalue("jax_native")
    path = os.path.join(maps_dir, "train", "f00001.npz")
    for t in (0, 3, 9):
        want = jdataset.load_map_sample(path, t)
        got = dataset.load_map_sample(path, t, use_native=native)
        for k in ("img", "gt"):
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("native", [True, False])
def test_pipeline_samples_byte_equal_to_jax(maps_dir, native, request):
    """The fused native augment and the python cv2 chain, each against the
    JAX package's own, on one RandomState seed: the same draws in the same
    order give the same bytes."""
    if native:
        request.getfixturevalue("jax_native")
    else:
        pytest.importorskip("cv2")
    jds = jdataset.SemMapDataset(maps_dir, "train",
                                 pipeline=jdataset.training_pipeline(
                                     40, np.random.RandomState(7),
                                     use_native=native))
    ds = dataset.SemMapDataset(maps_dir, "train",
                               pipeline=dataset.training_pipeline(
                                   40, np.random.RandomState(7),
                                   use_native=native))
    assert len(ds) == len(jds) == 20
    for i in (0, 5, 13, 19, 2):
        want, got = jds[i], ds[i]
        assert got["img"].shape == (40, 40, 14)
        assert got["gt"].shape == (40, 40, 6)
        for k in ("img", "gt"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_and_python_chains_agree_on_draws(maps_dir):
    """Both routes consume the RandomState alike: after the same samples
    the generators stand at the same state."""
    pytest.importorskip("cv2")
    rngs = [np.random.RandomState(3), np.random.RandomState(3)]
    for rng, native in zip(rngs, (True, False)):
        ds = dataset.SemMapDataset(maps_dir, "train",
                                   pipeline=dataset.training_pipeline(
                                       40, rng, use_native=native))
        for i in range(3):
            ds[i]
    assert rngs[0].randint(1 << 30) == rngs[1].randint(1 << 30)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_prefetch_loader_order_and_shards_match_jax(maps_dir, shards):
    jds = jdataset.SemMapDataset(maps_dir, "train")
    ds = dataset.SemMapDataset(maps_dir, "train")
    for sid in range(shards):
        jit = iter(jdataset.PrefetchLoader(jds, 3, seed=5, num_workers=1,
                                           num_shards=shards, shard_id=sid))
        it = iter(dataset.PrefetchLoader(ds, 3, seed=5, num_workers=1,
                                         num_shards=shards, shard_id=sid))
        for _ in range(8):           # past the first epoch
            want, got = next(jit), next(it)
            for k in ("img", "gt"):
                np.testing.assert_array_equal(got[k], want[k])
        it.close()
        jit.close()
    with pytest.raises(ValueError):
        dataset.PrefetchLoader(ds, 3, num_shards=2, shard_id=2)


# ---- the train step against JAX -----------------------------------------

def _jax_loss_fn(jmodel):
    """The JAX package's train-step loss (prediction/train.py:79-88)."""
    def loss_fn(params, batch_stats, img, gt):
        (logits, aux), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, img,
            train=True, with_aux=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        target = gt.astype(jnp.float32) / 255.0
        main = jnp.mean(jlosses.bce_with_logits(logits, target))
        aux_l = jnp.mean(jlosses.bce_with_logits(aux, target))
        return main + 0.4 * aux_l, (mutated["batch_stats"], main, aux_l)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_run():
    """In float64: a JAX train state one step in (so Adam's moments are
    not zero), then three more steps: their losses, the first one's
    gradients and batch statistics, and optax's update of those
    gradients."""
    seed_model = build_segmentor(tiny_cfg(), seed=0)
    sd = {k: v.numpy().astype(np.float64)
          for k, v in seed_model.state_dict().items()}
    jmodel = jbuild(tiny_cfg())
    tcfg = JTrainConfig(lr=1e-3, max_iters=50, batch_size=2)
    with jax.enable_x64(True):
        variables = jax.tree.map(jnp.asarray,
                                 convert_encoder_decoder_state(sd))
        state, tx = jcreate(jmodel, variables, tcfg)
        grad_fn = _jax_loss_fn(jmodel)

        def step(state, batch):
            (loss, (stats, _, _)), grads = grad_fn(
                state.params, state.batch_stats,
                jnp.asarray(batch["img"], jnp.float64),
                jnp.asarray(batch["gt"], jnp.float64))
            updates, opt = tx.update(grads, state.opt_state, state.params)
            return state.replace(step=state.step + 1,
                                 params=optax.apply_updates(state.params,
                                                            updates),
                                 batch_stats=stats, opt_state=opt), loss, \
                grads, updates

        state, _, _, _ = step(state, _batch(0))
        carried = state
        losses_, first = [], None
        for i in range(3):
            state, loss, grads, updates = step(state, _batch(i + 1))
            losses_.append(float(loss))
            if first is None:
                first = dict(grads=_np(grads), updates=_np(updates),
                             stats=_np(state.batch_stats))
        adam = carried.opt_state[0]
        tree = {"step": np.asarray(carried.step),
                "params": _np(carried.params),
                "batch_stats": _np(carried.batch_stats), "mu": _np(adam.mu),
                "nu": _np(adam.nu), "count": np.asarray(adam.count)}
    assert tree["mu"]["decode_head"]["conv_seg"]["conv"]["kernel"].dtype == (
        np.float64)
    return dict(tree=tree, losses=losses_, **first)


def _double_batch(seed):
    return {k: torch.from_numpy(v.transpose(0, 3, 1, 2)).double()
            for k, v in _batch(seed).items()}


def _carried_state(jax_run, remat=False):
    tcfg = TrainConfig(lr=1e-3, max_iters=50, batch_size=2)
    state = create_train_state(build_segmentor(tiny_cfg(remat)).double(),
                               tcfg, device="cpu")
    state.step = flax_train_state_to_torch(jax_run["tree"], state.model,
                                           state.optimizer)
    return state, tcfg


def test_train_state_carried_over(jax_run):
    state, _ = _carried_state(jax_run)
    assert state.step == 1
    mu = flax_to_mmseg_state({"params": jax_run["tree"]["mu"]})
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name])
    assert all(p.requires_grad for p in state.model.parameters())


def test_train_step_matches_jax(jax_run):
    state, tcfg = _carried_state(jax_run)
    metrics = loss_and_grads(state, _double_batch(1), tcfg)
    assert float(metrics["loss"]) == pytest.approx(jax_run["losses"][0],
                                                   rel=1e-5)
    want = flax_to_mmseg_state({"params": jax_run["grads"]})
    for name, p in state.model.named_parameters():
        g, w = p.grad.numpy(), want[name]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)
    stats = flax_to_mmseg_state({"batch_stats": jax_run["stats"]})
    sd = state.model.state_dict()
    for name, w in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_adam_fed_jax_gradients_matches_optax(jax_run):
    state, tcfg = _carried_state(jax_run)
    grads = flax_to_mmseg_state({"params": jax_run["grads"]})
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    for name, p in state.model.named_parameters():
        p.grad = torch.tensor(grads[name])
    for group in state.optimizer.param_groups:
        group["lr"] = poly_schedule(tcfg)(state.step)
    state.optimizer.step()
    want = flax_to_mmseg_state({"params": jax_run["updates"]})
    lr = poly_schedule(tcfg)(1)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[name]).numpy(),
                                   want[name], rtol=0, atol=1e-4 * lr,
                                   err_msg=name)


def test_three_step_loss_trajectory_matches_jax(jax_run):
    state, tcfg = _carried_state(jax_run)
    step = make_train_step(tcfg)
    got = [float(step(state, _double_batch(i + 1))["loss"])
           for i in range(3)]
    np.testing.assert_allclose(got, jax_run["losses"], rtol=1e-4)
    assert state.step == 4


def test_poly_schedule_matches_jax():
    for cfg in (JTrainConfig(), JTrainConfig(lr=1e-3, max_iters=50)):
        mine = poly_schedule(TrainConfig(lr=cfg.lr, max_iters=cfg.max_iters))
        for s in (0, 1, 7, cfg.max_iters // 2, cfg.max_iters,
                  cfg.max_iters + 3):
            assert mine(s) == pytest.approx(float(jpoly(cfg)(s)), rel=1e-6)


# ---- remat, checkpoints, the runner -------------------------------------

def test_remat_equals_plain_and_updates_stats_once():
    plain = build_segmentor(tiny_cfg(), seed=1)
    rem = build_segmentor(tiny_cfg(remat=True), seed=1)
    tcfg = TrainConfig(lr=1e-3, max_iters=50)
    states = [create_train_state(m, tcfg, device="cpu") for m in (plain,
                                                                  rem)]
    batch = upload_batch(_batch(4), "cpu")
    out = [loss_and_grads(s, batch, tcfg) for s in states]
    assert torch.equal(out[0]["loss"], out[1]["loss"])
    for (n, a), (_, b) in zip(plain.named_parameters(),
                              rem.named_parameters()):
        assert torch.equal(a.grad, b.grad), n
    init = build_segmentor(tiny_cfg(), seed=1).state_dict()
    for (n, a), (_, b) in zip(plain.state_dict().items(),
                              rem.state_dict().items()):
        assert torch.equal(a, b), n      # one update, not two
        if n.endswith("running_mean") and n.startswith("backbone.layer"):
            assert not torch.equal(a, init[n]), n


def test_checkpoint_round_trip(tmp_path):
    tcfg = TrainConfig(lr=1e-3, max_iters=50)
    state = create_train_state(build_segmentor(tiny_cfg(), seed=2), tcfg,
                               device="cpu")
    step = make_train_step(tcfg)
    step(state, _batch(5))
    path = save_checkpoint(str(tmp_path / "iter_1"), state)
    save_checkpoint(path, state)                     # over an existing one
    assert sorted(os.listdir(tmp_path)) == ["iter_1"]
    fresh = create_train_state(build_segmentor(tiny_cfg(), seed=3), tcfg,
                               device="cpu")
    assert load_checkpoint(path, fresh) == 1 and fresh.step == 1
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    # the next steps agree: the optimizer state came back too
    a, b = step(state, _batch(6)), step(fresh, _batch(6))
    assert torch.equal(a["loss"], b["loss"])
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    # the model file is an mmseg checkpoint PredictionModel reads
    from peanut_tpu_torch.models.mmseg_import import load_mmseg_checkpoint
    sd = load_mmseg_checkpoint(os.path.join(path, "model.pth"))
    assert set(sd) == set(state.model.state_dict())


def test_runner_checkpoints_and_resumes(maps_dir, tmp_path):
    tcfg = TrainConfig(lr=1e-3, max_iters=4, batch_size=2,
                       checkpoint_interval=2, log_interval=1)

    def runner(seed):
        ds = dataset.SemMapDataset(maps_dir, "train",
                                   pipeline=dataset.training_pipeline(
                                       32, np.random.RandomState(0)))
        loader = dataset.PrefetchLoader(ds, 2, num_workers=1)
        state = create_train_state(build_segmentor(tiny_cfg(), seed=seed),
                                   tcfg, device="cpu")
        return IterRunner(make_train_step(tcfg), state, loader, tcfg,
                          str(tmp_path / "w"))

    first = runner(0)
    assert first.resumed_from is None
    first.run()
    assert sorted(os.listdir(tmp_path / "w")) == ["iter_2", "iter_4",
                                                  "train_log.jsonl"]
    second = runner(9)               # other weights: the resume replaces them
    assert second.resumed_from.endswith("iter_4")
    assert second.state.step == 4
    for (n, a), (_, b) in zip(first.state.model.state_dict().items(),
                              second.state.model.state_dict().items()):
        assert torch.equal(a, b), n
    state = second.run(6)
    assert state.step == 6
    assert find_latest_checkpoint(str(tmp_path / "w")).endswith("iter_6")
    log = read_train_log(str(tmp_path / "w" / "train_log.jsonl"))
    assert [r["iter"] for r in log] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) and "aux.loss_bce" in r for r in log)


def test_cli_refuses_what_is_not_ported(maps_dir, tmp_path):
    """``--distributed 1``, which the CLI refused until ROADMAP A14, trains
    in a process group joined before (one gloo rank here; two in
    tests/test_torch_ddp_cli.py), keeps that group, and refuses a global
    batch the world does not divide; a zoo config without an auxiliary
    head, which the step cannot train, is refused."""
    import torch.distributed as dist
    from peanut_tpu_torch.core.mesh import init_distributed

    base = ["--data_root", maps_dir, "--img_dir", "train"]
    init_distributed("gloo", device="cpu", rank=0, world_size=1,
                     init_method=f"file://{tmp_path / 'pg'}")
    try:
        from peanut_tpu_torch.core.config_file import dump_config
        tiny = str(tmp_path / "tiny.py")
        dump_config({"model": tiny_cfg()}, tiny)
        state = train_prediction_model.main(
            base + ["--distributed", "1", "--config", tiny, "--work_dir",
                    str(tmp_path / "w"), "--max_iters", "2",
                    "--batch_size", "2", "--crop_size", "32",
                    "--num_workers", "1"], device="cpu")
        assert state.step == 2 and state.ddp is not None
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert os.listdir(tmp_path / "w") == ["iter_2"]
    finally:
        dist.destroy_process_group()
    # a zoo config the step cannot train: no auxiliary head
    from peanut_tpu_torch.core.config_file import dump_config
    from torch_zoo_support import family_config
    path = os.path.join(maps_dir, "segformer.py")
    dump_config({"model": family_config("segformer")}, path)
    with pytest.raises(ValueError, match="SegFormerHead"):
        train_prediction_model.main(base + ["--config", path],
                                    device="cpu")


def test_cli_needs_a_card_unless_asked_for_the_cpu(maps_dir, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_prediction_model.main(
            ["--data_root", maps_dir, "--img_dir", "train", "--work_dir",
             str(tmp_path / "w"), "--max_iters", "1", "--crop_size", "32",
             "--num_workers", "1"])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source cc cannot compile raises, naming it: no python fallback."""
    from peanut_tpu_torch.prediction import native

    bad = tmp_path / "map_pipeline.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="map_pipeline.cc"):
        native.extract_timestep(np.zeros((2, 14, 4, 4), np.uint8), 0)
